// Fused short-T causal attention forward for Hopper (compiled for sm_90a).
//
// Replaces sgpt_tpu/ops/pallas/short_attention.py::_kernel, the TPU kernel of
// the SGPT bulk-encode path, and computes what it computes: per (batch row,
// head) fp32 scores q·k, an optional scale, an optional ALiBi term
// (slope_h × supplied key position), then where(mask, s, -1e9) with mask =
// causal ∧ [sliding window] ∧ key padding ∧ [same segment id], an fp32
// softmax, probabilities rounded to the input dtype, and P·V accumulated in
// fp32 and written in the input dtype. Layout stays (B, T, H·Dh): a head is a
// contiguous Dh-wide column slice, so no transposes are needed.
//
// What bounds it on this card. At the encode shape (B=64, T=300, H=12,
// Dh=64, bf16) the kernel must read q, k, v and write out: 118 MB, 0.035 ms
// at 3.35 TB/s, against ~0.009 ms of tensor-core work for the causal pairs;
// so bytes bound it, and a block must not re-read K and V more than the
// causal walk needs. The TPU kernel keeps one head's whole (T, T) fp32 score
// tile in VMEM (360 KB at T=300, more than the 227 KB of shared memory a
// block may use), so the design differs:
//   * mma_kernel<Dh> (bf16, Dh in {16, 32, 64, 128, 256}): one block of 4
//     warps per (64 query rows, head, batch row), longest rows first; each
//     warp owns 16 rows and keeps their Q fragments, scores and output in
//     mma.sync registers (mma_attention.cuh). At Dh 256 (GPT-J) the output
//     alone is 128 fp32 registers a thread, so Q's fragments stay in the
//     shared Q tile and are read at each k-step (qk_tile_smem: the same
//     products in the same order, so the same bits); the tiles take 170 KB,
//     one block an SM. 64-key K/V tiles stream
//     through a 2-stage cp.async ring, with each tile's key padding, segment
//     ids and ALiBi positions loaded into shared memory once a tile. The
//     exact softmax takes two passes, and S never leaves registers: pass 1
//     computes S = Q·Kᵀ, the mask and each row's running max m and sum l;
//     pass 2 recomputes S, rounds p = exp(s − m) / l to bf16 and
//     accumulates O = P·V in fp32. Both visit only the key tiles that hold a
//     causal, in-window pair for the block; a pruned key is masked, and pass
//     1 adds its exp(-1e9 − m) to l analytically, as softmax_row does. A row
//     left with no valid key (m == -1e9) is uniform 1/T over all T keys, as
//     in the TPU kernel and its plain reference: a block that holds one
//     (a vote after pass 1) walks every key tile in pass 2. Tiles whose
//     every pair is allowed skip the per-score mask. The output goes out
//     through shared memory as 16-byte stores.
//   * tf32_kernel<Dh> (fp32, the same head sizes): mma_kernel's blocks,
//     tile walk, vote and tile skip with fp32 tiles, every product in
//     3xTF32 (mma_tf32.cuh: each operand splits into a TF32 big and small
//     part, and three m16n8k8 TF32 products keep about 22 significand bits,
//     so the output stays within 1e-5 of the exact fp32 plain version, where
//     one TF32 product would not), and one pass with an online softmax in
//     place of two: P is not rounded (the input dtype is fp32), so the
//     final m and l are not needed before P·V. At the train shape (B=32,
//     T=300, H=12, Dh=64, fp32) q, k, v and out are 118 MB, 0.035 ms at
//     3.35 TB/s, and the causal pairs' three TF32 products ~0.026 ms at 495
//     TFLOP/s; the mma.sync instructions and the splits bound it in practice.
//   * tf32_kernel_wide (fp32 at Dh 256, GPT-J; its training path launches
//     it 1,344 times a MS MARCO step at B=4, T=300, H=16): tf32_kernel's
//     walk, vote, skip and online softmax with tiles and warps laid out for
//     256, against three walls. Registers: a warp's 16 rows × 256 output
//     columns are 128 fp32 registers a thread, so two warps share each 16
//     rows (8 warps a block): each sums half of Dh's k-steps into the rows'
//     S, the upper warp's partial reaches the lower one through shared
//     memory and comes back as S = S_lo + S_hi (mma_tf32.cuh's pair_*), and
//     each keeps half of O's columns. chip_variants.py measured this against
//     one warp to each 16 rows with all of O (k1w_a: 1.7-1.9× slower, 4
//     warps an SM) and against both warps computing S over all of Dh
//     (k1w_b: 1.24-1.27× slower). Shared memory: split big and small parts of
//     every tile would be ~400 KB, so the block keeps three unsplit tiles
//     (Q, one K, one V) and each lane splits the values it reads into the
//     parts split_own_chunks would store (the same products); with the
//     pairs' exchange buffer 218 KB, one block an SM. Latency: K of tile kt
//     + 1 copies during tile kt's softmax and P·V, V of kt + 1 during kt +
//     1's scores. At B=16, T=300,
//     H=16 q, k, v and out are 315 MB, 0.094 ms at 3.35 TB/s; the causal
//     pairs' three TF32 products ~0.07 ms at 495 TFLOP/s, those issued (the
//     visited tiles) 0.10 ms.
//   * scalar_kernel (other head sizes, or pointers not 16-byte aligned): one
//     block per (batch row, head, BQ=16 query rows) keeps a BQ × T fp32
//     score strip in shared memory (128 KB at T=2048), fills it over every
//     64-key tile, runs softmax_row over each whole row and accumulates P·V
//     with scalar fp32 FMAs. Its masking and softmax live in
//     short_attention.cuh, which the backward (short_attention_bwd.cu)
//     shares so that it recomputes the same scores and probabilities.
// mma_kernel, tf32_kernel and tf32_kernel_wide compute what scalar_kernel
// computes in another summation order: their outputs differ by fp32
// rounding (before the bf16 cast, in mma_kernel) and, in the fp32 kernels,
// by the ~2^-22 of 3xTF32.

#include "mma_attention.cuh"
#include "mma_tf32.cuh"
#include "short_attention.cuh"
#include "short_attention_mma.cuh"

namespace {

constexpr int MAX_ACC = BQ * MAX_DH / THREADS;  // scalar P·V outputs per thread

template <typename scalar_t>
__global__ void __launch_bounds__(THREADS)
scalar_kernel(const scalar_t* __restrict__ q, const scalar_t* __restrict__ k,
              const scalar_t* __restrict__ v, scalar_t* __restrict__ out, Mask mask, int T,
              int H, int Dh, int Tpad) {
  extern __shared__ float smem[];
  float* qs = smem;                // BQ x Dh query tile
  float* kv = qs + BQ * Dh;        // BK x (Dh + 1): the K tile, later the V tile
  float* s = kv + BK * (Dh + 1);   // BQ x Tpad scores, then probabilities

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int64_t row0 = (int64_t)blockIdx.z * T;  // first token of this batch row
  const int64_t HD = (int64_t)H * Dh;
  const int ld = Dh + 1;  // padded row: threads on consecutive keys hit distinct banks
  const scalar_t* qh = q + h * Dh;
  const scalar_t* kh = k + h * Dh;
  const scalar_t* vh = v + h * Dh;

  for (int e = tid; e < BQ * Dh; e += THREADS) {
    const int r = e / Dh, d = e - r * Dh;
    const int qi = q0 + r;
    qs[e] = qi < T ? to_float(qh[(row0 + qi) * HD + d]) : 0.f;
  }

  // Scores: thread -> (one key of the tile, four query rows).
  const int kk = tid % BK;
  const int rg = (tid / BK) * 4;
  for (int k0 = 0; k0 < T; k0 += BK) {
    __syncthreads();  // query tile written / previous key tile consumed
    for (int e = tid; e < BK * Dh; e += THREADS) {
      const int r = e / Dh, d = e - r * Dh;
      const int ki = k0 + r;
      kv[r * ld + d] = ki < T ? to_float(kh[(row0 + ki) * HD + d]) : 0.f;
    }
    __syncthreads();
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    const float* kr = kv + kk * ld;
    for (int d = 0; d < Dh; ++d) {
      const float kd = kr[d];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j] = fmaf(qs[(rg + j) * Dh + d], kd, acc[j]);
    }
    if (k0 + kk < T) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[(rg + j) * Tpad + k0 + kk] = acc[j];
    }
    __syncthreads();
    mask_tile(s, mask, Tpad, k0, q0, row0, h, T, tid);
  }
  __syncthreads();

  // Softmax, one warp per row; P is rounded to the input dtype before P·V,
  // as the TPU kernel casts p to v's dtype.
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < BQ; r += WARPS) {
    float* sr = s + r * Tpad;
    softmax_row(sr, 0, T, T, lane);
    for (int j = lane; j < T; j += 32) sr[j] = to_float(from_float<scalar_t>(sr[j]));
  }

  // O = P·V with fp32 accumulation: thread -> outputs tid + i·THREADS of the BQ x Dh tile.
  float acc[MAX_ACC];
#pragma unroll
  for (int i = 0; i < MAX_ACC; ++i) acc[i] = 0.f;
  const int n_out = BQ * Dh;
  for (int k0 = 0; k0 < T; k0 += BK) {
    __syncthreads();  // probabilities final / previous V tile consumed
    for (int e = tid; e < BK * Dh; e += THREADS) {
      const int r = e / Dh, d = e - r * Dh;
      const int ki = k0 + r;
      kv[r * ld + d] = ki < T ? to_float(vh[(row0 + ki) * HD + d]) : 0.f;
    }
    __syncthreads();
    const int nk = min(BK, T - k0);
#pragma unroll
    for (int i = 0; i < MAX_ACC; ++i) {
      const int e = tid + i * THREADS;
      if (e < n_out) {
        const int r = e / Dh, d = e - r * Dh;
        const float* pr = s + r * Tpad + k0;
        const float* vc = kv + d;
        float a = acc[i];
        for (int j = 0; j < nk; ++j) a = fmaf(pr[j], vc[j * ld], a);
        acc[i] = a;
      }
    }
  }

  scalar_t* oh = out + h * Dh;
#pragma unroll
  for (int i = 0; i < MAX_ACC; ++i) {
    const int e = tid + i * THREADS;
    if (e < n_out) {
      const int r = e / Dh, d = e - r * Dh;
      const int qi = q0 + r;
      if (qi < T) oh[(row0 + qi) * HD + d] = from_float<scalar_t>(acc[i]);
    }
  }
}

// bf16 K1 on the tensor cores (D = Dh in {16, 32, 64, 128, 256}); see the
// note at the top. One block per (64 query rows, head, batch row), longest rows
// first; warp w owns rows 16w .. 16w + 15 of the tile. GENERAL: ALiBi or
// segments (the encode path has neither).
template <int D, bool GENERAL>
__global__ void __launch_bounds__(MMA_THREADS, D <= 64 && !GENERAL ? 4 : 2)
mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
           bf16* __restrict__ out, const Mask mask, int T, int H) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // the Q tile, later the output staging tile
  bf16* Ks = Qs + MMA_TILE * LD;                 // two stages
  bf16* Vs = Ks + 2 * MMA_TILE * LD;             // two stages
  KeyAux* aux = reinterpret_cast<KeyAux*>(Vs + 2 * MMA_TILE * LD);  // two stages

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * MMA_TILE, h = blockIdx.y;
  const int64_t row0 = (int64_t)blockIdx.z * T;
  const int64_t HD = (int64_t)H * D;
  const bf16* qh = q + row0 * HD + h * D;
  const bf16* kh = k + row0 * HD + h * D;
  const bf16* vh = v + row0 * HD + h * D;
  const float slope = GENERAL && mask.use_alibi ? mask.slopes[h] : 0.f;
  int qi[2], segq[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    qi[r] = q0 + warp * 16 + (lane >> 2) + 8 * r;
    segq[r] = GENERAL && mask.segments != nullptr && qi[r] < T ? mask.segments[row0 + qi[r]] : 0;
  }

  // The key tiles that hold a causal, in-window pair for some row of the
  // block; every other key is masked for every row.
  const int q_last = min(q0 + MMA_TILE - 1, T - 1);
  const int kt_lo = mask.window > 0 ? max(0, q0 - mask.window + 1) / MMA_TILE : 0;
  const int kt_hi = q_last / MMA_TILE;
  // Dh 256: Q's fragments are read from the Q tile at each k-step
  constexpr bool Q_IN_SMEM = D > 128;
  const bf16* qrows = Qs + warp * 16 * LD;

  auto issue = [&](int kt, int stage, bool with_v) {
    load_tile_async<D>(Ks + stage * MMA_TILE * LD, kh, HD, kt * MMA_TILE, T);
    if (with_v) load_tile_async<D>(Vs + stage * MMA_TILE * LD, vh, HD, kt * MMA_TILE, T);
    load_aux_async<GENERAL>(aux + stage, mask, row0, kt * MMA_TILE, T);
  };
  // whether every pair of the block and tile kt is allowed (no per-score mask)
  auto all_allowed = [&](int kt, const KeyAux* a) {
    const int k0 = kt * MMA_TILE;
    const bool in_range = k0 + MMA_TILE - 1 <= q0 &&
                          (mask.window <= 0 || k0 > q0 + MMA_TILE - 1 - mask.window) &&
                          !(GENERAL && mask.segments != nullptr);
    return __all_sync(0xffffffffu, in_range & (a->km[lane] > 0) & (a->km[lane + 32] > 0));
  };

  // Pass 1: S = Q·Kᵀ, masked, and the running max m and sum l of each row.
  uint32_t qf[Q_IN_SMEM ? 1 : D / 16][4];
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  load_tile_async<D>(Qs, qh, HD, q0, T);
  issue(kt_lo, 0, false);
  cp_async_commit();
  for (int kt = kt_lo, i = 0; kt <= kt_hi; ++kt, ++i) {
    // the next tile; during the last, pass 2's first (K and V of kt_lo)
    issue(kt < kt_hi ? kt + 1 : kt_lo, (i + 1) & 1, kt == kt_hi);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // tile kt (and at i = 0 the Q tile) has landed for every thread
    const KeyAux* a = aux + (i & 1);
    float s[8][4];
    if constexpr (Q_IN_SMEM) {
      qk_tile_smem<D>(s, qrows, Ks + (i & 1) * MMA_TILE * LD, lane);
    } else {
      if (i == 0) load_a_frags<D>(qf, qrows, lane);
      qk_tile<D>(s, qf, Ks + (i & 1) * MMA_TILE * LD, lane);
    }
    const float2 mx =
        all_allowed(kt, a)
            ? k1_scores<false, GENERAL>(s, mask, slope, qi, segq, kt * MMA_TILE, a, lane)
            : k1_scores<true, GENERAL>(s, mask, slope, qi, segq, kt * MMA_TILE, a, lane);
    const float m_new[2] = {fmaxf(m[0], mx.x), fmaxf(m[1], mx.y)};
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sum[e >> 1] += __expf(s[n][e] - m_new[e >> 1]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = l[r] * expf(m[r] - m_new[r]) + quad_sum(sum[r]);
      m[r] = m_new[r];
    }
    __syncthreads();  // stage i & 1 consumed before the next iteration refills it
  }
  // Every key pass 1 did not see counts as masked, expf(-1e9 − m) each, as
  // softmax_row counts the entries it does not hold (1 for a row with no
  // valid key, else 0); the padding past T that it saw does not count.
  const int n_seen = (kt_hi + 1 - kt_lo) * MMA_TILE;
  float inv_l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += (float)(T - n_seen) * expf(NEG - m[r]);
    inv_l[r] = 1.f / l[r];
  }

  // A row with no valid key among the visited ones is uniform 1/T over all T
  // keys: a block that holds one walks every key tile in pass 2.
  const bool dead = (qi[0] < T && m[0] == NEG) || (qi[1] < T && m[1] == NEG);
  const bool walk_all = __syncthreads_or(dead);
  const int lo = walk_all ? 0 : kt_lo, hi = walk_all ? (T - 1) / MMA_TILE : kt_hi;

  // Pass 2: S again, p = bf16(exp(s − m) / l), O += P·V in fp32 (a padded
  // key's V row is zero). Its first tile is in flight in stage s0 since pass
  // 1's last iteration.
  const int s0 = (kt_hi - kt_lo + 1) & 1;
  if (lo != kt_lo) {  // a window-pruned block walks every tile: replace that tile
    cp_async_wait<0>();
    issue(lo, s0, true);
    cp_async_commit();
  }
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  for (int kt = lo, i = 0; kt <= hi; ++kt, ++i) {
    const int stage = (s0 + i) & 1;
    if (kt < hi) issue(kt + 1, stage ^ 1, true);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const KeyAux* a = aux + stage;
    float s[8][4];
    if constexpr (Q_IN_SMEM)
      qk_tile_smem<D>(s, qrows, Ks + stage * MMA_TILE * LD, lane);
    else
      qk_tile<D>(s, qf, Ks + stage * MMA_TILE * LD, lane);
    if (all_allowed(kt, a))
      k1_scores<false, GENERAL>(s, mask, slope, qi, segq, kt * MMA_TILE, a, lane);
    else
      k1_scores<true, GENERAL>(s, mask, slope, qi, segq, kt * MMA_TILE, a, lane);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = __expf(s[n][e] - m[e >> 1]) * inv_l[e >> 1];
    uint32_t pf[4][4];
    p_frags(pf, s);
    pv_tile<D>(o, pf, Vs + stage * MMA_TILE * LD, lane);
    __syncthreads();
  }

  // Epilogue: O → bf16 through the (free) Q tile, 16-byte stores of rows < T.
  stage_rows<D>(Qs + warp * 16 * LD, o, 1.f, 1.f, lane);
  __syncthreads();
  store_tile<D>(out + row0 * HD + h * D, HD, Qs, q0, T);
}

// fp32 K1 on the tensor cores in 3xTF32 (D = Dh in {16, 32, 64, 128}):
// mma_kernel's blocks, causal/window tile walk, vote and tile skip, with fp32
// tiles of row stride D + 4 and the products of mma_tf32.cuh. Three TF32
// products for each fp32 one make the tensor-core instructions the cost, so
// the walk is a single pass with an online softmax: a tile's scores are
// computed once, O and l are rescaled by exp(m_old − m_new) when a row's max
// rises, and O is divided by l at the end. mma_kernel takes two passes
// because it rounds p to bf16, which needs the final m and l; P here stays
// fp32 (the input dtype), and rescaling changes only fp32 rounding. A masked
// key contributes exp(-1e9 − m) to l and P·V, which is 0 once a row has a
// valid key (an earlier tile's weights are then rescaled by exactly 0);
// the keys the walk did not visit are added to l analytically, the padding
// past T that it did visit is taken off again; a block with a row left with
// no valid key walks the remaining tiles too, whose weights are 1 for that
// row and exactly 0 for the others, so such a row is uniform 1/T over all T
// keys, as softmax_row makes it, and the other rows keep their bits.
// Splitting an operand costs five instructions, so each K and V value is
// split once for the block, by the thread that copied it, as soon as it
// lands (split_own_chunks): the big part in place, the small part into a
// tile of its own. K streams through two stages, V through one (loaded
// during the tile's scores, waited for just before P·V); with Q that is 104
// KB at D = 64, two blocks an SM. Each warp splits its Q fragments from the
// shared Q tile at every k-step rather than holding them split in D
// registers beside S and O.
template <int D, bool GENERAL>
__global__ void __launch_bounds__(MMA_THREADS, D <= 64 ? 2 : 1)
tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, float* __restrict__ out, const Mask mask, int T,
            int H) {
  constexpr int LD = D + 4;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);  // the Q tile, later the output staging tile
  float* Ks = Qs + MMA_TILE * LD;                  // two stages (big parts once split)
  float* Vs = Ks + 2 * MMA_TILE * LD;              // one stage (big parts once split)
  float* Ksm = Vs + MMA_TILE * LD;                 // small parts of the current K tile
  float* Vsm = Ksm + MMA_TILE * LD;                // small parts of the current V tile
  KeyAux* aux = reinterpret_cast<KeyAux*>(Vsm + MMA_TILE * LD);  // two stages, with K's

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * MMA_TILE, h = blockIdx.y;
  const int64_t row0 = (int64_t)blockIdx.z * T;
  const int64_t HD = (int64_t)H * D;
  const float* qh = q + row0 * HD + h * D;
  const float* kh = k + row0 * HD + h * D;
  const float* vh = v + row0 * HD + h * D;
  const float* qrows = Qs + warp * 16 * LD;
  const float slope = GENERAL && mask.use_alibi ? mask.slopes[h] : 0.f;
  int qi[2], segq[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    qi[r] = q0 + warp * 16 + (lane >> 2) + 8 * r;
    segq[r] = GENERAL && mask.segments != nullptr && qi[r] < T ? mask.segments[row0 + qi[r]] : 0;
  }

  const int q_last = min(q0 + MMA_TILE - 1, T - 1);
  const int kt_lo = mask.window > 0 ? max(0, q0 - mask.window + 1) / MMA_TILE : 0;
  const int kt_hi = q_last / MMA_TILE;

  auto issue_k = [&](int kt, int stage) {
    load_tile_async_f32<D>(Ks + stage * MMA_TILE * LD, kh, HD, kt * MMA_TILE, T);
    load_aux_async<GENERAL>(aux + stage, mask, row0, kt * MMA_TILE, T);
  };
  auto issue_v = [&](int kt) { load_tile_async_f32<D>(Vs, vh, HD, kt * MMA_TILE, T); };
  auto all_allowed = [&](int kt, const KeyAux* a) {
    const int k0 = kt * MMA_TILE;
    const bool in_range = k0 + MMA_TILE - 1 <= q0 &&
                          (mask.window <= 0 || k0 > q0 + MMA_TILE - 1 - mask.window) &&
                          !(GENERAL && mask.segments != nullptr);
    return __all_sync(0xffffffffu, in_range & (a->km[lane] > 0) & (a->km[lane + 32] > 0));
  };

  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  // The walk, in up to three parts: the key tiles that hold a causal,
  // in-window pair for some row of the block; then, for a block with a row
  // left with no valid key, the tiles before and after them. A part's first
  // tile (K and V) goes in flight as one cp.async group; then the groups,
  // oldest first, are K of tile kt (issued an iteration ahead), V of kt
  // (issued after the previous tile's P·V) and K of kt + 1 (issued now).
  const int last = (T - 1) / MMA_TILE;
  int n_walked = (kt_hi + 1 - kt_lo) * MMA_TILE;
  load_tile_async_f32<D>(Qs, qh, HD, q0, T);  // joins the first part's first group
#pragma unroll 1
  for (int part = 0; part < 3; ++part) {
    if (part == 1) {
      const bool dead = (qi[0] < T && m[0] == NEG) || (qi[1] < T && m[1] == NEG);
      if (!__syncthreads_or(dead)) break;
      n_walked = (last + 1) * MMA_TILE;
    }
    const int lo = part == 0 ? kt_lo : part == 1 ? 0 : kt_hi + 1;
    const int hi = part == 0 ? kt_hi : part == 1 ? kt_lo - 1 : last;
    if (lo > hi) continue;
    cp_async_wait<0>();
    issue_k(lo, 0);
    issue_v(lo);
    cp_async_commit();
    for (int kt = lo, i = 0; kt <= hi; ++kt, ++i) {
      const int stage = i & 1;
      if (kt < hi) issue_k(kt + 1, stage ^ 1);
      cp_async_commit();
      if (i == 0)
        cp_async_wait<1>();
      else
        cp_async_wait<2>();
      split_own_chunks<D>(Ks + stage * MMA_TILE * LD, Ksm);
      __syncthreads();  // K of tile kt (and the first time the Q tile) landed and split
      // S = Q·Kᵀ, masked
      float s[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int d = 0; d < D / 8; ++d) {
        uint32_t ab[4], as[4];
        a_frag_3xtf32<D>(ab, as, qrows, d, lane);
        qk_step_3xtf32<D>(s, ab, as, Ks + stage * MMA_TILE * LD, Ksm, d, lane);
      }
      const KeyAux* a = aux + stage;
      const float2 mx =
          all_allowed(kt, a)
              ? k1_scores<false, GENERAL>(s, mask, slope, qi, segq, kt * MMA_TILE, a, lane)
              : k1_scores<true, GENERAL>(s, mask, slope, qi, segq, kt * MMA_TILE, a, lane);
      // the online softmax: P = exp(s − m_new); l and O rescaled to m_new
      const float m_new[2] = {fmaxf(m[0], mx.x), fmaxf(m[1], mx.y)};
      const float rescale[2] = {expf(m[0] - m_new[0]), expf(m[1] - m_new[1])};
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] = expf(s[n][e] - m_new[e >> 1]);
          sum[e >> 1] += s[n][e];
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] = l[r] * rescale[r] + quad_sum(sum[r]);
        m[r] = m_new[r];
      }
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n][e] *= rescale[e >> 1];
      cp_async_wait<1>();
      split_own_chunks<D>(Vs, Vsm);
      __syncthreads();  // V of tile kt landed and split
      pv_tile_3xtf32<D>(o, s, Vs, Vsm, lane);
      __syncthreads();  // V and the K stage consumed
      if (kt < hi) issue_v(kt + 1);
      cp_async_commit();
    }
  }
  // Every key the walk did not visit counts as masked, expf(-1e9 − m) each,
  // as softmax_row counts the entries it does not hold; the padding past T
  // that it did visit does not count.
  float inv_l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) inv_l[r] = 1.f / (l[r] + (float)(T - n_walked) * expf(NEG - m[r]));
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] *= inv_l[e >> 1];

  // Epilogue: O through the (free) Q tile, 16-byte stores of rows < T.
  stage_rows_f32<D>(Qs + warp * 16 * LD, o, lane);
  __syncthreads();
  store_tile_f32<D>(out + row0 * HD + h * D, HD, Qs, q0, T);
}

// fp32 K1 at Dh 256 (GPT-J) on the tensor cores in 3xTF32: tf32_kernel's
// blocks, three-part walk with the dead-row vote, key-tile skip, analytic
// count of unvisited keys and online softmax, with the tiles and warps laid
// out for 256 (see the note at the top). Two warps share each 16-row strip
// of the query tile: each sums half of Dh into the strip's S (pair_store /
// pair_add / pair_load: S = S_lo + S_hi, the same bits in both) and keeps
// half of O's columns in registers. Three unsplit tiles (Q, one K and one
// V; each value split where a lane reads it) and the pairs' 16 KB exchange
// buffer take 218 KB, one block an SM: K of tile kt + 1 copies during tile
// kt's softmax and P·V, V of kt + 1 during kt + 1's scores.
constexpr int K1W_THREADS = 2 * MMA_THREADS;

template <bool GENERAL>
__global__ void __launch_bounds__(K1W_THREADS, 1)
tf32_kernel_wide(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out, const Mask mask, int T,
                 int H) {
  constexpr int D = 256, LD = D + 4, HALF = D / 2, NTH = K1W_THREADS;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);  // the Q tile, later the output staging tile
  float* Ks = Qs + MMA_TILE * LD;                  // one K tile
  float* Vs = Ks + MMA_TILE * LD;                  // one V tile
  KeyAux* aux = reinterpret_cast<KeyAux*>(Vs + MMA_TILE * LD);  // two stages, with K's

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rw = warp % MMA_WARPS, upper = warp / MMA_WARPS;  // the warp's rows, half of Dh
  const int col0 = upper * HALF;
  float4* xs = reinterpret_cast<float4*>(aux + 2) + rw * 8 * 32 + lane;  // the pair's S slot
  const int q0 = (gridDim.x - 1 - blockIdx.x) * MMA_TILE, h = blockIdx.y;
  const int64_t row0 = (int64_t)blockIdx.z * T;
  const int64_t HD = (int64_t)H * D;
  const float* qh = q + row0 * HD + h * D;
  const float* kh = k + row0 * HD + h * D;
  const float* vh = v + row0 * HD + h * D;
  const float* qrows = Qs + rw * 16 * LD;
  const float slope = GENERAL && mask.use_alibi ? mask.slopes[h] : 0.f;
  int qi[2], segq[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    qi[r] = q0 + rw * 16 + (lane >> 2) + 8 * r;
    segq[r] = GENERAL && mask.segments != nullptr && qi[r] < T ? mask.segments[row0 + qi[r]] : 0;
  }

  const int q_last = min(q0 + MMA_TILE - 1, T - 1);
  const int kt_lo = mask.window > 0 ? max(0, q0 - mask.window + 1) / MMA_TILE : 0;
  const int kt_hi = q_last / MMA_TILE;

  auto issue_k = [&](int kt, int stage) {
    load_tile_async_f32<D, MMA_TILE, NTH>(Ks, kh, HD, kt * MMA_TILE, T);
    if (threadIdx.x < MMA_THREADS)
      load_aux_async<GENERAL>(aux + stage, mask, row0, kt * MMA_TILE, T);
  };
  auto issue_v = [&](int kt) {
    load_tile_async_f32<D, MMA_TILE, NTH>(Vs, vh, HD, kt * MMA_TILE, T);
  };
  auto all_allowed = [&](int kt, const KeyAux* a) {
    const int k0 = kt * MMA_TILE;
    const bool in_range = k0 + MMA_TILE - 1 <= q0 &&
                          (mask.window <= 0 || k0 > q0 + MMA_TILE - 1 - mask.window) &&
                          !(GENERAL && mask.segments != nullptr);
    return __all_sync(0xffffffffu, in_range & (a->km[lane] > 0) & (a->km[lane + 32] > 0));
  };

  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  float o[HALF / 8][4];
#pragma unroll
  for (int n = 0; n < HALF / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  // tf32_kernel's walk in up to three parts; per part the cp.async groups,
  // oldest first, are K of tile kt (with, the first time, the Q tile) and V
  // of kt, then K of kt + 1 (issued once every warp has read K of kt) and V
  // of kt + 1 (issued once every warp has read V of kt)
  const int last = (T - 1) / MMA_TILE;
  int n_walked = (kt_hi + 1 - kt_lo) * MMA_TILE;
  load_tile_async_f32<D, MMA_TILE, NTH>(Qs, qh, HD, q0, T);  // joins the first part's K group
#pragma unroll 1
  for (int part = 0; part < 3; ++part) {
    if (part == 1) {
      const bool dead = (qi[0] < T && m[0] == NEG) || (qi[1] < T && m[1] == NEG);
      if (!__syncthreads_or(dead)) break;
      n_walked = (last + 1) * MMA_TILE;
    }
    const int lo = part == 0 ? kt_lo : part == 1 ? 0 : kt_hi + 1;
    const int hi = part == 0 ? kt_hi : part == 1 ? kt_lo - 1 : last;
    if (lo > hi) continue;
    cp_async_wait<0>();
    issue_k(lo, 0);
    cp_async_commit();
    issue_v(lo);
    cp_async_commit();
#pragma unroll 1
    for (int kt = lo, i = 0; kt <= hi; ++kt, ++i) {
      const int stage = i & 1;
      cp_async_wait<1>();
      __syncthreads();  // K of tile kt (and the first time the Q tile) landed
      float s[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll 4
      for (int d = upper * (D / 16); d < (upper + 1) * (D / 16); ++d) {
        uint32_t ab[4], as[4];
        a_frag_3xtf32<D>(ab, as, qrows, d, lane);
        qk_part_3xtf32_unsplit<D, 8>(s, ab, as, Ks, d, lane);
      }
      if (upper) pair_store(s, xs);
      __syncthreads();  // every warp has read K of tile kt; the upper halves stored
      if (!upper) pair_add(s, xs);
      pair_barrier(rw);
      if (upper) pair_load(s, xs);
      if (kt < hi) issue_k(kt + 1, stage ^ 1);
      cp_async_commit();
      const KeyAux* a = aux + stage;
      const float2 mx =
          all_allowed(kt, a)
              ? k1_scores<false, GENERAL>(s, mask, slope, qi, segq, kt * MMA_TILE, a, lane)
              : k1_scores<true, GENERAL>(s, mask, slope, qi, segq, kt * MMA_TILE, a, lane);
      // the online softmax, as tf32_kernel's
      const float m_new[2] = {fmaxf(m[0], mx.x), fmaxf(m[1], mx.y)};
      const float rescale[2] = {expf(m[0] - m_new[0]), expf(m[1] - m_new[1])};
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] = expf(s[n][e] - m_new[e >> 1]);
          sum[e >> 1] += s[n][e];
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] = l[r] * rescale[r] + quad_sum(sum[r]);
        m[r] = m_new[r];
      }
#pragma unroll
      for (int n = 0; n < HALF / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n][e] *= rescale[e >> 1];
      cp_async_wait<1>();
      __syncthreads();  // V of tile kt landed
      pv_part_3xtf32_unsplit<D, 8, HALF>(o, s, Vs + col0, lane);
      __syncthreads();  // every warp has read V of tile kt
      if (kt < hi) issue_v(kt + 1);
      cp_async_commit();
    }
  }
  float inv_l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) inv_l[r] = 1.f / (l[r] + (float)(T - n_walked) * expf(NEG - m[r]));
#pragma unroll
  for (int n = 0; n < HALF / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] *= inv_l[e >> 1];

  // Epilogue: each warp's columns of O through the (free) Q tile, 16-byte
  // stores of rows < T
  stage_rows_f32<D, HALF>(Qs + rw * 16 * LD + col0, o, lane);
  __syncthreads();
  store_tile_f32<D, NTH>(out + row0 * HD + h * D, HD, Qs, q0, T);
}

template <typename scalar_t, typename KernelT>
cudaError_t launch_tiles(KernelT kernel, size_t smem, dim3 grid, cudaStream_t st,
                         const void* q, const void* k, const void* v, void* out,
                         const Mask& mask, int T, int H, int threads = MMA_THREADS) {
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, st>>>(
      static_cast<const scalar_t*>(q), static_cast<const scalar_t*>(k),
      static_cast<const scalar_t*>(v), static_cast<scalar_t*>(out), mask, T, H);
  return cudaGetLastError();
}

// K1 on the tensor cores: mma_kernel (bf16) or tf32_kernel (fp32; at Dh 256
// tf32_kernel_wide)
template <int D>
cudaError_t launch_mma(dim3 grid, cudaStream_t st, const void* q, const void* k, const void* v,
                       void* out, const Mask& mask, int T, int H, bool is_bf16) {
  const bool general = mask.use_alibi || mask.segments != nullptr;
  const size_t aux = 2 * sizeof(KeyAux);
  if (is_bf16)
    return launch_tiles<bf16>(general ? mma_kernel<D, true> : mma_kernel<D, false>,
                              mma_tiles_bytes<D>() + aux, grid, st, q, k, v, out, mask, T, H);
  if constexpr (D <= 128)
    return launch_tiles<float>(general ? tf32_kernel<D, true> : tf32_kernel<D, false>,
                               tf32_tiles_bytes<D>() + aux, grid, st, q, k, v, out, mask, T, H);
  else
    return launch_tiles<float>(general ? tf32_kernel_wide<true> : tf32_kernel_wide<false>,
                               sizeof(float) * 3 * MMA_TILE * (D + 4) + aux +
                                   sizeof(float4) * MMA_WARPS * 8 * 32,
                               grid, st, q, k, v, out, mask, T, H, K1W_THREADS);
}

// The tensor-core route: head sizes 16-256 in both dtypes, all four tensors
// 16-byte aligned.
bool mma_ok(const void* q, const void* k, const void* v, const void* out, int Dh) {
  const uintptr_t ptrs = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out;
  return (Dh == 16 || Dh == 32 || Dh == 64 || Dh == 128 || Dh == 256) && ptrs % 16 == 0;
}

}  // namespace

// C entry point, bound with ctypes. q/k/v/out: (B, T, H·Dh) contiguous, fp32
// (is_bf16 = 0) or bf16 (is_bf16 = 1). key_mask: (B, T) int32. slopes: (H,)
// fp32, read only when use_alibi. segments, kpos: (B, T) int32 or null (null
// segments: no block-diagonal mask; null kpos: ALiBi uses the key index).
// Returns the launch's cudaError_t; 0 means launched.
extern "C" int sgpt_short_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                        const int* key_mask, const float* slopes,
                                        const int* segments, const int* kpos, int B, int T,
                                        int H, int Dh, float scale, int window, int use_alibi,
                                        int is_bf16, void* stream) {
  if (B < 1 || T < 1 || H < 1 || Dh < 1 || Dh > MAX_DH || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Mask mask{key_mask, slopes, segments, kpos, scale, window, use_alibi};
  const int Tpad = (T + BK - 1) / BK * BK;
  const dim3 grid((T + BQ - 1) / BQ, H, B);
  cudaError_t err;
  if (mma_ok(q, k, v, out, Dh)) {
    const dim3 mgrid((T + MMA_TILE - 1) / MMA_TILE, H, B);
    switch (Dh) {
      case 16: return (int)launch_mma<16>(mgrid, st, q, k, v, out, mask, T, H, is_bf16);
      case 32: return (int)launch_mma<32>(mgrid, st, q, k, v, out, mask, T, H, is_bf16);
      case 64: return (int)launch_mma<64>(mgrid, st, q, k, v, out, mask, T, H, is_bf16);
      case 128: return (int)launch_mma<128>(mgrid, st, q, k, v, out, mask, T, H, is_bf16);
      default: return (int)launch_mma<256>(mgrid, st, q, k, v, out, mask, T, H, is_bf16);
    }
  }
  const size_t smem =
      sizeof(float) * ((size_t)BQ * Dh + (size_t)BK * (Dh + 1) + (size_t)BQ * Tpad);
  if (is_bf16) {
    if ((err = set_smem(scalar_kernel<bf16>, smem)) != cudaSuccess) return (int)err;
    scalar_kernel<bf16><<<grid, THREADS, smem, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<bf16*>(out), mask, T, H, Dh, Tpad);
  } else {
    if ((err = set_smem(scalar_kernel<float>, smem)) != cudaSuccess) return (int)err;
    scalar_kernel<float><<<grid, THREADS, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), mask, T, H, Dh, Tpad);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* sgpt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
