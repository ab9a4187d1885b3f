// Fused short-T causal attention backward for Hopper (compiled for sm_90a).
//
// Replaces sgpt_tpu/ops/pallas/short_attention.py::_bwd_kernel, the TPU
// backward of the fused short attention that the SGPT contrastive trainer
// runs once per layer and tower, and computes what it computes: recompute
// the scores and the fp32 softmax P as the forward does (the mask, scale,
// ALiBi and row softmax are short_attention.cuh, shared with K1), then
//   dV = Pbᵀ·g            (Pb: P rounded to the input dtype; fp32 accumulation)
//   dP = g·Vᵀ             (fp32)
//   dS = P ∘ (dP − rowsum(dP ∘ P)), re-masked to 0, times the scale
//   dQ = dS·K, dK = dSᵀ·Q (dS, Q, K in fp32), all written in the input dtype.
// Fully masked padded rows softmax to uniform 1/T; the re-mask gives them
// dS = 0, but their P still adds g/T to dV, as on the TPU.
//
// What bounds it on this card. At the train shape (B=32, T=300, H=12, Dh=64,
// fp32) it must read q, k, v, g and write dq, dk, dv: 206 MB, 0.062 ms at
// 3.35 TB/s; its five products over the causal pairs (10·Dh operations a
// pair) issued as three TF32 products each take 0.065 ms at 495 TFLOP/s, so
// the operations bind. One head's (T, T) fp32 tile is 360 KB at T=300, more
// than the 227 KB of shared memory a block may use, so the TPU's
// tile-per-head layout cannot carry over; dQ reduces along rows of P while
// dK and dV reduce along its columns, and blocks share nothing. The design
// is deterministic, with no atomics, in two passes, and comes in two forms:
//   * fp32 at Dh in {16, 32, 64, 128} with 16-byte-aligned tensors (the
//     train slice): tf32_rows, then tf32_cols, every product in 3xTF32 on
//     mma.sync.m16n8k8 (mma_tf32.cuh: each operand splits into a TF32 big
//     and small part, three products keep ~22 significand bits, each 8-deep
//     step summed into a fresh accumulator), with K1's tensor-core blocks
//     and masking (short_attention_mma.cuh: KeyAux, k1_scores), so that the
//     backward masks as the forward does.
//     - tf32_rows, one block of 4 warps per (64 query rows, head, batch row),
//       longest rows first, each warp 16 rows; it walks the key tiles that
//       hold a causal, in-window pair for the block twice. Walk 1: S = Q·Kᵀ
//       and dP = g·Vᵀ (Q and g as A), the row max m, sum l and Σ exp(s −
//       m)·dP online (rescaled as l is); each unvisited key enters l as
//       exp(-1e9 − m), 1 for a row with no valid key, whose l is then T;
//       D = that sum / l. Walk 2: S and dP again, P = exp(s − m)·(1/l), dS =
//       P∘(dP − D), re-masked (a masked score is -1e9 exactly) and scaled,
//       and dQ += dS·K with dS's accumulator registers as the A fragment in
//       the permuted key order of pv_tile_3xtf32. It writes m, l and D.
//     - tf32_cols, one block of 4 warps per (64 keys, head, batch row),
//       each warp 16 keys: Sᵀ = K·Qᵀ and dPᵀ = V·gᵀ with K and V as A (the
//       three products in the rows pass's term order, so that both passes
//       add the same numbers into a score), P rebuilt from m and 1/l,
//       dV += Pᵀ·g and dK += dSᵀ·Q with g and Q as B. It visits the query
//       tiles that reach its keys and every tile with a fully masked row:
//       such a row is uniform 1/T over all T keys, so its g/T reaches dV of
//       every key, past its causal range and on padded keys too (its dS is
//       0). In the query tower of MS MARCO training, every padded row from
//       the query's length + 255 on is such a row in the window-256 layers.
//     Budget (Dh=64): K, V, Q and g tiles of 64 rows at a row stride of Dh +
//     4 floats (conflict-free fragment loads), the split operands' small
//     parts beside their big ones: six tiles and the mask inputs, 104-106
//     KB a block, two blocks an SM. A pass's A operands (Q and g, K and V)
//     stay raw in shared memory and each warp splits its fragments at each
//     k-step; B operands are split once a block, by the thread that copied
//     them. Each pass takes its 64-wide tile in two halves of 32, which keeps
//     S and dP (Sᵀ and dPᵀ) at 32 registers beside dQ (dK and dV): 64 keys
//     at once spilled the cols pass. 1/l is taken once a row, not a division
//     a score. Registers and spills of each variant: build.log.
//   * fp32 at Dh 256 (GPT-J; its MS MARCO step launches it 672 times at B=4,
//     T=300, H=16) with 16-byte-aligned tensors: tf32_rows_wide, then
//     tf32_cols_wide, the same masks, walks and statistics with tiles and
//     warps laid out for 256. A warp's 16 rows × 256 columns are 128 fp32
//     registers a thread (dQ; dK and dV together 256), and split big and
//     small parts of every tile would be ~400 KB. So every tile stays
//     unsplit (row stride 260), each lane splitting the values it reads
//     into the parts split_own_chunks would store, and in both passes two
//     warps share each 16 rows (keys): each sums half of Dh's k-steps into
//     their S and dP (Sᵀ and dPᵀ), the upper warp's partials reach the
//     lower one through shared memory and come back as S_lo + S_hi
//     (mma_tf32.cuh's pair_*; the cols pass adds the same partials in the
//     same order, so both passes see the same P), and each keeps half of
//     the gradient's columns. 8 warps a block, 209 KB, one block an SM.
//     chip_variants.py measured this against the first tree of this form:
//     a rows pass of 4 warps holding all of dQ and a cols pass whose two
//     warps both compute the scores over all of Dh (K4b's way): 1.38× and
//     1.37× slower at B=32 and 4; `k2w_dup` keeps the latter.
//     - tf32_rows_wide: 64 query rows a block, Q's and g's A fragments read
//       from their shared tiles at each k-step; the keys stream through a
//       two-stage ring of WIDE_KC = 16 (one barrier a stage), twice: walk 1
//       takes m, l and D online 16 keys at a time, walk 2 dQ. It visits
//       only the keys before T (rounded up to 16) of the tiles it would
//       visit; the others enter l by count.
//     - tf32_cols_wide: 64 keys a block; the query tiles it visits
//       (tf32_cols's rule) stream through a two-stage ring of WIDE_QC = 16
//       rows before T.
//     Bound at the MS MARCO launch shape's B=32: 7 tensors of 157 MB, 0.33
//     ms of bytes, and 3 × 10·Dh TF32 operations a pair, 0.35 ms; issued,
//     the rows pass's two walks make it 18·Dh a pair.
//   * bf16, other head sizes, or tensors off 16-byte alignment: rows_kernel
//     and cols_kernel, fp32 on the CUDA cores (the mask, scale, ALiBi and
//     row softmax of short_attention.cuh).
//     - rows_kernel, one block per (batch row, head, BQ=16 query rows): the
//       score strip and softmax over the key tiles the 16 rows can reach
//       (causal, window; the rest of each row is masked and enters the
//       softmax sum by count), then D = rowsum(dP∘P) in one sweep over
//       those V tiles and dS in a second (dP is recomputed, not kept: a
//       second BQ x T strip would not fit at T=2048), then dQ = dS·K.
//     - cols_kernel, one block per (batch row, head, BKB=16 keys): walks
//       the query tiles, rebuilds P = expf(s − m) / l — the expression the
//       row softmax evaluates, on scores summed in the same order, so both
//       passes see the same P bit for bit — and accumulates dV and dK. A
//       query tile none of whose rows can reach the key strip is skipped
//       unless one of its rows is fully masked, since that row's P is not 0.
//     Head rows are zero-padded to Dhp, a multiple of 4, in shared memory,
//     so every inner product reads 128-bit vectors.
// Both forms keep each row's max m, sum l and D between the passes: 3·B·H·T
// floats (1.4 MB at B=32, T=300, H=12). wgmma, TMA and a fused single pass
// are later work.

#include "mma_attention.cuh"
#include "mma_tf32.cuh"
#include "short_attention.cuh"
#include "short_attention_mma.cuh"

namespace {

constexpr int MAX_T = 2048;  // the wrappers' bound on T (ops/short_attention.py)
constexpr int BKB = 16;  // keys per cols_kernel block
constexpr int BQB = 32;  // query rows per cols_kernel tile
constexpr int LDT = BQB + 4;  // row stride of the transposed P / dS tiles
constexpr int ACC_A = BQ * MAX_DH / (4 * THREADS);   // dQ float4 units per thread
constexpr int ACC_B = BKB * MAX_DH / (4 * THREADS);  // dK (and dV) float4 units per thread
static_assert(BK == 64 && THREADS == 4 * BK && BQ == 16, "thread -> (key, 4 rows) mapping");
static_assert(2 * THREADS == BKB * BQB, "thread -> (key, 2 rows) mapping");

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ void axpy4(float a, float4 b, float4& acc) {
  acc.x = fmaf(a, b.x, acc.x);
  acc.y = fmaf(a, b.y, acc.y);
  acc.z = fmaf(a, b.z, acc.z);
  acc.w = fmaf(a, b.w, acc.w);
}

// Up to 4 consecutive values from global memory (4 past the end are zero):
// one 16-byte (fp32) or 8-byte (bf16) load when `vec` says every row start
// is aligned to it, else one by one.
__device__ __forceinline__ float4 load4(const float* p, int n, bool vec) {
  if (vec && n >= 4) return *reinterpret_cast<const float4*>(p);
  return make_float4(n > 0 ? p[0] : 0.f, n > 1 ? p[1] : 0.f, n > 2 ? p[2] : 0.f,
                     n > 3 ? p[3] : 0.f);
}
__device__ __forceinline__ float4 load4(const bf16* p, int n, bool vec) {
  if (vec && n >= 4) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    return make_float4(a.x, a.y, b.x, b.y);
  }
  return make_float4(n > 0 ? to_float(p[0]) : 0.f, n > 1 ? to_float(p[1]) : 0.f,
                     n > 2 ? to_float(p[2]) : 0.f, n > 3 ? to_float(p[3]) : 0.f);
}

// rows [r0, r0 + n) of one head (Dh values each, row stride HD in global
// memory) → fp32 shared tile of Dhp columns with row stride ld, 4 columns a
// thread; columns past Dh and rows at or past T are zero.
template <typename scalar_t>
__device__ __forceinline__ void load_f32(float* dst, const scalar_t* src, int64_t row0,
                                         int64_t HD, int r0, int n, int T, int Dh, int Dhp,
                                         int ld, bool vec, int tid) {
  const int upr = Dhp / 4;
  for (int e = tid; e < n * upr; e += THREADS) {
    const int r = e / upr, d = (e - r * upr) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < T) val = load4(src + (row0 + r0 + r) * HD + d, Dh - d, vec);
    *reinterpret_cast<float4*>(dst + r * ld + d) = val;
  }
}

// acc[j] = Σ_d a[(rg + j)·lda + d] · b[d] over d = 0..Dhp in order, j < 4.
__device__ __forceinline__ void dot_rows4(const float* a, int lda, int rg, const float* b,
                                          int Dhp, float acc[4]) {
  for (int d = 0; d < Dhp; d += 4) {
    const float4 bv = ld4(b + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[j] = dot4(ld4(a + (rg + j) * lda + d), bv, acc[j]);
  }
}

template <typename scalar_t>
__global__ void __launch_bounds__(THREADS)
rows_kernel(const scalar_t* __restrict__ q, const scalar_t* __restrict__ k,
            const scalar_t* __restrict__ v, const scalar_t* __restrict__ g,
            scalar_t* __restrict__ dq, float* __restrict__ stats, Mask mask, int T, int H,
            int Dh, int Dhp, int Tpad, int64_t n_rows, bool vec) {
  extern __shared__ __align__(16) float smem[];
  const int ldk = Dhp + 4;         // K/V tile rows: 16-byte aligned, staggered banks
  float* qg = smem;                // BQ x Dhp: the query strip, later the g strip
  float* kv = qg + BQ * Dhp;       // BK x ldk: a K or V tile
  float* s = kv + BK * ldk;        // BQ x Tpad: scores, then P, then dS
  __shared__ float red[BQ * BK];   // per-thread partial sums of D
  __shared__ float row_m[BQ], row_l[BQ], row_d[BQ];

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int64_t row0 = (int64_t)blockIdx.z * T;
  const int64_t HD = (int64_t)H * Dh;
  const scalar_t* kh = k + h * Dh;
  const scalar_t* vh = v + h * Dh;
  // the key tiles any of the 16 rows can reach; every other key is masked
  const int lo = mask.window > 0 ? max(0, q0 - mask.window + 1) : 0;
  const int kbeg = lo / BK * BK;
  const int kend = min(T, q0 + BQ);
  const int jend = min(T, (kend + BK - 1) / BK * BK);

  // 1. Scores over the reachable tiles, masked, and the row softmax.
  //    Thread -> (one key of the tile, four query rows).
  const int kk = tid % BK;
  const int rg = (tid / BK) * 4;
  load_f32(qg, q + h * Dh, row0, HD, q0, BQ, T, Dh, Dhp, Dhp, vec, tid);
  for (int k0 = kbeg; k0 < kend; k0 += BK) {
    __syncthreads();  // query strip written / previous key tile consumed
    load_f32(kv, kh, row0, HD, k0, BK, T, Dh, Dhp, ldk, vec, tid);
    __syncthreads();
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    dot_rows4(qg, Dhp, rg, kv + kk * ldk, Dhp, acc);
    if (k0 + kk < T) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[(rg + j) * Tpad + k0 + kk] = acc[j];
    }
    __syncthreads();
    mask_tile(s, mask, Tpad, k0, q0, row0, h, T, tid);
  }
  __syncthreads();
  for (int r = warp; r < BQ; r += WARPS) {
    const float2 ml = softmax_row(s + r * Tpad, kbeg, jend, T, lane);
    if (lane == 0) {
      row_m[r] = ml.x;
      row_l[r] = ml.y;
    }
  }
  __syncthreads();  // P final; the query strip is no longer needed

  // 2. D = rowsum(dP ∘ P), dP = g·Vᵀ tile by tile; partials reduced in a
  //    fixed order. Keys outside the reachable tiles have P = 0 or belong to
  //    a fully masked row, whose D no dS reads.
  load_f32(qg, g + h * Dh, row0, HD, q0, BQ, T, Dh, Dhp, Dhp, vec, tid);
  float dpart[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k0 = kbeg; k0 < kend; k0 += BK) {
    __syncthreads();
    load_f32(kv, vh, row0, HD, k0, BK, T, Dh, Dhp, ldk, vec, tid);
    __syncthreads();
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    dot_rows4(qg, Dhp, rg, kv + kk * ldk, Dhp, acc);
    if (k0 + kk < T) {
#pragma unroll
      for (int j = 0; j < 4; ++j) dpart[j] = fmaf(acc[j], s[(rg + j) * Tpad + k0 + kk], dpart[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) red[(rg + j) * BK + kk] = dpart[j];
  __syncthreads();
  for (int r = warp; r < BQ; r += WARPS) {
    float x = red[r * BK + lane] + red[r * BK + lane + 32];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    if (lane == 0) row_d[r] = x;
  }
  __syncthreads();
  if (tid < BQ && q0 + tid < T) {
    const int64_t i = ((int64_t)blockIdx.z * H + h) * T + q0 + tid;
    stats[i] = row_m[tid];
    stats[n_rows + i] = row_l[tid];
    stats[2 * n_rows + i] = row_d[tid];
  }

  // 3. dS = P ∘ (dP − D), re-masked, scaled, written over P (same thread,
  //    same entry); 0 for the tile's keys past T, which step 4 reads.
  for (int k0 = kbeg; k0 < kend; k0 += BK) {
    __syncthreads();
    load_f32(kv, vh, row0, HD, k0, BK, T, Dh, Dhp, ldk, vec, tid);
    __syncthreads();
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    dot_rows4(qg, Dhp, rg, kv + kk * ldk, Dhp, acc);
    const int ki = k0 + kk;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = rg + j;
      float* sp = s + r * Tpad + ki;
      float ds = 0.f;
      if (ki < T && allowed(mask, row0, q0 + r, ki, T)) {
        ds = *sp * (acc[j] - row_d[r]);
        if (mask.scale != 1.f) ds *= mask.scale;
      }
      *sp = ds;
    }
  }

  // 4. dQ = dS·K with fp32 accumulation: thread -> float4 units
  //    tid + i·THREADS of the BQ x Dhp tile, keys in order.
  const int units = BQ * Dhp / 4, upr = Dhp / 4;
  float4 acc[ACC_A];
#pragma unroll
  for (int i = 0; i < ACC_A; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k0 = kbeg; k0 < kend; k0 += BK) {
    __syncthreads();  // dS final / previous K tile consumed
    load_f32(kv, kh, row0, HD, k0, BK, T, Dh, Dhp, ldk, vec, tid);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < ACC_A; ++i) {
      const int u = tid + i * THREADS;
      if (u < units) {
        const int r = u / upr, d = (u - r * upr) * 4;
        const float* sr = s + r * Tpad + k0;
        float4 a = acc[i];
        for (int j = 0; j < BK; j += 4) {
          const float4 s4 = ld4(sr + j);
          axpy4(s4.x, ld4(kv + j * ldk + d), a);
          axpy4(s4.y, ld4(kv + (j + 1) * ldk + d), a);
          axpy4(s4.z, ld4(kv + (j + 2) * ldk + d), a);
          axpy4(s4.w, ld4(kv + (j + 3) * ldk + d), a);
        }
        acc[i] = a;
      }
    }
  }
  scalar_t* dqh = dq + h * Dh;
#pragma unroll
  for (int i = 0; i < ACC_A; ++i) {
    const int u = tid + i * THREADS;
    if (u < units) {
      const int r = u / upr, d = (u - r * upr) * 4;
      if (q0 + r < T) {
        const float o[4] = {acc[i].x, acc[i].y, acc[i].z, acc[i].w};
        for (int c = 0; c < 4 && d + c < Dh; ++c)
          dqh[(row0 + q0 + r) * HD + d + c] = from_float<scalar_t>(o[c]);
      }
    }
  }
}

template <typename scalar_t>
__global__ void __launch_bounds__(THREADS)
cols_kernel(const scalar_t* __restrict__ q, const scalar_t* __restrict__ k,
            const scalar_t* __restrict__ v, const scalar_t* __restrict__ g,
            scalar_t* __restrict__ dk, scalar_t* __restrict__ dv,
            const float* __restrict__ stats, Mask mask, int T, int H, int Dh, int Dhp,
            int64_t n_rows, bool vec) {
  extern __shared__ __align__(16) float smem[];
  const int ldk = Dhp + 4;         // key rows: 16-byte aligned, staggered banks
  float* ks = smem;                // BKB x ldk: this block's keys
  float* vs = ks + BKB * ldk;      // BKB x ldk: their values
  float* qt = vs + BKB * ldk;      // BQB x Dhp: a query tile
  float* gt = qt + BQB * Dhp;      // BQB x Dhp: its output gradients
  float* pt = gt + BQB * Dhp;      // BKB x LDT: P rounded to the input dtype, transposed
  float* dst = pt + BKB * LDT;     // BKB x LDT: dS, transposed
  __shared__ float tm[BQB], tl[BQB], td[BQB];

  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * BKB;
  const int h = blockIdx.y;
  const int64_t row0 = (int64_t)blockIdx.z * T;
  const int64_t HD = (int64_t)H * Dh;
  const int64_t srow = ((int64_t)blockIdx.z * H + h) * T;
  const int kmax = min(k0 + BKB, T) - 1;
  const scalar_t* qh = q + h * Dh;
  const scalar_t* gh = g + h * Dh;

  load_f32(ks, k + h * Dh, row0, HD, k0, BKB, T, Dh, Dhp, ldk, vec, tid);
  load_f32(vs, v + h * Dh, row0, HD, k0, BKB, T, Dh, Dhp, ldk, vec, tid);
  const int units = BKB * Dhp / 4, upr = Dhp / 4;
  float4 adk[ACC_B], adv[ACC_B];
#pragma unroll
  for (int i = 0; i < ACC_B; ++i) adk[i] = adv[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  // scores: thread -> (key c, query rows r and r + BQB/2)
  const int c = tid % BKB, r1 = tid / BKB, r2 = r1 + BQB / 2;

  for (int q0 = 0; q0 < T; q0 += BQB) {
    __syncthreads();  // the previous tile is consumed
    bool need = false;
    if (tid < BQB && q0 + tid < T) {
      const int qi = q0 + tid;
      const float m = stats[srow + qi];
      tm[tid] = m;
      tl[tid] = stats[n_rows + srow + qi];
      td[tid] = stats[2 * n_rows + srow + qi];
      const bool reach = qi >= k0 && (mask.window <= 0 || qi - mask.window < kmax);
      need = reach || m <= 0.5f * NEG;  // a fully masked row is uniform over every key
    }
    if (!__syncthreads_or(need)) continue;  // P = 0 on the whole tile: nothing to add
    load_f32(qt, qh, row0, HD, q0, BQB, T, Dh, Dhp, Dhp, vec, tid);
    load_f32(gt, gh, row0, HD, q0, BQB, T, Dh, Dhp, Dhp, vec, tid);
    __syncthreads();
    {
      float sc[2] = {0.f, 0.f}, dp[2] = {0.f, 0.f};
      const float* kr = ks + c * ldk;
      const float* vr = vs + c * ldk;
      for (int d = 0; d < Dhp; d += 4) {
        const float4 k4 = ld4(kr + d), v4 = ld4(vr + d);
        sc[0] = dot4(ld4(qt + r1 * Dhp + d), k4, sc[0]);
        sc[1] = dot4(ld4(qt + r2 * Dhp + d), k4, sc[1]);
        dp[0] = dot4(ld4(gt + r1 * Dhp + d), v4, dp[0]);
        dp[1] = dot4(ld4(gt + r2 * Dhp + d), v4, dp[1]);
      }
      const int ki = k0 + c;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int r = j ? r2 : r1, qi = q0 + r;
        float p = 0.f, ds = 0.f;
        if (qi < T && ki < T) {
          p = expf(masked_score(mask, sc[j], row0, h, qi, ki, T) - tm[r]) / tl[r];
          if (allowed(mask, row0, qi, ki, T)) {
            ds = p * (dp[j] - td[r]);
            if (mask.scale != 1.f) ds *= mask.scale;
          }
        }
        pt[c * LDT + r] = to_float(from_float<scalar_t>(p));
        dst[c * LDT + r] = ds;
      }
    }
    __syncthreads();
    // thread -> float4 units tid + i·THREADS of the BKB x Dhp dK and dV tiles
#pragma unroll
    for (int i = 0; i < ACC_B; ++i) {
      const int u = tid + i * THREADS;
      if (u < units) {
        const int cc = u / upr, d = (u - cc * upr) * 4;
        float4 ak = adk[i], av = adv[i];
        for (int r = 0; r < BQB; r += 4) {
          const float4 p4 = ld4(pt + cc * LDT + r), s4 = ld4(dst + cc * LDT + r);
          const float pr[4] = {p4.x, p4.y, p4.z, p4.w}, sr[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            axpy4(pr[j], ld4(gt + (r + j) * Dhp + d), av);
            axpy4(sr[j], ld4(qt + (r + j) * Dhp + d), ak);
          }
        }
        adk[i] = ak;
        adv[i] = av;
      }
    }
  }

  scalar_t* dkh = dk + h * Dh;
  scalar_t* dvh = dv + h * Dh;
#pragma unroll
  for (int i = 0; i < ACC_B; ++i) {
    const int u = tid + i * THREADS;
    if (u < units) {
      const int cc = u / upr, d = (u - cc * upr) * 4;
      if (k0 + cc < T) {
        const float ok[4] = {adk[i].x, adk[i].y, adk[i].z, adk[i].w};
        const float ov[4] = {adv[i].x, adv[i].y, adv[i].z, adv[i].w};
        for (int e = 0; e < 4 && d + e < Dh; ++e) {
          dkh[(row0 + k0 + cc) * HD + d + e] = from_float<scalar_t>(ok[e]);
          dvh[(row0 + k0 + cc) * HD + d + e] = from_float<scalar_t>(ov[e]);
        }
      }
    }
  }
}

// fp32 K2 on the tensor cores, rows pass (D = Dh in {16, 32, 64, 128}); see
// the note at the top. One block of 4 warps per (64 query rows, head, batch
// row), longest rows first; warp w owns rows 16w .. 16w + 15. Walks the key
// tiles that hold a causal, in-window pair for the block twice: walk 1 takes
// each row's m, l and D online, walk 2 forms dS and accumulates dQ = dS·K.
template <int D, bool GENERAL>
__global__ void __launch_bounds__(MMA_THREADS, D <= 64 ? 2 : 1)
tf32_rows(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
          const float* __restrict__ g, float* __restrict__ dq, float* __restrict__ stats,
          const Mask mask, int T, int H) {
  constexpr int LD = D + 4;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);  // the Q tile, later dQ's staging tile
  float* Gs = Qs + MMA_TILE * LD;                  // the output gradient's tile
  float* Kb = Gs + MMA_TILE * LD;                  // a K tile (big parts once split)
  float* Ksm = Kb + MMA_TILE * LD;                 // its small parts
  float* Vb = Ksm + MMA_TILE * LD;                 // a V tile (big parts once split)
  float* Vsm = Vb + MMA_TILE * LD;                 // its small parts
  KeyAux* aux = reinterpret_cast<KeyAux*>(Vsm + MMA_TILE * LD);  // with K's tile

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * MMA_TILE, h = blockIdx.y;
  const int64_t row0 = (int64_t)blockIdx.z * T;
  const int64_t HD = (int64_t)H * D;
  const int64_t n_rows = (int64_t)gridDim.z * H * T;
  const float* kh = k + row0 * HD + h * D;
  const float* vh = v + row0 * HD + h * D;
  const float* qrows = Qs + warp * 16 * LD;
  const float* grows = Gs + warp * 16 * LD;
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

  auto issue_k = [&](int kt) {
    load_tile_async_f32<D>(Kb, kh, HD, kt * MMA_TILE, T);
    load_aux_async<GENERAL>(aux, mask, row0, kt * MMA_TILE, T);
  };
  auto issue_v = [&](int kt) { load_tile_async_f32<D>(Vb, vh, HD, kt * MMA_TILE, T); };
  auto all_allowed = [&](int kt) {
    const int k0 = kt * MMA_TILE;
    const bool in_range = k0 + MMA_TILE - 1 <= q0 &&
                          (mask.window <= 0 || k0 > q0 + MMA_TILE - 1 - mask.window) &&
                          !(GENERAL && mask.segments != nullptr);
    return __all_sync(0xffffffffu, in_range & (aux->km[lane] > 0) & (aux->km[lane + 32] > 0));
  };

  // each row's max m, sum l and dd: Σ exp(s − m)·dP, then D = dd / l
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f}, dd[2] = {0.f, 0.f};
  float inv_l[2];
  float o[D / 8][4];  // dQ
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  load_tile_async_f32<D>(Qs, q + row0 * HD + h * D, HD, q0, T);  // join walk 1's first group
  load_tile_async_f32<D>(Gs, g + row0 * HD + h * D, HD, q0, T);
#pragma unroll 1
  for (int walk = 0; walk < 2; ++walk) {
    issue_v(kt_lo);  // one cp.async group a tile: V, K and K's mask inputs
    issue_k(kt_lo);
    cp_async_commit();
    for (int kt = kt_lo; kt <= kt_hi; ++kt) {
      cp_async_wait<0>();
      split_own_chunks<D>(Vb, Vsm);
      split_own_chunks<D>(Kb, Ksm);
      __syncthreads();  // V and K of tile kt (the first time also Q and g) landed and split
      const int k0 = kt * MMA_TILE;
      const bool unmasked = all_allowed(kt);
      // the tile's 64 keys in two halves of 32, to keep S and dP at 32
      // registers beside dQ
#pragma unroll 1
      for (int half = 0; half < 2; ++half) {
        const int at = 32 * half;  // the half's first key in the tile
        float dp[4][4], s[4][4];  // dP = g·Vᵀ, S = Q·Kᵀ
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) dp[n][e] = s[n][e] = 0.f;
#pragma unroll
        for (int d = 0; d < D / 8; ++d) {
          uint32_t ab[4], as[4];
          a_frag_3xtf32<D>(ab, as, grows, d, lane);
          qk_part_3xtf32<D, 4>(dp, ab, as, Vb + at * LD, Vsm + at * LD, d, lane);
          a_frag_3xtf32<D>(ab, as, qrows, d, lane);
          qk_part_3xtf32<D, 4>(s, ab, as, Kb + at * LD, Ksm + at * LD, d, lane);
        }
        const float2 mx =
            unmasked
                ? k1_scores<false, GENERAL>(s, mask, slope, qi, segq, k0 + at, aux, lane, at)
                : k1_scores<true, GENERAL>(s, mask, slope, qi, segq, k0 + at, aux, lane, at);
        if (walk == 0) {
          // online: l and Σ exp(s − m)·dP rescaled to m_new as a row's max rises
          const float m_new[2] = {fmaxf(m[0], mx.x), fmaxf(m[1], mx.y)};
          const float rescale[2] = {expf(m[0] - m_new[0]), expf(m[1] - m_new[1])};
          float sum[2] = {0.f, 0.f}, dsum[2] = {0.f, 0.f};
#pragma unroll
          for (int n = 0; n < 4; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float w = expf(s[n][e] - m_new[e >> 1]);
              sum[e >> 1] += w;
              dsum[e >> 1] += w * dp[n][e];
            }
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            l[r] = l[r] * rescale[r] + quad_sum(sum[r]);
            dd[r] = dd[r] * rescale[r] + quad_sum(dsum[r]);
            m[r] = m_new[r];
          }
        } else {
          // dS = P∘(dP − D), re-masked (a masked score is -1e9 exactly),
          // scaled; then dQ += dS·K with dS's registers as the A fragment
#pragma unroll
          for (int n = 0; n < 4; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = e >> 1;
              const float p = expf(s[n][e] - m[r]) * inv_l[r];
              const float x = s[n][e] == NEG ? 0.f : p * (dp[n][e] - dd[r]);
              s[n][e] = x * mask.scale;
            }
          pv_part_3xtf32<D, 4>(o, s, Kb + at * LD, Ksm + at * LD, lane);
        }
      }
      __syncthreads();  // K, V and K's aux consumed
      if (kt < kt_hi) {
        issue_v(kt + 1);
        issue_k(kt + 1);
        cp_async_commit();
      }
    }
    if (walk == 0) {
      // Every key the walk did not visit counts as masked, exp(-1e9 − m)
      // each (1 for a row with no valid key, whose l is then T); the padding
      // past T that it did visit does not count.
      const int n_walked = (kt_hi + 1 - kt_lo) * MMA_TILE;
      const int64_t srow = ((int64_t)blockIdx.z * H + h) * T;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += (float)(T - n_walked) * expf(NEG - m[r]);
        inv_l[r] = 1.f / l[r];
        dd[r] /= l[r];
        if ((lane & 3) == 0 && qi[r] < T) {
          stats[srow + qi[r]] = m[r];
          stats[n_rows + srow + qi[r]] = l[r];
          stats[2 * n_rows + srow + qi[r]] = dd[r];
        }
      }
    }
  }
  // dQ through the (free) Q tile: each warp stages its own rows
  stage_rows_f32<D>(Qs + warp * 16 * LD, o, lane);
  __syncthreads();
  store_tile_f32<D>(dq + row0 * HD + h * D, HD, Qs, q0, T);
}

// One query tile's side of the cols pass in shared memory: the rows pass's
// m, 1/l and D of each query (1/l = 1 past T, so that a padded query's p is
// 0, not 0/0) and, for the general variant, its segment id.
struct QueryAux {
  float m[MMA_TILE], inv_l[MMA_TILE], d[MMA_TILE];
  int seg[MMA_TILE];
};

// Sᵀ of a warp's 16 keys and 8N queries from q0 → the masked scores, as
// k1_scores masks S: × scale, ALiBi with two roundings (slope × the key's
// position), where(mask, s, -1e9). A query at or past T is masked. MASK =
// false: every pair is known to be allowed. kr[r]: the tile rows of the
// lane's keys (rows lane/4 and lane/4 + 8 of the warp's 16); segq: the
// queries' segment ids.
template <bool MASK, bool GENERAL, int N>
__device__ __forceinline__ void k2_scores_t(float (&s)[N][4], const Mask& m, float slope,
                                            const int (&kr)[2], int k0, int q0, int T,
                                            const KeyAux* a, const int* segq, int lane) {
  const int c0 = (lane & 3) * 2;  // the lane's first column in each 8-query n-tile
  float ab[2];
  bool live[2];
  int sk[2], lo[2], hi[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int ki = k0 + kr[r];
    if (GENERAL && m.use_alibi) ab[r] = __fmul_rn(slope, (float)(m.kpos ? a->kpos[kr[r]] : ki));
    if (MASK) {
      live[r] = a->km[kr[r]] > 0;
      if (GENERAL && m.segments != nullptr) sk[r] = a->seg[kr[r]];
      // allowed iff lo[r] ≤ column − c0 ≤ hi[r]: ki ≤ query < min(T, ki + window)
      lo[r] = ki - q0 - c0;
      hi[r] = (m.window > 0 ? min(T - 1, ki + m.window - 1) : T - 1) - q0 - c0;
    }
  }
#pragma unroll
  for (int n = 0; n < N; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1, j = e & 1, c = n * 8 + j;
      float x = s[n][e] * m.scale;
      if (GENERAL && m.use_alibi) x = __fadd_rn(x, ab[r]);
      if (MASK) {
        bool ok = live[r] & (c >= lo[r]) & (c <= hi[r]);
        if (GENERAL && m.segments != nullptr) ok = ok & (segq[c + c0] == sk[r]);
        x = ok ? x : NEG;
      }
      s[n][e] = x;
    }
  }
}

// fp32 K2 on the tensor cores, cols pass (D = Dh in {16, 32, 64, 128}); see
// the note at the top. One block of 4 warps per (64 keys, head, batch row),
// natural order (longest first under a causal mask); warp w owns keys
// 16w .. 16w + 15 and keeps their dK and dV in registers while the query
// tiles that reach them, and every tile with a fully masked row, stream by.
template <int D, bool GENERAL>
__global__ void __launch_bounds__(MMA_THREADS, D <= 64 ? 2 : 1)
tf32_cols(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
          const float* __restrict__ g, float* __restrict__ dk, float* __restrict__ dv,
          const float* __restrict__ stats, const Mask mask, int T, int H) {
  constexpr int LD = D + 4;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);  // the block's keys, later dK's staging tile
  float* Vs = Ks + MMA_TILE * LD;                  // their values, later dV's staging tile
  float* Qb = Vs + MMA_TILE * LD;                  // a Q tile (big parts once split)
  float* Qsm = Qb + MMA_TILE * LD;                 // its small parts
  float* Gb = Qsm + MMA_TILE * LD;                 // its output gradients (big parts)
  float* Gsm = Gb + MMA_TILE * LD;                 // their small parts
  KeyAux* aux = reinterpret_cast<KeyAux*>(Gsm + MMA_TILE * LD);
  QueryAux* qa = reinterpret_cast<QueryAux*>(aux + 1);  // with Q's tile
  __shared__ int dead[MAX_T / MMA_TILE];  // query tiles that hold a row with no valid key

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int k0 = blockIdx.x * MMA_TILE, h = blockIdx.y;
  const int64_t row0 = (int64_t)blockIdx.z * T;
  const int64_t HD = (int64_t)H * D;
  const int64_t n_rows = (int64_t)gridDim.z * H * T;
  const int64_t srow = ((int64_t)blockIdx.z * H + h) * T;
  const float* qh = q + row0 * HD + h * D;
  const float* gh = g + row0 * HD + h * D;
  const float* krows = Ks + warp * 16 * LD;
  const float* vrows = Vs + warp * 16 * LD;
  const float slope = GENERAL && mask.use_alibi ? mask.slopes[h] : 0.f;
  const int kr[2] = {warp * 16 + (lane >> 2), warp * 16 + (lane >> 2) + 8};

  load_tile_async_f32<D>(Ks, k + row0 * HD + h * D, HD, k0, T);
  load_tile_async_f32<D>(Vs, v + row0 * HD + h * D, HD, k0, T);
  load_aux_async<GENERAL>(aux, mask, row0, k0, T);  // joins the first tile's group

  // A fully masked query row is uniform 1/T over every key: its tile
  // reaches every key block (its g/T goes to dV; its dS is 0).
  const int last = (T - 1) / MMA_TILE;
  if (threadIdx.x <= last) dead[threadIdx.x] = 0;
  __syncthreads();
  for (int r = threadIdx.x; r < T; r += MMA_THREADS)
    if (stats[srow + r] == NEG) dead[r / MMA_TILE] = 1;
  __syncthreads();
  // the query tiles that hold a causal, in-window pair for the block's keys
  const int qt_lo = blockIdx.x;
  const int qt_hi = mask.window > 0 ? min(last, (k0 + MMA_TILE - 2 + mask.window) / MMA_TILE)
                                    : last;
  auto next_tile = [&](int qt) {  // the first tile at or after qt to visit, or -1
    for (; qt <= last; ++qt)
      if ((qt >= qt_lo && qt <= qt_hi) || dead[qt]) return qt;
    return -1;
  };
  auto issue_q = [&](int qt) {
    const int j = threadIdx.x % MMA_TILE, qi = qt * MMA_TILE + j;
    const bool ok = qi < T;
    load_tile_async_f32<D>(Qb, qh, HD, qt * MMA_TILE, T);
    if (threadIdx.x < MMA_TILE) {
      const float* st = stats + srow + (ok ? qi : 0);
      cp_async4(qa->m + j, st, ok);
      cp_async4(qa->inv_l + j, st + n_rows, ok);
      cp_async4(qa->d + j, st + 2 * n_rows, ok);
    } else if (GENERAL && mask.segments != nullptr) {
      cp_async4(qa->seg + j, mask.segments + row0 + (ok ? qi : 0), ok);
    }
  };
  auto issue_g = [&](int qt) { load_tile_async_f32<D>(Gb, gh, HD, qt * MMA_TILE, T); };

  float ak[D / 8][4], av[D / 8][4];  // dK, dV
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) ak[n][e] = av[n][e] = 0.f;
  int qt = next_tile(0);
  issue_q(qt);  // one cp.async group a tile: Q, g and the query side
  issue_g(qt);
  cp_async_commit();
  while (qt >= 0) {
    const int nxt = next_tile(qt + 1);
    cp_async_wait<0>();
    if (threadIdx.x < MMA_TILE)  // l → 1/l, once a query, by the thread that copied it
      qa->inv_l[threadIdx.x] =
          qt * MMA_TILE + threadIdx.x < T ? 1.f / qa->inv_l[threadIdx.x] : 1.f;
    split_own_chunks<D>(Qb, Qsm);
    split_own_chunks<D>(Gb, Gsm);
    __syncthreads();  // Q and g of tile qt (the first time also K, V) landed and split
    const int q0 = qt * MMA_TILE;
    const bool in_range = q0 >= k0 + MMA_TILE - 1 && q0 + MMA_TILE <= T &&
                          (mask.window <= 0 || q0 + MMA_TILE - 1 < k0 + mask.window) &&
                          !(GENERAL && mask.segments != nullptr);
    const bool unmasked =
        __all_sync(0xffffffffu, in_range & (aux->km[lane] > 0) & (aux->km[lane + 32] > 0));
    // the tile's 64 queries in two halves of 32, to keep Sᵀ and dPᵀ at 32
    // registers beside dK and dV
#pragma unroll 1
    for (int half = 0; half < 2; ++half) {
      const int c_at = 32 * half;  // the half's first query in the tile
      const float* qb = Qb + c_at * LD;
      const float* qsm = Qsm + c_at * LD;
      const float* gb = Gb + c_at * LD;
      const float* gsm = Gsm + c_at * LD;
      float s[4][4], dp[4][4];  // Sᵀ = K·Qᵀ, dPᵀ = V·gᵀ
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int d = 0; d < D / 8; ++d) {
        uint32_t ab[4], as[4];
        a_frag_3xtf32<D>(ab, as, krows, d, lane);
        qk_part_3xtf32<D, 4, true>(s, ab, as, qb, qsm, d, lane);
        a_frag_3xtf32<D>(ab, as, vrows, d, lane);
        qk_part_3xtf32<D, 4, true>(dp, ab, as, gb, gsm, d, lane);
      }
      if (unmasked)
        k2_scores_t<false, GENERAL, 4>(s, mask, slope, kr, k0, q0 + c_at, T, aux,
                                       qa->seg + c_at, lane);
      else
        k2_scores_t<true, GENERAL, 4>(s, mask, slope, kr, k0, q0 + c_at, T, aux,
                                      qa->seg + c_at, lane);
      // Pᵀ = exp(s − m) / l from the rows pass's statistics; dSᵀ as in tf32_rows
      const int c0 = c_at + (lane & 3) * 2;
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = n * 8 + c0 + (e & 1);
          const float p = expf(s[n][e] - qa->m[c]) * qa->inv_l[c];
          const float x = s[n][e] == NEG ? 0.f : p * (dp[n][e] - qa->d[c]);
          s[n][e] = p;
          dp[n][e] = x * mask.scale;
        }
      pv_part_3xtf32<D, 4>(ak, dp, qb, qsm, lane);  // dK += dSᵀ·Q
      pv_part_3xtf32<D, 4>(av, s, gb, gsm, lane);   // dV += Pᵀ·g
    }
    __syncthreads();  // Q, g and the query side consumed
    if (nxt >= 0) {
      issue_q(nxt);
      issue_g(nxt);
      cp_async_commit();
    }
    qt = nxt;
  }
  // dK and dV through the (free) K and V tiles: each warp stages its own rows
  stage_rows_f32<D>(Ks + warp * 16 * LD, ak, lane);
  stage_rows_f32<D>(Vs + warp * 16 * LD, av, lane);
  __syncthreads();
  store_tile_f32<D>(dk + row0 * HD + h * D, HD, Ks, k0, T);
  store_tile_f32<D>(dv + row0 * HD + h * D, HD, Vs, k0, T);
}

// ---- fp32 K2 at Dh 256 (GPT-J) on the tensor cores (see the note at the top) ----

constexpr int WIDE_KC = 16;             // rows pass: keys of a ring stage (two stages)
constexpr int WIDE_QC = 16;             // cols pass: query rows of a ring stage (two stages)
static_assert(MMA_TILE % WIDE_KC == 0 && MMA_TILE % WIDE_QC == 0, "whole stages a tile");

constexpr int WIDE_THREADS = 2 * MMA_THREADS;  // both passes: 8 warps, two to each 16 rows or keys

// The pairs' exchange buffer of both passes: S and dP (Sᵀ and dPᵀ) of a
// stage, 2 × 2 n-tiles a pair, one float4 a lane and n-tile
constexpr size_t WIDE_XCHG = sizeof(float4) * MMA_WARPS * 4 * 32;

// Shared memory of the rows pass: the Q and g tiles (row stride 260), two
// ring stages of WIDE_KC keys of K and V with their mask inputs (a KeyAux
// whose first WIDE_KC entries are the stage's keys), the exchange buffer
struct RowsWideSmem {
  static constexpr int LD = 260;
  static constexpr size_t TILES = 2 * MMA_TILE * LD;  // Q and g (floats)
  static constexpr size_t STAGE = sizeof(float) * 2 * WIDE_KC * LD + sizeof(KeyAux);
  static constexpr size_t BYTES = sizeof(float) * TILES + 2 * STAGE + WIDE_XCHG;
};

// fp32 K2's rows pass at Dh 256: tf32_rows with the tiles and walk laid out
// for 256. One block of 8 warps per (64 query rows, head, batch row),
// longest rows first; warps w and w + 4 own rows 16(w % 4) .. + 15: each
// sums half of Dh into their S and dP (the pair's sum S_lo + S_hi through
// shared memory, mma_tf32.cuh's pair_*) and keeps half of their dQ columns
// in registers; Q's and g's A fragments are read from their shared tiles at
// each k-step. The keys of the tiles that hold a causal, in-window pair for
// the block (those before T) stream through a two-stage cp.async ring of
// WIDE_KC keys, unsplit, each value split where a lane reads it, twice:
// walk 1 takes m, l and D online, WIDE_KC keys at a time; walk 2 forms dS
// and accumulates dQ = dS·K. One barrier a stage.
template <bool GENERAL>
__global__ void __launch_bounds__(WIDE_THREADS, 1)
tf32_rows_wide(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ g, float* __restrict__ dq,
               float* __restrict__ stats, const Mask mask, int T, int H) {
  constexpr int D = 256, LD = RowsWideSmem::LD, KC = WIDE_KC, N = KC / 8, HALF = D / 2,
                NTH = WIDE_THREADS;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);  // the Q tile, later dQ's staging tile
  float* Gs = Qs + MMA_TILE * LD;                  // the output gradient's tile
  unsigned char* ring = smem_raw + sizeof(float) * RowsWideSmem::TILES;

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32 % MMA_WARPS;  // the warp's rows
  const int upper = threadIdx.x / 32 / MMA_WARPS, col0 = upper * HALF;    // its half of Dh
  float4* xs = reinterpret_cast<float4*>(ring + 2 * RowsWideSmem::STAGE) + warp * 4 * 32 + lane;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * MMA_TILE, h = blockIdx.y;
  const int64_t row0 = (int64_t)blockIdx.z * T;
  const int64_t HD = (int64_t)H * D;
  const int64_t n_rows = (int64_t)gridDim.z * H * T;
  const float* kh = k + row0 * HD + h * D;
  const float* vh = v + row0 * HD + h * D;
  const float* qrows = Qs + warp * 16 * LD;
  const float* grows = Gs + warp * 16 * LD;
  const float slope = GENERAL && mask.use_alibi ? mask.slopes[h] : 0.f;
  int qi[2], segq[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    qi[r] = q0 + warp * 16 + (lane >> 2) + 8 * r;
    segq[r] = GENERAL && mask.segments != nullptr && qi[r] < T ? mask.segments[row0 + qi[r]] : 0;
  }
  // the stages of the walk: the key tiles that hold a causal, in-window
  // pair for the block, cut at T (a key past T is padded: p = 0, and the
  // count of unvisited keys below covers it)
  const int q_last = min(q0 + MMA_TILE - 1, T - 1);
  const int kt_lo = mask.window > 0 ? max(0, q0 - mask.window + 1) / MMA_TILE : 0;
  const int c_lo = kt_lo * MMA_TILE / KC;
  const int c_end = min((q_last / MMA_TILE + 1) * MMA_TILE, (T + KC - 1) / KC * KC) / KC;
  const int n = c_end - c_lo;  // stages a walk

  auto issue = [&](int j) {  // stage j of the two walks into ring slot j & 1
    unsigned char* st = ring + (j & 1) * RowsWideSmem::STAGE;
    float* ks = reinterpret_cast<float*>(st);
    const int k0 = (c_lo + j % n) * KC;
    load_tile_async_f32<D, KC, NTH>(ks, kh, HD, k0, T);
    load_tile_async_f32<D, KC, NTH>(ks + KC * LD, vh, HD, k0, T);
    if (threadIdx.x < MMA_THREADS)
      load_aux_async<GENERAL>(reinterpret_cast<KeyAux*>(ks + 2 * KC * LD), mask, row0, k0, T);
  };

  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f}, dd[2] = {0.f, 0.f};
  float inv_l[2];
  float o[HALF / 8][4];  // the warp's columns of dQ
#pragma unroll
  for (int c = 0; c < HALF / 8; ++c) o[c][0] = o[c][1] = o[c][2] = o[c][3] = 0.f;
  // join stage 0's group
  load_tile_async_f32<D, MMA_TILE, NTH>(Qs, q + row0 * HD + h * D, HD, q0, T);
  load_tile_async_f32<D, MMA_TILE, NTH>(Gs, g + row0 * HD + h * D, HD, q0, T);
  issue(0);
  cp_async_commit();
#pragma unroll 1
  for (int j = 0; j < 2 * n; ++j) {
    const unsigned char* st = ring + (j & 1) * RowsWideSmem::STAGE;
    const float* Ks = reinterpret_cast<const float*>(st);
    const float* Vs = Ks + KC * LD;
    const KeyAux* a = reinterpret_cast<const KeyAux*>(Vs + KC * LD);
    cp_async_wait<0>();
    __syncthreads();  // stage j landed (at j = 0 also Q and g); stage j - 1 consumed
    if (j + 1 < 2 * n) {  // stage j + 1 copies while this one computes
      issue(j + 1);
      cp_async_commit();
    }
    const int walk = j / n, k0 = (c_lo + j % n) * KC;
    if (j == n) {
      // Every key walk 1 did not visit counts as masked, exp(-1e9 − m) each
      // (1 for a row with no valid key, whose l is then T).
      const int64_t srow = ((int64_t)blockIdx.z * H + h) * T;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += (float)(T - n * KC) * expf(NEG - m[r]);
        inv_l[r] = 1.f / l[r];
        dd[r] /= l[r];
        if (!upper && (lane & 3) == 0 && qi[r] < T) {
          stats[srow + qi[r]] = m[r];
          stats[n_rows + srow + qi[r]] = l[r];
          stats[2 * n_rows + srow + qi[r]] = dd[r];
        }
      }
    }
    const bool in_range = k0 + KC - 1 <= q0 &&
                          (mask.window <= 0 || k0 > q0 + MMA_TILE - 1 - mask.window) &&
                          !(GENERAL && mask.segments != nullptr);
    const bool unmasked = __all_sync(0xffffffffu, in_range & (a->km[lane % KC] > 0));
    float dp[N][4], s[N][4];  // dP = g·Vᵀ, S = Q·Kᵀ
#pragma unroll
    for (int c = 0; c < N; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[c][e] = s[c][e] = 0.f;
#pragma unroll 2
    for (int d = upper * (D / 16); d < (upper + 1) * (D / 16); ++d) {
      uint32_t ab[4], as[4];
      a_frag_3xtf32<D>(ab, as, grows, d, lane);
      qk_part_3xtf32_unsplit<D, N>(dp, ab, as, Vs, d, lane);
      a_frag_3xtf32<D>(ab, as, qrows, d, lane);
      qk_part_3xtf32_unsplit<D, N>(s, ab, as, Ks, d, lane);
    }
    pair_sum(s, dp, xs, upper, warp);
    const float2 mx = unmasked ? k1_scores<false, GENERAL, N>(s, mask, slope, qi, segq, k0, a, lane)
                               : k1_scores<true, GENERAL, N>(s, mask, slope, qi, segq, k0, a, lane);
    if (walk == 0) {
      // online, as tf32_rows: l and Σ exp(s − m)·dP rescaled to m_new
      const float m_new[2] = {fmaxf(m[0], mx.x), fmaxf(m[1], mx.y)};
      const float rescale[2] = {expf(m[0] - m_new[0]), expf(m[1] - m_new[1])};
      float sum[2] = {0.f, 0.f}, dsum[2] = {0.f, 0.f};
#pragma unroll
      for (int c = 0; c < N; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float w = expf(s[c][e] - m_new[e >> 1]);
          sum[e >> 1] += w;
          dsum[e >> 1] += w * dp[c][e];
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] = l[r] * rescale[r] + quad_sum(sum[r]);
        dd[r] = dd[r] * rescale[r] + quad_sum(dsum[r]);
        m[r] = m_new[r];
      }
    } else {
      // dS = P∘(dP − D), re-masked, scaled; dQ += dS·K (dS's registers as A)
#pragma unroll
      for (int c = 0; c < N; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const float p = expf(s[c][e] - m[r]) * inv_l[r];
          const float x = s[c][e] == NEG ? 0.f : p * (dp[c][e] - dd[r]);
          s[c][e] = x * mask.scale;
        }
      pv_part_3xtf32_unsplit<D, N, HALF>(o, s, Ks + col0, lane);
    }
  }
  // dQ through the (free) Q tile: each warp stages its rows' half of the
  // columns, where only it read Q
  stage_rows_f32<D, HALF>(Qs + warp * 16 * LD + col0, o, lane);
  __syncthreads();
  store_tile_f32<D, NTH>(dq + row0 * HD + h * D, HD, Qs, q0, T);
}

// One cols-pass ring stage's query side: the rows pass's m, 1/l and D of
// WIDE_QC queries (1/l = 1 past T) and, for the general variant, their
// segment ids
struct QueryAuxWide {
  float m[WIDE_QC], inv_l[WIDE_QC], d[WIDE_QC];
  int seg[WIDE_QC];
};

// Shared memory of the cols pass: the K and V tiles, K's mask inputs, two
// ring stages of WIDE_QC query rows of Q and g with their QueryAuxWide, the
// exchange buffer
struct ColsWideSmem {
  static constexpr int LD = 260;
  static constexpr size_t TILES = 2 * MMA_TILE * LD;  // K and V (floats)
  static constexpr size_t STAGE = sizeof(float) * 2 * WIDE_QC * LD + sizeof(QueryAuxWide);
  static constexpr size_t BYTES = sizeof(float) * TILES + sizeof(KeyAux) + 2 * STAGE + WIDE_XCHG;
};

// fp32 K2's cols pass at Dh 256: tf32_cols with the tiles and warps laid
// out for 256. One block of 8 warps per (64 keys, head, batch row); warps w
// and w + 4 own keys 16(w % 4) .. + 15: each sums half of Dh into their Sᵀ
// and dPᵀ (the pair's sum as the rows pass takes it, with the operands'
// roles swapped: the rows pass's S and P bit for bit) and keeps one half of
// their dK and dV columns in registers, w < 4 the first 128, w ≥ 4 the
// last. The query tiles that reach the keys, and every tile with a fully
// masked row, stream through a two-stage cp.async ring WIDE_QC rows at a
// time (rows before T), unsplit, each value split where a lane reads it.
// One barrier a stage.
template <bool GENERAL>
__global__ void __launch_bounds__(WIDE_THREADS, 1)
tf32_cols_wide(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ g, float* __restrict__ dk,
               float* __restrict__ dv, const float* __restrict__ stats, const Mask mask, int T,
               int H) {
  constexpr int D = 256, LD = ColsWideSmem::LD, QC = WIDE_QC, N = QC / 8, HALF = D / 2,
                NTH = WIDE_THREADS;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);  // the block's keys, later dK's staging tile
  float* Vs = Ks + MMA_TILE * LD;                  // their values, later dV's staging tile
  KeyAux* aux = reinterpret_cast<KeyAux*>(Vs + MMA_TILE * LD);
  unsigned char* ring = reinterpret_cast<unsigned char*>(aux + 1);
  __shared__ int dead[MAX_T / MMA_TILE];  // query tiles that hold a row with no valid key

  const int lane = threadIdx.x % 32, kw = threadIdx.x / 32 % MMA_WARPS;  // the warp's keys
  const int upper = threadIdx.x / 32 / MMA_WARPS, col0 = upper * HALF;  // its half of Dh
  float4* xs = reinterpret_cast<float4*>(ring + 2 * ColsWideSmem::STAGE) + kw * 4 * 32 + lane;
  const int k0 = blockIdx.x * MMA_TILE, h = blockIdx.y;
  const int64_t row0 = (int64_t)blockIdx.z * T;
  const int64_t HD = (int64_t)H * D;
  const int64_t n_rows = (int64_t)gridDim.z * H * T;
  const int64_t srow = ((int64_t)blockIdx.z * H + h) * T;
  const float* qh = q + row0 * HD + h * D;
  const float* gh = g + row0 * HD + h * D;
  const float* krows = Ks + kw * 16 * LD;
  const float* vrows = Vs + kw * 16 * LD;
  const float slope = GENERAL && mask.use_alibi ? mask.slopes[h] : 0.f;
  const int kr[2] = {kw * 16 + (lane >> 2), kw * 16 + (lane >> 2) + 8};

  load_tile_async_f32<D, MMA_TILE, NTH>(Ks, k + row0 * HD + h * D, HD, k0, T);
  load_tile_async_f32<D, MMA_TILE, NTH>(Vs, v + row0 * HD + h * D, HD, k0, T);
  if (threadIdx.x < MMA_THREADS)  // joins the first stage's group
    load_aux_async<GENERAL>(aux, mask, row0, k0, T);

  // A fully masked query row is uniform 1/T over every key: its tile
  // reaches every key block (its g/T goes to dV; its dS is 0).
  const int last = (T - 1) / MMA_TILE;
  if (threadIdx.x <= last) dead[threadIdx.x] = 0;
  __syncthreads();
  for (int r = threadIdx.x; r < T; r += NTH)
    if (stats[srow + r] == NEG) dead[r / MMA_TILE] = 1;
  __syncthreads();
  // the query tiles that hold a causal, in-window pair for the block's keys
  const int qt_lo = blockIdx.x;
  const int qt_hi = mask.window > 0 ? min(last, (k0 + MMA_TILE - 2 + mask.window) / MMA_TILE)
                                    : last;
  // the stage after query rows q (a multiple of WIDE_QC) in the walk, or -1:
  // the next stage of the tile while it holds rows before T, else the first
  // of the next tile to visit
  auto next_stage = [&](int q_at) {
    if (q_at % MMA_TILE != 0 && q_at < T) return q_at;
    for (int qt = q_at / MMA_TILE + (q_at % MMA_TILE != 0); qt <= last; ++qt)
      if ((qt >= qt_lo && qt <= qt_hi) || dead[qt]) return qt * MMA_TILE;
    return -1;
  };
  auto issue = [&](int q_at, int slot) {  // query rows q_at .. + QC into ring slot `slot`
    unsigned char* st = ring + slot * ColsWideSmem::STAGE;
    float* qs = reinterpret_cast<float*>(st);
    load_tile_async_f32<D, QC, NTH>(qs, qh, HD, q_at, T);
    load_tile_async_f32<D, QC, NTH>(qs + QC * LD, gh, HD, q_at, T);
    QueryAuxWide* qa = reinterpret_cast<QueryAuxWide*>(qs + 2 * QC * LD);
    const int j = threadIdx.x % QC, qi = q_at + j;
    const bool ok = qi < T;
    if (threadIdx.x < QC) {
      const float* sp = stats + srow + (ok ? qi : 0);
      cp_async4(qa->m + j, sp, ok);
      cp_async4(qa->inv_l + j, sp + n_rows, ok);
      cp_async4(qa->d + j, sp + 2 * n_rows, ok);
    } else if (threadIdx.x < 2 * QC && GENERAL && mask.segments != nullptr) {
      cp_async4(qa->seg + j, mask.segments + row0 + (ok ? qi : 0), ok);
    }
  };

  float ak[HALF / 8][4], av[HALF / 8][4];  // the warp's columns of dK, dV
#pragma unroll
  for (int c = 0; c < HALF / 8; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) ak[c][e] = av[c][e] = 0.f;
  int q_at = next_stage(0);
  issue(q_at, 0);
  cp_async_commit();
#pragma unroll 1
  for (int i = 0; q_at >= 0; ++i) {
    unsigned char* st = ring + (i & 1) * ColsWideSmem::STAGE;
    const float* Qc = reinterpret_cast<const float*>(st);
    const float* Gc = Qc + QC * LD;
    QueryAuxWide* qa = reinterpret_cast<QueryAuxWide*>(st + sizeof(float) * 2 * QC * LD);
    const int nxt = next_stage(q_at + QC);
    cp_async_wait<0>();
    if (threadIdx.x < QC)  // l → 1/l, once a query, by the thread that copied it
      qa->inv_l[threadIdx.x] = q_at + threadIdx.x < T ? 1.f / qa->inv_l[threadIdx.x] : 1.f;
    __syncthreads();  // stage i landed (at i = 0 also K, V); stage i - 1 consumed
    if (nxt >= 0) {  // stage i + 1 copies while this one computes
      issue(nxt, (i + 1) & 1);
      cp_async_commit();
    }
    const bool in_range = q_at >= k0 + MMA_TILE - 1 && q_at + QC <= T &&
                          (mask.window <= 0 || q_at + QC - 1 < k0 + mask.window) &&
                          !(GENERAL && mask.segments != nullptr);
    const bool unmasked =
        __all_sync(0xffffffffu, in_range & (aux->km[lane] > 0) & (aux->km[lane + 32] > 0));
    float s[N][4], dp[N][4];  // Sᵀ = K·Qᵀ, dPᵀ = V·gᵀ
#pragma unroll
    for (int c = 0; c < N; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[c][e] = dp[c][e] = 0.f;
#pragma unroll 2
    for (int d = upper * (D / 16); d < (upper + 1) * (D / 16); ++d) {
      uint32_t ab[4], as[4];
      a_frag_3xtf32<D>(ab, as, krows, d, lane);
      qk_part_3xtf32_unsplit<D, N, true>(s, ab, as, Qc, d, lane);
      a_frag_3xtf32<D>(ab, as, vrows, d, lane);
      qk_part_3xtf32_unsplit<D, N, true>(dp, ab, as, Gc, d, lane);
    }
    pair_sum(s, dp, xs, upper, kw);
    if (unmasked)
      k2_scores_t<false, GENERAL, N>(s, mask, slope, kr, k0, q_at, T, aux, qa->seg, lane);
    else
      k2_scores_t<true, GENERAL, N>(s, mask, slope, kr, k0, q_at, T, aux, qa->seg, lane);
    // Pᵀ = exp(s − m) / l from the rows pass's statistics; dSᵀ as in tf32_cols
    const int c0 = (lane & 3) * 2;
#pragma unroll
    for (int c = 0; c < N; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = c * 8 + c0 + (e & 1);
        const float p = expf(s[c][e] - qa->m[col]) * qa->inv_l[col];
        const float x = s[c][e] == NEG ? 0.f : p * (dp[c][e] - qa->d[col]);
        s[c][e] = p;
        dp[c][e] = x * mask.scale;
      }
    pv_part_3xtf32_unsplit<D, N, HALF>(ak, dp, Qc + col0, lane);  // dK += dSᵀ·Q
    pv_part_3xtf32_unsplit<D, N, HALF>(av, s, Gc + col0, lane);   // dV += Pᵀ·g
    q_at = nxt;
  }
  // dK and dV through the (free) K and V tiles: each warp stages its rows'
  // half of the columns, once every warp has read its A fragments
  __syncthreads();
  stage_rows_f32<D, HALF>(Ks + kw * 16 * LD + col0, ak, lane);
  stage_rows_f32<D, HALF>(Vs + kw * 16 * LD + col0, av, lane);
  __syncthreads();
  store_tile_f32<D, NTH>(dk + row0 * HD + h * D, HD, Ks, k0, T);
  store_tile_f32<D, NTH>(dv + row0 * HD + h * D, HD, Vs, k0, T);
}

// the fp32 pair: tf32_rows, then tf32_cols, on one stream
template <int D>
cudaError_t launch_tf32(const void* q, const void* k, const void* v, const void* g, void* dq,
                        void* dk, void* dv, float* stats, const Mask& mask, int B, int T, int H,
                        cudaStream_t st) {
  const bool general = mask.use_alibi || mask.segments != nullptr;
  const dim3 grid((T + MMA_TILE - 1) / MMA_TILE, H, B);
  const float *q_ = static_cast<const float*>(q), *k_ = static_cast<const float*>(k),
              *v_ = static_cast<const float*>(v), *g_ = static_cast<const float*>(g);
  const size_t smem_rows = tf32_tiles_bytes<D>() + sizeof(KeyAux);
  const size_t smem_cols = smem_rows + sizeof(QueryAux);
  auto rows = general ? tf32_rows<D, true> : tf32_rows<D, false>;
  auto cols = general ? tf32_cols<D, true> : tf32_cols<D, false>;
  cudaError_t err;
  if ((err = set_smem(rows, smem_rows)) != cudaSuccess) return err;
  rows<<<grid, MMA_THREADS, smem_rows, st>>>(q_, k_, v_, g_, static_cast<float*>(dq), stats,
                                             mask, T, H);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = set_smem(cols, smem_cols)) != cudaSuccess) return err;
  cols<<<grid, MMA_THREADS, smem_cols, st>>>(q_, k_, v_, g_, static_cast<float*>(dk),
                                             static_cast<float*>(dv), stats, mask, T, H);
  return cudaGetLastError();
}

// the fp32 pair at Dh 256: tf32_rows_wide, then tf32_cols_wide, on one stream
cudaError_t launch_tf32_wide(const void* q, const void* k, const void* v, const void* g,
                             void* dq, void* dk, void* dv, float* stats, const Mask& mask, int B,
                             int T, int H, cudaStream_t st) {
  const bool general = mask.use_alibi || mask.segments != nullptr;
  const dim3 grid((T + MMA_TILE - 1) / MMA_TILE, H, B);
  const float *q_ = static_cast<const float*>(q), *k_ = static_cast<const float*>(k),
              *v_ = static_cast<const float*>(v), *g_ = static_cast<const float*>(g);
  auto rows = general ? tf32_rows_wide<true> : tf32_rows_wide<false>;
  auto cols = general ? tf32_cols_wide<true> : tf32_cols_wide<false>;
  cudaError_t err;
  if ((err = set_smem(rows, RowsWideSmem::BYTES)) != cudaSuccess) return err;
  rows<<<grid, WIDE_THREADS, RowsWideSmem::BYTES, st>>>(q_, k_, v_, g_, static_cast<float*>(dq),
                                                        stats, mask, T, H);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = set_smem(cols, ColsWideSmem::BYTES)) != cudaSuccess) return err;
  cols<<<grid, WIDE_THREADS, ColsWideSmem::BYTES, st>>>(
      q_, k_, v_, g_, static_cast<float*>(dk), static_cast<float*>(dv), stats, mask, T, H);
  return cudaGetLastError();
}

template <typename scalar_t>
cudaError_t launch(const void* q, const void* k, const void* v, const void* g, void* dq,
                   void* dk, void* dv, float* stats, const Mask mask, int B, int T, int H,
                   int Dh, cudaStream_t st) {
  const int Tpad = (T + BK - 1) / BK * BK;
  const int Dhp = (Dh + 3) / 4 * 4;
  const int64_t n_rows = (int64_t)B * H * T;
  const size_t smem_a =
      sizeof(float) * ((size_t)BQ * Dhp + (size_t)BK * (Dhp + 4) + (size_t)BQ * Tpad);
  const size_t smem_b = sizeof(float) * ((size_t)2 * BKB * (Dhp + 4) +
                                         (size_t)2 * BQB * Dhp + (size_t)2 * BKB * LDT);
  const scalar_t *q_ = static_cast<const scalar_t*>(q), *k_ = static_cast<const scalar_t*>(k),
                 *v_ = static_cast<const scalar_t*>(v), *g_ = static_cast<const scalar_t*>(g);
  // vector loads need every head row's start aligned to 4 elements
  const uintptr_t ptrs = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)g;
  const bool vec = Dh % 4 == 0 && ptrs % (4 * sizeof(scalar_t)) == 0;
  cudaError_t err;
  if ((err = set_smem(rows_kernel<scalar_t>, smem_a)) != cudaSuccess) return err;
  rows_kernel<scalar_t><<<dim3((T + BQ - 1) / BQ, H, B), THREADS, smem_a, st>>>(
      q_, k_, v_, g_, static_cast<scalar_t*>(dq), stats, mask, T, H, Dh, Dhp, Tpad, n_rows,
      vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = set_smem(cols_kernel<scalar_t>, smem_b)) != cudaSuccess) return err;
  cols_kernel<scalar_t><<<dim3((T + BKB - 1) / BKB, H, B), THREADS, smem_b, st>>>(
      q_, k_, v_, g_, static_cast<scalar_t*>(dk), static_cast<scalar_t*>(dv), stats, mask, T,
      H, Dh, Dhp, n_rows, vec);
  return cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes. q/k/v/g/dq/dk/dv: (B, T, H·Dh) contiguous,
// fp32 (is_bf16 = 0) or bf16 (is_bf16 = 1). stats: 3·B·H·T fp32 scratch.
// key_mask, slopes, segments, kpos: as sgpt_short_attention_fwd. Launches two
// kernels on `stream`; returns the first cudaError_t met, 0 if both launched.
extern "C" int sgpt_short_attention_bwd(const void* q, const void* k, const void* v,
                                        const void* g, void* dq, void* dk, void* dv,
                                        float* stats, const int* key_mask, const float* slopes,
                                        const int* segments, const int* kpos, int B, int T,
                                        int H, int Dh, float scale, int window, int use_alibi,
                                        int is_bf16, void* stream) {
  if (B < 1 || T < 1 || T > MAX_T || H < 1 || Dh < 1 || Dh > MAX_DH || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Mask mask{key_mask, slopes, segments, kpos, scale, window, use_alibi};
  if (is_bf16) return (int)launch<bf16>(q, k, v, g, dq, dk, dv, stats, mask, B, T, H, Dh, st);
  const uintptr_t ptrs = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)g |
                         (uintptr_t)dq | (uintptr_t)dk | (uintptr_t)dv;
  if (ptrs % 16 == 0) {  // the fp32 pairs copy and store 16 bytes at a time
    switch (Dh) {
      case 16: return (int)launch_tf32<16>(q, k, v, g, dq, dk, dv, stats, mask, B, T, H, st);
      case 32: return (int)launch_tf32<32>(q, k, v, g, dq, dk, dv, stats, mask, B, T, H, st);
      case 64: return (int)launch_tf32<64>(q, k, v, g, dq, dk, dv, stats, mask, B, T, H, st);
      case 128: return (int)launch_tf32<128>(q, k, v, g, dq, dk, dv, stats, mask, B, T, H, st);
      case 256: return (int)launch_tf32_wide(q, k, v, g, dq, dk, dv, stats, mask, B, T, H, st);
    }
  }
  return (int)launch<float>(q, k, v, g, dq, dk, dv, stats, mask, B, T, H, Dh, st);
}
