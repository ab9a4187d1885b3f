// Causal flash attention forward for Hopper (compiled for sm_90a): K3.
//
// Replaces sgpt_tpu/ops/pallas/flash_attention.py:32 _flash_kernel, the TPU
// kernel of the long-context encode path (GPT-Neo at T % 128 == 0 with
// use_flash), and computes what it computes: per (batch row, head) an online
// softmax over key tiles with fp32 running max m, sum l and accumulator;
// scores q·k in fp32, × scale when scale != 1, + slope_h × key index (ALiBi),
// then where(mask, s, -1e30) with mask = causal ∧ [key > query − window] ∧
// key padding; p = exp(s − m_new) rounded to the input dtype before P·V; at
// the end l == 0 → 1, out = acc / l and lse = m + log(l). The (T, T) scores
// never leave the chip, and no shared-memory buffer grows with T.
//
// Tiles. The TPU kernel prunes whole (block_q, block_kv) tiles: a query tile
// visits key tile ki iff some causal pair lies in it and, with a window, the
// tile reaches past q_start − window. The masked keys of a visited tile still
// count for a query row with no valid key at all (a padded row that the
// window leaves empty keeps m = -1e30, so exp(s − m) = 1 on each of them: its
// output is the mean of V over the visited tiles). This kernel walks 64-row
// query tiles and 64-key sub-tiles, but visits, for each 64-row tile, exactly
// the keys of the block_kv tiles that its enclosing block_q tile visits, so
// every row, fully masked ones included, sees the TPU kernel's key set.
//
// Layout: q, k, v and out are (B, H, T, Dh) with any strides whose Dh axis is
// contiguous and whose rows are 16-byte aligned; the decoder passes views of
// its (B, T, H·Dh) projections, so no head transposes are copied.
//
// What bounds it on this card. The long-context encode runs bf16 (B=64,
// T=2048, H=12, Dh=64): a global layer needs 412.5 GFLOP for 805 MB of
// q/k/v/o (compute bound, 0.417 ms at 989 TFLOP/s) and a window-256 layer
// 96.7 GFLOP (memory bound, 0.242 ms at 3.35 TB/s). The long-context train
// step runs fp32 (B=8, same T, H and Dh; twice a layer, tower and chunk):
// 201 MB of q/k/v/o (0.060 ms) against 4.53e10 operations in a global layer
// and 1.06e10 in a window-256 one, which 3xTF32 (below) issues three times
// over on the TF32 tensor cores: 0.275 and 0.064 ms at 495 TFLOP/s, where
// the CUDA cores' 67 TFLOP/s would take 0.676 and 0.158. Both paths answer
// the compute side with tensor cores fed from registers and the memory side
// by reading each K/V sub-tile once per 64 query rows:
//   * flash_fwd_bf16<D>: one block of 4 warps per (64 query rows, head, batch
//     row), longest rows first; each warp owns 16 query rows. Q·Kᵀ and P·V
//     run as mma.sync m16n8k16 bf16 products (mma_attention.cuh): the Q
//     fragments, the score tile S, the probabilities P and the fp32 output
//     accumulator O stay in registers, and m, l and alpha are per-row quad
//     values. The block first lists the sub-tiles Walk visits (a key-mask
//     vote per candidate), then streams their K, V and key-mask values
//     through a 2-stage cp.async ring, so the next sub-tile's copy overlaps
//     this one's products. Sub-tiles whose every pair is in range and every
//     key live skip the per-score mask. The rescale folds alpha into the
//     accumulator (FA2): O = O·alpha, then the MMAs add P·V into O, where
//     the plain version adds a whole sub-tile's P·V to acc·alpha; the
//     outputs differ by fp32 summation order only. The output leaves
//     through shared memory as 16-byte stores.
//   * flash_fwd_tf32<D>: the same blocks, sub-tile list, masks and online
//     softmax with fp32 tiles, every product in 3xTF32 on mma.sync m16n8k8
//     (mma_tf32.cuh: each operand splits into a TF32 big and small part, and
//     three TF32 products keep about 22 significand bits, so the output
//     stays within 1e-5 + 1e-5·|ref| of the exact fp32 plain version, where
//     one TF32 product would not). P is not rounded (v is fp32) and goes
//     from the score registers into P·V as they stand (keys permuted within
//     each 8-key step). Each K and V value is split once for the block, by
//     the thread that copied it, as it lands; K streams through two stages,
//     V through one (copied during the sub-tile's scores), which keeps the
//     block at 6 fp32 tiles, two blocks an SM at Dh ≤ 64. At Dh 256 six
//     tiles would not fit the SM: the block keeps Q, one K and one V
//     sub-tile unsplit and splits each value where it is read.
//   At Dh 256 (GPT-J) flash_fwd_bf16 reads Q's fragments from the shared Q
//   tile at each k-step (qk_tile_smem), as K1's mma_kernel does there.
// Both skip the sub-tiles that cannot change any row of the block (see Walk).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_attention.cuh"
#include "mma_attention.cuh"
#include "mma_tf32.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int TQ = SUB;       // query rows per block
constexpr int TK = SUB;       // keys per sub-tile
constexpr int WARPS = 4;      // each warp owns TQ / WARPS = 16 query rows
constexpr int NTHREADS = 32 * WARPS;
constexpr int WR = TQ / WARPS;
static_assert(TQ == TK, "the tile loads move 64-row tiles of Q, K and V alike");

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;            // (B, H, T) contiguous
  const int* key_mask;   // (B, T) contiguous
  const float* slopes;   // (H,) or null: no ALiBi
  int H, T;
  long long sb, sh, st;  // q/k/v strides (elements) of the batch, head and time axes
  long long ob, oh, ot;  // out strides
  float scale;
  int window, block_q, block_kv;
};

// The block_kv tiles the enclosing block_q tile of query rows [q0, q0+64)
// visits: [0, last] less those a window ends before (TPU tile pruning).
//
// Within them, a sub-tile of keys [k0, k0+64) that masks every (row, key)
// pair of the block (all keys after the last row, all before the first
// row's window, or all padded) adds exactly nothing to a row that holds a
// valid key somewhere: before that key, m = -1e30 and the sub-tile's p = 1
// terms are wiped by alpha = exp(-1e30 − m) = 0; after it, alpha = 1 and
// p = 0. Such sub-tiles are skipped when every row of the block is known to
// hold one (its first in-range key is not padded); a block with a fully
// masked row visits every key of the TPU's tiles, which its output needs.
struct Walk {
  int q0, qs, last;
  bool all_live;
  __device__ Walk(const Params& p, int q0_, const int* kmg) : q0(q0_) {
    qs = q0 / p.block_q * p.block_q;
    last = min(p.T / p.block_kv - 1, (qs + p.block_q - 1) / p.block_kv);
    const int q = q0 + threadIdx.x % TQ;
    all_live = __syncthreads_and(kmg[p.window > 0 ? max(0, q - p.window + 1) : 0] != 0);
  }
  __device__ bool visits(const Params& p, int ki) const {
    return p.window <= 0 || ki * p.block_kv + p.block_kv - 1 > qs - p.window;
  }
  // whether the sub-tile at k0 (any_key: some key of it is not padded) is visited
  __device__ bool keeps(const Params& p, int k0, bool any_key) const {
    const bool masked = !any_key || !subtile_in_range(q0, k0, p.window);
    return !(all_live && masked);
  }
};

// whether every (row, key) pair of query rows [q0, q0 + 64) and keys
// [k0, k0 + 64) is in range (causal ∧ window)
__device__ __forceinline__ bool subtile_full(int q0, int k0, int window) {
  return k0 + SUB - 1 <= q0 && (window <= 0 || k0 > q0 + SUB - 1 - window);
}

constexpr int NEEDS_MASK = 1 << 30;  // list entry flag: some pair of the sub-tile is masked

// The block's sub-tiles, in key order, as `Walk` visits them: list[i] = k0,
// | NEEDS_MASK unless every pair of the sub-tile is in range and every key
// live. All four warps read the candidates' key masks (two 32-key votes
// each); warp 0 compacts. Returns the count; the block synchronises.
__device__ __forceinline__ int subtile_list(int* list, const Walk& walk, const Params& p,
                                            const int* kmg) {
  __shared__ int count;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int ki_lo = 0;
  while (ki_lo <= walk.last && !walk.visits(p, ki_lo)) ++ki_lo;
  const int per = p.block_kv / TK, t_lo = ki_lo * per, nc = (walk.last + 1) * per - t_lo;
  for (int i = warp; i < nc; i += WARPS) {
    const int k0 = (t_lo + i) * TK;
    const bool a = kmg[k0 + lane] != 0, b = kmg[k0 + lane + 32] != 0;
    const int any = __any_sync(0xffffffffu, a | b), all = __all_sync(0xffffffffu, a & b);
    if (lane == 0) list[i] = any | (all << 1);
  }
  __syncthreads();
  if (warp == 0) {
    int n = 0;
    for (int base = 0; base < nc; base += 32) {
      const int i = base + lane, k0 = (t_lo + i) * TK;
      const int f = i < nc ? list[i] : 0;
      const bool keep = i < nc && walk.keeps(p, k0, f & 1);
      const int entry = k0 | ((f & 2) && subtile_full(walk.q0, k0, p.window) ? 0 : NEEDS_MASK);
      const unsigned ballot = __ballot_sync(0xffffffffu, keep);
      __syncwarp();  // every lane has read its flag before any entry is written
      if (keep) list[n + __popc(ballot & ((1u << lane) - 1u))] = entry;
      n += __popc(ballot);
    }
    if (lane == 0) count = n;
  }
  __syncthreads();
  return count;
}

// S of a warp's 16 rows (query positions qpos[r]) and the sub-tile at k0 →
// scale, ALiBi, where(mask, s, -1e30); MASK = false: every pair is known to
// be allowed. Returns the rows' maxima over the sub-tile.
template <bool MASK>
__device__ __forceinline__ float2 k3_scores(float (&s)[8][4], const Params& p, float slope,
                                            const int (&qpos)[2], int k0, const int* kms,
                                            int lane) {
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1, kk = n * 8 + (lane & 3) * 2 + (e & 1), kpos = k0 + kk;
      float x = score(s[n][e], p.scale, p.slopes != nullptr, slope, kpos);
      if (MASK) x = (kms[kk] != 0) & in_range(qpos[r], kpos, p.window) ? x : NEG_INF;
      s[n][e] = x;
      mx[r] = fmaxf(mx[r], x);
    }
  }
  return make_float2(quad_max(mx[0]), quad_max(mx[1]));
}

template <int D>
__global__ void __launch_bounds__(NTHREADS, D <= 64 ? 4 : 2) flash_fwd_bf16(const Params p) {
  constexpr int LD = D + 8;
  static_assert(TQ == MMA_TILE && NTHREADS == MMA_THREADS, "mma_attention.cuh's block shape");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // the Q tile, later the output staging tile
  bf16* Ks = Qs + TQ * LD;                       // two stages
  bf16* Vs = Ks + 2 * TK * LD;                   // two stages
  int* kms = reinterpret_cast<int*>(Vs + 2 * TK * LD);  // two stages of TK key-mask values
  int* list = kms + 2 * TK;                             // T / 64 sub-tile entries

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * TQ, h = blockIdx.y, b = blockIdx.z;
  const long long base = b * p.sb + h * p.sh;
  const bf16* qg = static_cast<const bf16*>(p.q) + base;
  const bf16* kg = static_cast<const bf16*>(p.k) + base;
  const bf16* vg = static_cast<const bf16*>(p.v) + base;
  const int* kmg = p.key_mask + (long long)b * p.T;
  const float slope = p.slopes != nullptr ? p.slopes[h] : 0.f;
  const int qpos[2] = {q0 + warp * WR + (lane >> 2), q0 + warp * WR + (lane >> 2) + 8};

  load_tile_async<D>(Qs, qg, p.st, q0, p.T);
  const Walk walk(p, q0, kmg);
  const int n = subtile_list(list, walk, p, kmg);

  auto issue = [&](int i) {
    const int k0 = list[i] & ~NEEDS_MASK, stage = i & 1;
    load_tile_async<D>(Ks + stage * TK * LD, kg, p.st, k0, p.T);
    load_tile_async<D>(Vs + stage * TK * LD, vg, p.st, k0, p.T);
    if (threadIdx.x < TK / 4) cp_async16(kms + stage * TK + 4 * threadIdx.x, kmg + k0 + 4 * threadIdx.x, true);
  };

  // Dh 256 (GPT-J): Q's fragments are read from the Q tile at each k-step
  // (qk_tile_smem, the same bits), as in K1's mma_kernel: held, their 64
  // registers beside O's 128 would spill
  constexpr bool Q_IN_SMEM = D > 128;
  const bf16* qrows = Qs + warp * WR * LD;
  uint32_t qf[Q_IN_SMEM ? 1 : D / 16][4];
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float o[D / 8][4];
#pragma unroll
  for (int c = 0; c < D / 8; ++c) o[c][0] = o[c][1] = o[c][2] = o[c][3] = 0.f;
  if (n > 0) issue(0);
  cp_async_commit();
  for (int i = 0; i < n; ++i) {
    if (i + 1 < n) issue(i + 1);  // the next sub-tile's copy overlaps this one's MMAs
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // sub-tile i (and at i = 0 the Q tile) has landed for every thread
    const int entry = list[i], k0 = entry & ~NEEDS_MASK, stage = i & 1;
    float s[8][4];
    if constexpr (Q_IN_SMEM) {
      qk_tile_smem<D>(s, qrows, Ks + stage * TK * LD, lane);
    } else {
      if (i == 0) load_a_frags<D>(qf, qrows, lane);
      qk_tile<D>(s, qf, Ks + stage * TK * LD, lane);
    }
    const float2 mx = entry & NEEDS_MASK
                          ? k3_scores<true>(s, p, slope, qpos, k0, kms + stage * TK, lane)
                          : k3_scores<false>(s, p, slope, qpos, k0, kms + stage * TK, lane);
    // online softmax: m, l and alpha per row (a quad's values); O is
    // rescaled in its registers and P·V accumulates into it (FA2)
    const float m_new[2] = {fmaxf(m[0], mx.x), fmaxf(m[1], mx.y)};
    const float alpha[2] = {expf(m[0] - m_new[0]), expf(m[1] - m_new[1])};
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int c = 0; c < 8; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[c][e] = __expf(s[c][e] - m_new[e >> 1]);
        sum[e >> 1] += s[c][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = __fadd_rn(__fmul_rn(l[r], alpha[r]), quad_sum(sum[r]));
      m[r] = m_new[r];
    }
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      o[c][0] = __fmul_rn(o[c][0], alpha[0]), o[c][1] = __fmul_rn(o[c][1], alpha[0]);
      o[c][2] = __fmul_rn(o[c][2], alpha[1]), o[c][3] = __fmul_rn(o[c][3], alpha[1]);
    }
    uint32_t pf[4][4];
    p_frags(pf, s);  // p rounded to bf16 before P·V, as the TPU kernel casts p to v's dtype
    pv_tile<D>(o, pf, Vs + stage * TK * LD, lane);
    __syncthreads();  // stage i & 1 consumed before the next iteration refills it
  }
  cp_async_wait<0>();
  __syncthreads();

  // out = acc / l (l == 0 → 1) through the (free) Q tile; lse = m + log(l)
  const float l0 = l[0] == 0.f ? 1.f : l[0], l1 = l[1] == 0.f ? 1.f : l[1];
  stage_rows<D>(Qs + warp * WR * LD, o, l0, l1, lane);
  if ((lane & 3) == 0) {
    float* lse = p.lse + ((long long)b * p.H + h) * p.T;
    lse[qpos[0]] = __fadd_rn(m[0], logf(l0));
    lse[qpos[1]] = __fadd_rn(m[1], logf(l1));
  }
  __syncthreads();
  store_tile<D>(static_cast<bf16*>(p.o) + b * p.ob + h * p.oh, p.ot, Qs, q0, p.T);
}

// K3's fp32 path: flash_fwd_bf16's blocks, sub-tile list and online
// softmax, with fp32 tiles of row stride D + 4 and every product in 3xTF32
// (mma_tf32.cuh). Per sub-tile, oldest cp.async group first: K (issued a
// sub-tile ahead, into the other of two stages, with its key-mask values),
// V (issued after the previous sub-tile's P·V, one stage) and the next K.
// Each thread splits the K and V chunks it copied once they land: the big
// part in place, the small part into Ksm or Vsm. Each warp splits its Q
// fragments from the shared Q tile at every k-step, as K1's tf32_kernel
// does: held split in registers across the walk (D more a thread), they
// spilled and cost 10 % at Dh 64 on the H100 (chip_variants.py
// k3_q_in_regs). P = exp(s − m_new) stays in the score registers,
// unrounded, as P·V's A fragments.
// At Dh 256 (GPT-J; SPLIT false) six tiles would take 400 KB of shared
// memory, so the block keeps three: Q, one K and one V sub-tile, unsplit;
// each warp splits the K and V values it reads (qk_part_3xtf32_unsplit,
// pv_part_3xtf32_unsplit: the same big and small parts as split_own_chunks
// stores, so the products are the same). K of sub-tile i + 1 is copied
// during sub-tile i's softmax and P·V, V of i + 1 during i + 1's scores:
// 200 KB, one block an SM.
template <int D>
__global__ void __launch_bounds__(NTHREADS, D <= 64 ? 2 : 1) flash_fwd_tf32(const Params p) {
  constexpr int LD = D + 4;
  constexpr bool SPLIT = D <= 128;
  static_assert(TQ == MMA_TILE && NTHREADS == MMA_THREADS, "mma_tf32.cuh's block shape");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);  // the Q tile, later the output staging tile
  float* Ks = Qs + TQ * LD;                        // two stages (big parts once split); unsplit, one
  float* Vs = Ks + (SPLIT ? 2 : 1) * TK * LD;      // one stage (big parts once split)
  float* Ksm = Vs + TK * LD;                       // small parts of the current K sub-tile (SPLIT)
  float* Vsm = Ksm + TK * LD;                      // small parts of the current V sub-tile (SPLIT)
  int* kms = reinterpret_cast<int*>(SPLIT ? Vsm + TK * LD : Ksm);  // two stages of TK key-mask values
  int* list = kms + 2 * TK;                                          // T / 64 sub-tile entries

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * TQ, h = blockIdx.y, b = blockIdx.z;
  const long long base = b * p.sb + h * p.sh;
  const float* qg = static_cast<const float*>(p.q) + base;
  const float* kg = static_cast<const float*>(p.k) + base;
  const float* vg = static_cast<const float*>(p.v) + base;
  const int* kmg = p.key_mask + (long long)b * p.T;
  const float slope = p.slopes != nullptr ? p.slopes[h] : 0.f;
  const int qpos[2] = {q0 + warp * WR + (lane >> 2), q0 + warp * WR + (lane >> 2) + 8};
  const float* qrows = Qs + warp * WR * LD;

  load_tile_async_f32<D>(Qs, qg, p.st, q0, p.T);
  const Walk walk(p, q0, kmg);
  const int n = subtile_list(list, walk, p, kmg);

  auto issue_k = [&](int i) {
    const int k0 = list[i] & ~NEEDS_MASK, stage = i & 1;
    load_tile_async_f32<D>(Ks + (SPLIT ? stage * TK * LD : 0), kg, p.st, k0, p.T);
    if (threadIdx.x < TK / 4) cp_async16(kms + stage * TK + 4 * threadIdx.x, kmg + k0 + 4 * threadIdx.x, true);
  };
  auto issue_v = [&](int i) { load_tile_async_f32<D>(Vs, vg, p.st, list[i] & ~NEEDS_MASK, p.T); };

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float o[D / 8][4];
#pragma unroll
  for (int c = 0; c < D / 8; ++c) o[c][0] = o[c][1] = o[c][2] = o[c][3] = 0.f;
  if constexpr (SPLIT) {
    if (n > 0) {
      issue_k(0);
      issue_v(0);
    }
    cp_async_commit();  // with the Q tile's copies
  } else {
    if (n > 0) issue_k(0);
    cp_async_commit();  // with the Q tile's copies
    if (n > 0) issue_v(0);
    cp_async_commit();
  }
  for (int i = 0; i < n; ++i) {
    const int entry = list[i], k0 = entry & ~NEEDS_MASK, stage = i & 1;
    float* kb = Ks + (SPLIT ? stage * TK * LD : 0);
    if constexpr (SPLIT) {
      if (i + 1 < n) issue_k(i + 1);  // the next K sub-tile's copy overlaps this one's products
      cp_async_commit();
      if (i == 0)
        cp_async_wait<1>();
      else
        cp_async_wait<2>();
      split_own_chunks<D>(kb, Ksm);
      __syncthreads();  // K of sub-tile i (and at i = 0 the Q tile) landed and split
    } else {
      cp_async_wait<1>();
      __syncthreads();  // K of sub-tile i (and at i = 0 the Q tile) landed; V of i may be in flight
    }
    float s[8][4];
#pragma unroll
    for (int c = 0; c < 8; ++c) s[c][0] = s[c][1] = s[c][2] = s[c][3] = 0.f;
    if constexpr (SPLIT) {
#pragma unroll
      for (int d = 0; d < D / 8; ++d) {
        uint32_t ab[4], as[4];
        a_frag_3xtf32<D>(ab, as, qrows, d, lane);  // Q's fragments, split at every k-step
        qk_step_3xtf32<D>(s, ab, as, kb, Ksm, d, lane);
      }
    } else {
#pragma unroll 4
      for (int d = 0; d < D / 8; ++d) {
        uint32_t ab[4], as[4];
        a_frag_3xtf32<D>(ab, as, qrows, d, lane);
        qk_part_3xtf32_unsplit<D, 8>(s, ab, as, kb, d, lane);
      }
      __syncthreads();  // every warp has read the K sub-tile
      if (i + 1 < n) issue_k(i + 1);
      cp_async_commit();
    }
    const float2 mx = entry & NEEDS_MASK
                          ? k3_scores<true>(s, p, slope, qpos, k0, kms + stage * TK, lane)
                          : k3_scores<false>(s, p, slope, qpos, k0, kms + stage * TK, lane);
    // online softmax as flash_fwd_bf16's, with P left in fp32
    const float m_new[2] = {fmaxf(m[0], mx.x), fmaxf(m[1], mx.y)};
    const float alpha[2] = {expf(m[0] - m_new[0]), expf(m[1] - m_new[1])};
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int c = 0; c < 8; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[c][e] = expf(s[c][e] - m_new[e >> 1]);
        sum[e >> 1] += s[c][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = __fadd_rn(__fmul_rn(l[r], alpha[r]), quad_sum(sum[r]));
      m[r] = m_new[r];
    }
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      o[c][0] = __fmul_rn(o[c][0], alpha[0]), o[c][1] = __fmul_rn(o[c][1], alpha[0]);
      o[c][2] = __fmul_rn(o[c][2], alpha[1]), o[c][3] = __fmul_rn(o[c][3], alpha[1]);
    }
    cp_async_wait<1>();
    if constexpr (SPLIT) {
      split_own_chunks<D>(Vs, Vsm);
      __syncthreads();  // V of sub-tile i landed and split
      pv_tile_3xtf32<D>(o, s, Vs, Vsm, lane);
    } else {
      __syncthreads();  // V of sub-tile i landed; K of i + 1 may be in flight
      pv_part_3xtf32_unsplit<D, 8>(o, s, Vs, lane);
    }
    __syncthreads();  // V (split: and Ksm and the K stage) consumed
    if (i + 1 < n) issue_v(i + 1);
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncthreads();

  // out = acc / l (l == 0 → 1) through the (free) Q tile; lse = m + log(l)
  const float l0 = l[0] == 0.f ? 1.f : l[0], l1 = l[1] == 0.f ? 1.f : l[1];
#pragma unroll
  for (int c = 0; c < D / 8; ++c) {
    o[c][0] = o[c][0] / l0, o[c][1] = o[c][1] / l0;
    o[c][2] = o[c][2] / l1, o[c][3] = o[c][3] / l1;
  }
  stage_rows_f32<D>(Qs + warp * WR * LD, o, lane);
  if ((lane & 3) == 0) {
    float* lse = p.lse + ((long long)b * p.H + h) * p.T;
    lse[qpos[0]] = __fadd_rn(m[0], logf(l0));
    lse[qpos[1]] = __fadd_rn(m[1], logf(l1));
  }
  __syncthreads();
  store_tile_f32<D>(static_cast<float*>(p.o) + b * p.ob + h * p.oh, p.ot, Qs, q0, p.T);
}

template <int D>
size_t bf16_smem(int T) {
  return mma_tiles_bytes<D>() + sizeof(int) * (2 * TK + T / TK);
}

template <int D>
size_t tf32_smem(int T) {
  const size_t tiles = D > 128 ? sizeof(float) * 3 * TQ * (D + 4) : tf32_tiles_bytes<D>();
  return tiles + sizeof(int) * (2 * TK + T / TK);
}

template <typename KernelT>
cudaError_t launch(KernelT kernel, size_t smem, dim3 grid, cudaStream_t st, const Params& p) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, NTHREADS, smem, st>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch(int is_bf16, dim3 grid, cudaStream_t st, const Params& p) {
  return is_bf16 ? launch(flash_fwd_bf16<D>, bf16_smem<D>(p.T), grid, st, p)
                 : launch(flash_fwd_tf32<D>, tf32_smem<D>(p.T), grid, st, p);
}

}  // namespace

// C entry point, bound with ctypes. q/k/v/out: (B, H, T, Dh) fp32 (is_bf16 =
// 0) or bf16 (is_bf16 = 1) with element strides (sb, sh, st) for q, k and v
// and (ob, oh, ot) for out, unit stride along Dh, rows 16-byte aligned. lse:
// (B, H, T) fp32. key_mask: (B, T) int32. slopes: (H,) fp32 or null (no
// ALiBi). T must divide by block_q and block_kv, and both by 64. Returns the
// launch's cudaError_t; 0 means launched.
extern "C" int sgpt_flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                        float* lse, const int* key_mask, const float* slopes,
                                        int B, int H, int T, int Dh, long long sb, long long sh,
                                        long long st, long long ob, long long oh, long long ot,
                                        float scale, int window, int block_q, int block_kv,
                                        int is_bf16, void* stream) {
  if (B < 1 || H < 1 || T < 1 || B > 65535 || H > 65535 || block_q < TQ || block_kv < TK ||
      block_q % TQ || block_kv % TK || T % block_q || T % block_kv)
    return (int)cudaErrorInvalidValue;
  const Params p{q, k, v, out, lse, key_mask, slopes, H, T, sb, sh, st, ob, oh, ot,
                 scale, window > 0 ? window : 0, block_q, block_kv};
  const dim3 grid(T / TQ, H, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (Dh) {
    case 16: return (int)dispatch<16>(is_bf16, grid, s, p);
    case 32: return (int)dispatch<32>(is_bf16, grid, s, p);
    case 64: return (int)dispatch<64>(is_bf16, grid, s, p);
    case 128: return (int)dispatch<128>(is_bf16, grid, s, p);
    case 256: return (int)dispatch<256>(is_bf16, grid, s, p);
    default: return (int)cudaErrorInvalidValue;
  }
}
