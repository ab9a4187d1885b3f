// Causal flash attention backward for Hopper (compiled for sm_90a): K4a, K4b.
//
// Replaces the two TPU kernels of sgpt_tpu/ops/pallas/flash_attention.py's
// flash_attention_bwd, the backward of every attention layer when GPT-Neo,
// GPT-J or BLOOM trains with use_flash at T % 128 == 0 (the long-context
// training path):
//   * K4a (flash_bwd_dq_tf32, bf16 flash_bwd_dq; at Dh 256
//     flash_bwd_dq_wide) replaces :231 _flash_bwd_dq_kernel;
//   * K4b (flash_bwd_dkv_tf32, bf16 flash_bwd_dkv; at Dh 256
//     flash_bwd_dkv_wide) replaces :276 _flash_bwd_dkv_kernel.
// They compute what the TPU kernels compute, in fp32 whatever the input
// dtype: s = q·k (× scale, + slope·kpos, rounded as the forward: the score()
// of flash_attention.cuh), p = where(mask, exp(s − lse), 0) with the where
// outside the exp (a fully masked row carries lse = -1e30; none of its pairs
// reaches a product), dp = dO·vᵀ, ds = p∘(dp − D) with D = rowsum(dO∘O);
// dQ = Σ ds·K·scale over keys, dV = Σ pᵀ·dO and dK = Σ dsᵀ·Q·scale over
// queries, written in the input dtype. D is not a separate pass: K4a
// computes it for its 64 rows in its prologue (from dO and O) and writes it
// to a (B, H, T) fp32 buffer that K4b reads.
//
// Tiles. The backward masks every pair exactly, so unlike the forward (K3)
// it needs no TPU tile set: each block walks the key (K4a) or query (K4b)
// tiles that hold a pair in causal and window range, and K4a skips a key
// tile whose keys are all padded. A skipped tile has p = 0 on every pair: it
// adds nothing.
//   * K4a: one block per (64 query rows, head, batch row), dQ accumulated in
//     registers over the key tiles the rows reach.
//   * K4b: one block per (64 keys, head, batch row), dK and dV accumulated in
//     registers over the query tiles that reach the keys. Two kernels and
//     no atomics, split as the TPU splits them: the result is deterministic.
//
// Layout: q, k, v, out and dO are (B, H, T, Dh) with any strides whose Dh
// axis is contiguous and whose rows are 16-byte aligned (the decoder's
// (B, T, H·Dh) projection views); dq, dk and dv are written with q's strides,
// so the head transposes copy nothing on either side of the call.
//
// What bounds it on this card: at the long-context training shape (B=8,
// T=2048, H=12, Dh=64, fp32) a global layer needs 6·Dh FLOP a valid pair in
// K4a (S, dP, dQ: 68.0 GFLOP of chip_smoke.py's pairs) and 8·Dh in K4b (S,
// dP, dV, dK: 90.6 GFLOP), against ~0.08 ms of bytes: operations bind. The fp32
// kernels run every product in 3xTF32 on mma.sync m16n8k8 (mma_tf32.cuh), so
// their bound is 3 × their operations over the 495 TFLOP/s TF32 peak: 0.412
// ms for K4a and 0.549 ms for K4b at the shape above, where the CUDA cores'
// 67 TFLOP/s would take 1.01 and 1.35 ms.
//
// bf16 K4a and K4b (flash_bwd_dq, flash_bwd_dkv) are register tiles on the
// CUDA cores in exact fp32: 256 threads as a 16 × 16 grid, each owning a
// 4 × 4 block of a 64 × 64 score tile (rows and columns in steps of 16, so a
// warp's 16-byte shared loads hit distinct banks) and 4 rows × Dh/16
// columns of each accumulator; 16 fp32 FMAs per two 16-byte shared loads.
// Shared memory holds four 64 × Dh fp32 tiles and one (K4a) or two (K4b)
// 64 × 64 score tiles; bf16 inputs are widened to fp32 on their way into
// shared memory. No main path runs them: long-context training is fp32.
//
// fp32 K4b (flash_bwd_dkv_tf32) and fp32 K4a (flash_bwd_dq_tf32) run on the
// tensor cores. What the CUDA-core kernels lost, and what these do about it:
//   1. fp32 FMAs at 43 % of the CUDA cores' peak, tensor cores idle. K4b:
//      Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ with K and V as A and Q and dO as B, then
//      dV += Pᵀ·dO and dK += dSᵀ·Q with P and dS straight from the
//      accumulator registers as A (no shared tile, no barrier). Each warp
//      owns 16 keys and keeps their dK and dV in registers; it takes each
//      query tile 16 queries at a time (Sᵀ and dPᵀ in 16 registers: 32 at a
//      time spilled and ran 7 % slower on the H100, chip_variants.py
//      k4b_n4). K4a is the same turned around: S = Q·Kᵀ and dP = dO·Vᵀ with
//      Q and dO as A and K and V as B, then dQ += dS·K with dS from the
//      accumulator registers as A; each warp owns 16 query rows and keeps
//      their dQ in registers, and takes each 32-key tile whole at Dh ≤ 64
//      (S and dP in 32 registers: 2-3 % faster than 16 keys at a time on the
//      H100, chip_variants.py k4a_n2) and 16 keys at a time at Dh 128.
//   2. No prefetch: K4b's query tiles (32 rows of Q and dO with their lse
//      and D) and K4a's key tiles (32 rows of K and V with their key-mask
//      values) stream through a two-stage cp.async ring, the next tile
//      copying while this one computes, one barrier a tile. Each thread
//      splits the chunks it copied into big and small parts in shared memory
//      once they land; the A fragments (K and V in K4b, Q and dO in K4a) are
//      split from fp32 tiles at each k-step. K4a lists the key tiles that
//      hold a live key before its walk and copies only those, and copies O
//      into the ring's second stage with Q and dO to compute D.
//   3. Shared loads: tiles of row stride Dh + 8 floats, and fragments read 8
//      bytes a lane, conflict-free: each k-step of the scores takes the Dh
//      columns in the order 2t, 2t + 1 (slots t and t + 4 of lane t), and
//      the B rows of each 8-row n-tile of the scores are permuted (column c
//      is row c ^ (c >> 2 & 1)) so that the B rows π(2t) and π(2t + 1) of
//      the accumulating products fall in distinct banks; their Dh columns are
//      paired (n-tile 2m, 2m + 1 at columns 16m + 2g, + 1), so a lane's
//      output rows leave as 16-byte stores.
//   4. Causal imbalance: blocks launch with the walk's own block slowest
//      over all heads and batch rows, the longest walks first (K4b: the
//      first key block, which every query sees; K4a: the last query block,
//      which sees every key).
// Term order: the scores take K3's (q_s·k_b, q_b·k_s, q_b·k_b:
// mma_3xtf32_swapped with K and V as A in K4b, mma_3xtf32 with Q and dO as
// A in K4a), the accumulating products mma_3xtf32's (p_s·g_b, p_b·g_s,
// p_b·g_b; ds_s·k_b, ds_b·k_s, ds_b·k_b), each 8-deep step into a fresh
// accumulator. No atomics: two launches give the same bits. fp32 K4a still
// computes D = rowsum(dO∘O) in its prologue with the CUDA-core kernel's
// arithmetic (one warp a row, lanes across Dh), so the D that K4b reads does
// not depend on which K4a ran. The CPU emulations are `_k4a_tf32` and
// `_k4b_tf32` in tests/test_torch_flash_backward.py; chip_variants.py's
// k4a_* and k4b_* variants time the alternatives (one stage, other tile
// rows and chunk widths, grid order) as substitutions of this source.
//
// Dh 256 (GPT-J's head size), fp32 and bf16: flash_bwd_dq_wide (K4a) and
// flash_bwd_dkv_wide (K4b), the tensor-core kernels above with three
// changes, each against a wall that Dh 256 hits:
//   * Registers. A warp's dK and dV for 16 keys over 256 columns would be
//     256 fp32 registers a thread. K4b takes 8 warps a block: warps w and
//     w + 4 own the same 16 keys, each computes their Sᵀ and dPᵀ over all of
//     Dh and keeps one half of the dK/dV columns (128 registers). The
//     recomputed Sᵀ and dPᵀ cost +50 % of K4b's operations (12·Dh a pair
//     instead of 8·Dh), where keeping the accumulators in shared memory
//     would leave no room for the tiles, two passes over the column halves
//     would read K, V, Q and dO twice, and splitting the score sums between
//     two warps would change their order against the CPU emulation. K4a's
//     dQ (16 rows × 256) is 128 registers a thread, as K3's output at 256:
//     4 warps, Q's and dO's A fragments read from their shared tiles at each
//     k-step.
//   * Shared memory. The Dh ≤ 128 plan (split big and small parts stored
//     for every streamed tile) is 270 KB at 256. The wide kernels keep every
//     tile unsplit in the input dtype and split each value where a lane
//     reads it (the parts split_rows would store, so the same products):
//     K4b holds K and V (64 rows of 264 fp32, 135 KB) and two stages of 16
//     query rows of Q and dO with their lse and D (68 KB); K4a holds Q and
//     dO (135 KB) and two stages of 16 keys of K and V, walking each listed
//     32-key tile in two halves (68 KB); 203 KB in fp32, one block an SM.
//   * bf16. The CUDA-core pair's four 64 × (D + 4) fp32 tiles are 266 KB at
//     256; the wide kernels take bf16 tiles as they are (cp.async copies the
//     raw bytes), widen each value to fp32 where it is read and run the same
//     3xTF32 products (a bf16 value's small part is 0).
// The sums keep the Dh ≤ 128 kernels' order: `_k4a_tf32` and `_k4b_tf32`
// emulate them at 256 too. Bounds at GPT-J's long-context cell (B=4,
// T=2048, H=16, global): 6·Dh FLOP a pair in K4a and 8·Dh in K4b (12·Dh
// issued), 3 × those at the TF32 peak ≈ 1.25 and 1.67 ms.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "flash_attention.cuh"
#include "mma_tf32.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int NT = 256;        // threads: a 16 × 16 grid
constexpr int LDT = SUB + 4;   // row stride of the 64 × 64 fp32 score tiles

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* g;        // dO
  const void* o;        // the forward's output (K4a only)
  const float* lse;     // (B, H, T) contiguous
  float* dsum;          // D = rowsum(dO∘O), (B, H, T): written by K4a, read by K4b
  void* dq;
  void* dk;
  void* dv;
  const int* key_mask;  // (B, T) contiguous
  const float* slopes;  // (H,) or null: no ALiBi
  int H, T;
  long long sb, sh, st;  // q/k/v strides (elements) of the batch, head and time axes
  long long gb, gh, gt;  // dO strides
  long long ob, oh, ot;  // out strides
  long long rb, rh, rt;  // dq/dk/dv strides
  float scale;
  int window;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) { *p = __float2bfloat16(x); }

// rows [0, 64) of one head starting at src (row stride st elements, D
// contiguous values each) → fp32 shared tile dst (row stride D + 4), one
// 16-byte load at a time.
template <typename T, int D>
__device__ __forceinline__ void load_rows(float* dst, const T* src, long long st) {
  constexpr int LD = D + 4;
  constexpr int VEC = 16 / sizeof(T);  // 4 fp32 or 8 bf16
  constexpr int NV = D / VEC;
  for (int e = threadIdx.x; e < SUB * NV; e += NT) {
    const int r = e / NV, c = (e - r * NV) * VEC;
    const uint4 raw = *reinterpret_cast<const uint4*>(src + r * st + c);
    const T* x = reinterpret_cast<const T*>(&raw);
    float* d = dst + r * LD + c;
#pragma unroll
    for (int i = 0; i < VEC; i += 4)
      *reinterpret_cast<float4*>(d + i) =
          make_float4(to_f(x[i]), to_f(x[i + 1]), to_f(x[i + 2]), to_f(x[i + 3]));
  }
}

// A thread's columns of a 64 × D tile: V consecutive columns at tx·V,
// repeated every 16·V columns, D / 16 in all.
template <int D>
struct Cols {
  static constexpr int V = D >= 64 ? 4 : D / 16;  // 4, 2 or 1
  static constexpr int N = D / 16;
  __device__ static int col(int tx, int n) { return (n / V) * 16 * V + tx * V + n % V; }
};

// acc[i][j] += Σ_d A[ty + 16 i][d] · B[tx + 16 j][d] over two 64 × D fp32
// tiles (row stride D + 4): a thread's 4 × 4 share of A·Bᵀ, d in order.
template <int D>
__device__ __forceinline__ void mm_nt(float (&acc)[4][4], const float* A, const float* B,
                                      int ty, int tx) {
  constexpr int LD = D + 4;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(A + (ty + 16 * i) * LD + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = *reinterpret_cast<const float4*>(B + (tx + 16 * j) * LD + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = acc[i][j];
        x = fmaf(a[i].x, b[j].x, x);
        x = fmaf(a[i].y, b[j].y, x);
        x = fmaf(a[i].z, b[j].z, x);
        acc[i][j] = fmaf(a[i].w, b[j].w, x);
      }
  }
}

// acc[i][n] += Σ_k A[ty + 16 i][k] · B[k][col(n)]: a thread's share of the
// 64 × 64 tile A (row stride LDT) times the 64 × D tile B (row stride D + 4).
template <int D>
__device__ __forceinline__ void mm_nn(float (&acc)[4][D / 16], const float* A, const float* B,
                                      int ty, int tx) {
  using C = Cols<D>;
  constexpr int LD = D + 4;
#pragma unroll 2
  for (int k = 0; k < SUB; k += 4) {
    float a[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 t = *reinterpret_cast<const float4*>(A + (ty + 16 * i) * LDT + k);
      a[i][0] = t.x, a[i][1] = t.y, a[i][2] = t.z, a[i][3] = t.w;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float b[C::N];
      const float* row = B + (k + kk) * LD + tx * C::V;
#pragma unroll
      for (int c = 0; c < C::N / C::V; ++c) {
        const float* src = row + c * 16 * C::V;
        if constexpr (C::V == 4) {
          const float4 t = *reinterpret_cast<const float4*>(src);
          b[4 * c] = t.x, b[4 * c + 1] = t.y, b[4 * c + 2] = t.z, b[4 * c + 3] = t.w;
        } else if constexpr (C::V == 2) {
          const float2 t = *reinterpret_cast<const float2*>(src);
          b[2 * c] = t.x, b[2 * c + 1] = t.y;
        } else {
          b[c] = src[0];
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int n = 0; n < C::N; ++n) acc[i][n] = fmaf(a[i][kk], b[n], acc[i][n]);
    }
  }
}

// rows r0 + ty + 16 i of one head's dq, dk or dv (strides rt) = acc · mul
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* dst, long long rt, int r0,
                                           const float (&acc)[4][D / 16], float mul, int ty,
                                           int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    T* row = dst + (r0 + ty + 16 * i) * rt;
#pragma unroll
    for (int n = 0; n < D / 16; ++n) store(row + Cols<D>::col(tx, n), acc[i][n] * mul);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_bwd_dq(const Params p) {
  constexpr int LD = D + 4;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;              // 64 × LD: this block's query rows
  float* Gs = Qs + SUB * LD;     // their dO rows
  float* Ks = Gs + SUB * LD;     // a key sub-tile (first the O rows, for D)
  float* Vs = Ks + SUB * LD;     // its values
  float* Ss = Vs + SUB * LD;     // 64 × LDT: dS
  float* lse_s = Ss + SUB * LDT;
  float* d_s = lse_s + SUB;
  int* km_s = reinterpret_cast<int*>(d_s + SUB);

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.x * SUB, h = blockIdx.y, b = blockIdx.z;
  const long long base = b * p.sb + h * p.sh;
  const T* kg = static_cast<const T*>(p.k) + base;
  const T* vg = static_cast<const T*>(p.v) + base;
  const int* kmg = p.key_mask + (long long)b * p.T;
  const long long row0 = ((long long)b * p.H + h) * p.T + q0;  // into lse and dsum
  const bool alibi = p.slopes != nullptr;
  const float slope = alibi ? p.slopes[h] : 0.f;

  load_rows<T, D>(Qs, static_cast<const T*>(p.q) + base + q0 * p.st, p.st);
  load_rows<T, D>(Gs, static_cast<const T*>(p.g) + b * p.gb + h * p.gh + q0 * p.gt, p.gt);
  load_rows<T, D>(Ks, static_cast<const T*>(p.o) + b * p.ob + h * p.oh + q0 * p.ot, p.ot);
  if (tid < SUB) lse_s[tid] = p.lse[row0 + tid];
  __syncthreads();
  {  // D = rowsum(dO∘O): one warp per row, lanes across Dh
    const int warp = tid / 32, lane = tid % 32;
    for (int r = warp; r < SUB; r += NT / 32) {
      float x = 0.f;
      for (int c = lane; c < D; c += 32) x = fmaf(Gs[r * LD + c], Ks[r * LD + c], x);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
      if (lane == 0) {
        d_s[r] = x;
        p.dsum[row0 + r] = x;
      }
    }
  }

  float acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int n = 0; n < D / 16; ++n) acc[i][n] = 0.f;
  for (int k0 = 0; k0 <= q0; k0 += SUB) {
    if (!subtile_in_range(q0, k0, p.window)) continue;  // before the window
    const int km = tid < SUB ? kmg[k0 + tid] : 0;
    // barrier: D done / the previous sub-tile's K and dS consumed
    if (!__syncthreads_or(km != 0)) continue;  // all 64 keys padded: p = 0
    load_rows<T, D>(Ks, kg + k0 * p.st, p.st);
    load_rows<T, D>(Vs, vg + k0 * p.st, p.st);
    if (tid < SUB) km_s[tid] = km;
    __syncthreads();
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    mm_nt<D>(s, Qs, Ks, ty, tx);   // S = Q·Kᵀ
    mm_nt<D>(dp, Gs, Vs, ty, tx);  // dP = dO·Vᵀ
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j, kpos = k0 + c;
        float ds = 0.f;
        if ((km_s[c] != 0) & in_range(q0 + r, kpos, p.window)) {
          const float pr = expf(score(s[i][j], p.scale, alibi, slope, kpos) - lse_s[r]);
          ds = pr * (dp[i][j] - d_s[r]);
        }
        Ss[r * LDT + c] = ds;
      }
    __syncthreads();
    mm_nn<D>(acc, Ss, Ks, ty, tx);  // dQ += dS·K
  }
  store_rows<T, D>(static_cast<T*>(p.dq) + b * p.rb + h * p.rh, p.rt, q0, acc, p.scale, ty, tx);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_bwd_dkv(const Params p) {
  constexpr int LD = D + 4;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;              // 64 × LD: this block's keys
  float* Vs = Ks + SUB * LD;     // their values
  float* Qs = Vs + SUB * LD;     // a query sub-tile
  float* Gs = Qs + SUB * LD;     // its dO rows
  float* Ps = Gs + SUB * LD;     // 64 × LDT: Pᵀ (rows: keys)
  float* Ss = Ps + SUB * LDT;    // 64 × LDT: dSᵀ
  float* lse_s = Ss + SUB * LDT;
  float* d_s = lse_s + SUB;
  int* km_s = reinterpret_cast<int*>(d_s + SUB);

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int k0 = blockIdx.x * SUB, h = blockIdx.y, b = blockIdx.z;
  const long long base = b * p.sb + h * p.sh;
  const T* qg = static_cast<const T*>(p.q) + base;
  const T* gg = static_cast<const T*>(p.g) + b * p.gb + h * p.gh;
  const long long rows = ((long long)b * p.H + h) * p.T;  // into lse and dsum
  const bool alibi = p.slopes != nullptr;
  const float slope = alibi ? p.slopes[h] : 0.f;

  float adk[4][D / 16], adv[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int n = 0; n < D / 16; ++n) adk[i][n] = adv[i][n] = 0.f;
  const int km = tid < SUB ? p.key_mask[(long long)b * p.T + k0 + tid] : 0;
  if (tid < SUB) km_s[tid] = km;
  if (__syncthreads_or(km != 0)) {  // else all 64 keys padded: dK = dV = 0
    load_rows<T, D>(Ks, static_cast<const T*>(p.k) + base + k0 * p.st, p.st);
    load_rows<T, D>(Vs, static_cast<const T*>(p.v) + base + k0 * p.st, p.st);
    for (int q0 = k0; q0 < p.T && subtile_in_range(q0, k0, p.window); q0 += SUB) {
      __syncthreads();  // K, V written / the previous sub-tile consumed
      load_rows<T, D>(Qs, qg + q0 * p.st, p.st);
      load_rows<T, D>(Gs, gg + q0 * p.gt, p.gt);
      if (tid < SUB) {
        lse_s[tid] = p.lse[rows + q0 + tid];
        d_s[tid] = p.dsum[rows + q0 + tid];
      }
      __syncthreads();
      float st[4][4], dpt[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) st[i][j] = dpt[i][j] = 0.f;
      mm_nt<D>(st, Ks, Qs, ty, tx);   // Sᵀ = K·Qᵀ
      mm_nt<D>(dpt, Vs, Gs, ty, tx);  // dPᵀ = V·dOᵀ
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = ty + 16 * i, r = tx + 16 * j, kpos = k0 + c;  // key c, query r
          float pr = 0.f, ds = 0.f;
          if ((km_s[c] != 0) & in_range(q0 + r, kpos, p.window)) {
            pr = expf(score(st[i][j], p.scale, alibi, slope, kpos) - lse_s[r]);
            ds = pr * (dpt[i][j] - d_s[r]);
          }
          Ps[c * LDT + r] = pr;
          Ss[c * LDT + r] = ds;
        }
      __syncthreads();
      mm_nn<D>(adv, Ps, Gs, ty, tx);  // dV += Pᵀ·dO
      mm_nn<D>(adk, Ss, Qs, ty, tx);  // dK += dSᵀ·Q
    }
  }
  const long long out = b * p.rb + h * p.rh;
  store_rows<T, D>(static_cast<T*>(p.dk) + out, p.rt, k0, adk, p.scale, ty, tx);
  store_rows<T, D>(static_cast<T*>(p.dv) + out, p.rt, k0, adv, 1.f, ty, tx);
}

// ---- fp32 K4b on the tensor cores (see the note at the top) ----

// The query ring's tiles and the warps' share of them
constexpr int DKV_QT = 32;  // query rows of a stage (two stages)
constexpr int DKV_N = 2;    // 8-query n-tiles a warp takes at once
static_assert(SUB % DKV_QT == 0 && DKV_QT % (8 * DKV_N) == 0, "whole n-tiles a stage");
static_assert(MMA_THREADS == 128 && MMA_TILE == SUB, "4 warps of 16 keys");

// Shared memory of flash_bwd_dkv_tf32: the K and V tiles, then two stages
// of Q's and dO's big and small parts with the tile's lse and D. Tile rows
// of D + 8 floats: ≡ 8 (mod 32) words (24 at D = 16), so rows whose index
// differs mod 4 start 8 banks apart.
template <int D>
struct DkvSmem {
  static constexpr int LD = D + 8;
  static constexpr int KV = 2 * SUB * LD;
  static constexpr int STAGE = 4 * DKV_QT * LD + 2 * DKV_QT;
  static constexpr size_t BYTES = sizeof(float) * ((size_t)KV + 2 * (size_t)STAGE);
};

// rows [0, R) of one head from src (row stride `stride` elements) → a shared
// tile of row stride D + 8 in the input dtype, 16 bytes a copy, by NTH
// threads; the caller commits the group
template <int D, int R, int NTH = MMA_THREADS, typename T>
__device__ __forceinline__ void copy_rows_async(T* dst, const T* src, long long stride) {
  constexpr int E = 16 / sizeof(T), C = D / E, LD = D + 8;
  static_assert(R * C % NTH == 0, "whole chunks a thread");
#pragma unroll
  for (int i = 0; i < R * C / NTH; ++i) {
    const int e = threadIdx.x + i * NTH, r = e / C, c = (e - r * C) * E;
    cp_async16(dst + r * LD + c, src + r * stride + c, true);
  }
}

// the chunks this thread copied with copy_rows_async<D, R>, once landed:
// x → big in place and small into the same place of `small`
template <int D, int R>
__device__ __forceinline__ void split_rows(float* tile, float* small) {
  constexpr int C = D / 4, LD = D + 8;
#pragma unroll
  for (int i = 0; i < (R * C + MMA_THREADS - 1) / MMA_THREADS; ++i) {
    const int e = threadIdx.x + i * MMA_THREADS, r = e / C, at = r * LD + (e - r * C) * 4;
    if (R * C % MMA_THREADS != 0 && e >= R * C) break;
    const float4 v = *reinterpret_cast<const float4*>(tile + at);
    uint4 big, sm;
    split_tf32(v.x, big.x, sm.x);
    split_tf32(v.y, big.y, sm.y);
    split_tf32(v.z, big.z, sm.z);
    split_tf32(v.w, big.w, sm.w);
    *reinterpret_cast<uint4*>(tile + at) = big;
    *reinterpret_cast<uint4*>(small + at) = sm;
  }
}

// the split A fragments of k-step d of warp w's 16 rows of the first
// (which = 0) or second (which = 1) of two 64-row tiles (K4b: K and V; K4a:
// Q and dO): slot t is column 8d + 2t, slot t + 4 column 8d + 2t + 1; one
// 8-byte load a row from the tiles, then a split
template <int D>
__device__ __forceinline__ void kv_frag(uint32_t (&big)[4], uint32_t (&small)[4],
                                        const float* kv, int which, int w, int lane, int d) {
  constexpr int LD = D + 8;
  const float* at = kv + (which * SUB + w * 16 + (lane >> 2)) * LD + 8 * d + 2 * (lane & 3);
  const float2 lo = *reinterpret_cast<const float2*>(at);
  const float2 hi = *reinterpret_cast<const float2*>(at + 8 * LD);
  split_tf32(lo.x, big[0], small[0]);
  split_tf32(hi.x, big[1], small[1]);
  split_tf32(lo.y, big[2], small[2]);
  split_tf32(hi.y, big[3], small[3]);
}

// Scores (16 rows x 8N) += A · Bᵀ over k-step d, B the split rows of the
// chunk (row stride D + 8; K4b: Sᵀ with Q or dO rows, K4a: S with K or V
// rows): n-tile n's column g is B row 8n + π(g), π(g) = g ^ (g >> 2 & 1);
// the products in K3's term order, which is mma_3xtf32_swapped's when K or
// V is A (SWAPPED, K4b) and mma_3xtf32's when Q or dO is (K4a)
template <int D, int N, bool SWAPPED>
__device__ __forceinline__ void st_step(float (&s)[N][4], const uint32_t (&ab)[4],
                                        const uint32_t (&as)[4], const float* big,
                                        const float* small, int d, int g, int t) {
  constexpr int LD = D + 8;
  const int at = (g ^ (g >> 2 & 1)) * LD + 8 * d + 2 * t;
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const uint2 b = *reinterpret_cast<const uint2*>(big + at + 8 * n * LD);
    const uint2 sm = *reinterpret_cast<const uint2*>(small + at + 8 * n * LD);
    if (SWAPPED)
      mma_3xtf32_swapped(s[n], ab, as, b.x, b.y, sm.x, sm.y);
    else
      mma_3xtf32(s[n], ab, as, b.x, b.y, sm.x, sm.y);
  }
}

// acc (16 rows x D) += X (16 rows x 8N, fp32 in st_step's accumulator
// layout) · B (the split rows of the chunk; K4b: Q or dO, K4a: K): k-step
// j's slot t is B row 8j + π(2t), slot t + 4 row 8j + π(2t + 1), so X's
// registers are the A fragment as they stand; acc's n-tiles 2m and 2m + 1
// hold columns 16m + 2g and 16m + 2g + 1, one 8-byte load a row and pair
template <int D, int N>
__device__ __forceinline__ void acc_tile(float (&acc)[D / 8][4], const float (&x)[N][4],
                                         const float* big, const float* small, int g, int t) {
  constexpr int LD = D + 8;
  const int r0 = (2 * t + (t >> 1)) * LD + 2 * g, r1 = (2 * t + 1 - (t >> 1)) * LD + 2 * g;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    uint32_t ab[4], as[4];
    split_tf32(x[j][0], ab[0], as[0]);  // (key g, slot t)
    split_tf32(x[j][2], ab[1], as[1]);  // (key g + 8, slot t)
    split_tf32(x[j][1], ab[2], as[2]);  // (key g, slot t + 4)
    split_tf32(x[j][3], ab[3], as[3]);  // (key g + 8, slot t + 4)
#pragma unroll
    for (int m = 0; m < D / 16; ++m) {
      const int o = 8 * j * LD + 16 * m;
      const uint2 b0 = *reinterpret_cast<const uint2*>(big + r0 + o);
      const uint2 b1 = *reinterpret_cast<const uint2*>(big + r1 + o);
      const uint2 s0 = *reinterpret_cast<const uint2*>(small + r0 + o);
      const uint2 s1 = *reinterpret_cast<const uint2*>(small + r1 + o);
      mma_3xtf32(acc[2 * m], ab, as, b0.x, b1.x, s0.x, s1.x);
      mma_3xtf32(acc[2 * m + 1], ab, as, b0.y, b1.y, s0.y, s1.y);
    }
  }
}

// Sᵀ, dPᵀ → Pᵀ = where(mask, exp(s − lse), 0) and dSᵀ = where(mask,
// Pᵀ∘(dPᵀ − D), 0) in place, s the score as the forward rounds it. The
// lane's element (n, e) is key kpos[e >> 1] and chunk query qc + 8n + 2t +
// ((e & 1) ^ (t >> 1)). MASK = false: every pair is known to be allowed.
template <bool MASK, int N>
__device__ __forceinline__ void p_ds(float (&s)[N][4], float (&dp)[N][4], const Params& p,
                                     bool alibi, float slope, const int (&kpos)[2],
                                     const bool (&live)[2], int q0, int qc, const float* lse,
                                     const float* dd, int t) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1, qi = qc + 8 * n + 2 * t + ((e & 1) ^ (t >> 1));
      bool ok = true;
      if (MASK) ok = live[r] & in_range(q0 + qi, kpos[r], p.window);
      const float pr = expf(score(s[n][e], p.scale, alibi, slope, kpos[r]) - lse[qi]);
      s[n][e] = ok ? pr : 0.f;
      dp[n][e] = ok ? pr * (dp[n][e] - dd[qi]) : 0.f;
    }
}

// fp32 K4b (D = Dh in {16, 32, 64, 128}): one block of 4 warps per (64
// keys, head, batch row), key blocks in the slow grid order; warp w owns
// keys 16w .. 16w + 15 and keeps their dK and dV in registers while the
// query tiles in causal and window range stream through the ring.
template <int D>
__global__ void __launch_bounds__(MMA_THREADS, D <= 64 ? 2 : 1)
flash_bwd_dkv_tf32(const Params p) {
  using S = DkvSmem<D>;
  constexpr int LD = S::LD, QT = DKV_QT;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* kv = reinterpret_cast<float*>(smem_raw);  // the block's keys and values
  float* ring = kv + S::KV;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const int HB = gridDim.x / (p.T / SUB);  // heads × batch rows
  const int kb = blockIdx.x / HB, hb = blockIdx.x - kb * HB, h = hb % p.H, b = hb / p.H;
  const int k0 = kb * SUB, kr = warp * 16 + g;  // kr, kr + 8: the lane's keys in the block
  const long long base = b * p.sb + h * p.sh;
  const float* qg = static_cast<const float*>(p.q) + base;
  const float* gg = static_cast<const float*>(p.g) + b * p.gb + h * p.gh;
  const long long rows = ((long long)b * p.H + h) * p.T;  // into lse and dsum
  const int* kmg = p.key_mask + (long long)b * p.T + k0;
  const bool alibi = p.slopes != nullptr;
  const float slope = alibi ? p.slopes[h] : 0.f;
  const int kpos[2] = {k0 + kr, k0 + kr + 8};
  const bool live[2] = {kmg[kr] != 0, kmg[kr + 8] != 0};
  float* dk = static_cast<float*>(p.dk) + b * p.rb + h * p.rh;
  float* dv = static_cast<float*>(p.dv) + b * p.rb + h * p.rh;

  const bool key_live = threadIdx.x >= SUB || kmg[threadIdx.x] != 0;
  const bool all_live = __syncthreads_and(key_live);
  if (!__syncthreads_or(threadIdx.x < SUB && kmg[threadIdx.x] != 0)) {
    // all 64 keys padded: p = 0 on every pair, dK = dV = 0
    constexpr int C = D / 4;
    for (int e = threadIdx.x; e < SUB * C; e += MMA_THREADS) {
      const long long at = (k0 + e / C) * p.rt + (e % C) * 4;
      *reinterpret_cast<float4*>(dk + at) = make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(dv + at) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    return;
  }
  // the query tiles [k0 + i·QT, + QT) that hold a pair in range: queries
  // below k0 + 63 + window see a key of the block
  const int q_end = p.window > 0 ? min(p.T, k0 + SUB - 1 + p.window) : p.T;
  const int n_tiles = (q_end - k0 + QT - 1) / QT;

  auto issue = [&](int i) {  // tile i into stage i % 2: Q, dO, lse, D
    float* st = ring + (i % 2) * S::STAGE;
    const int q0 = k0 + i * QT;
    copy_rows_async<D, QT>(st, qg + q0 * p.st, p.st);
    copy_rows_async<D, QT>(st + 2 * QT * LD, gg + q0 * p.gt, p.gt);
    float* aux = st + 4 * QT * LD;
    if (threadIdx.x < QT / 4)
      cp_async16(aux + 4 * threadIdx.x, p.lse + rows + q0 + 4 * threadIdx.x, true);
    else if (threadIdx.x < QT / 2)
      cp_async16(aux + 4 * threadIdx.x, p.dsum + rows + q0 + 4 * threadIdx.x - QT, true);
  };

  // K and V tiles, in tile 0's group
  copy_rows_async<D, SUB>(kv, static_cast<const float*>(p.k) + base + k0 * p.st, p.st);
  copy_rows_async<D, SUB>(kv + SUB * LD, static_cast<const float*>(p.v) + base + k0 * p.st, p.st);
  issue(0);
  cp_async_commit();

  float ak[D / 8][4], av[D / 8][4];  // dK, dV
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) ak[n][e] = av[n][e] = 0.f;

#pragma unroll 1
  for (int i = 0; i < n_tiles; ++i) {
    float* st = ring + (i % 2) * S::STAGE;
    float *Qb = st, *Qsm = st + QT * LD, *Gb = st + 2 * QT * LD, *Gsm = st + 3 * QT * LD;
    const float* lse = st + 4 * QT * LD;
    const float* dd = lse + QT;
    cp_async_wait<0>();
    split_rows<D, QT>(Qb, Qsm);
    split_rows<D, QT>(Gb, Gsm);
    __syncthreads();  // tile i landed and split (at i = 0 also K, V); tile i - 1 consumed
    if (i + 1 < n_tiles) {  // tile i + 1 copies while this one computes
      issue(i + 1);
      cp_async_commit();
    }
    const int q0 = k0 + i * QT;
    // every pair of the tile allowed: all keys live, every query at or past
    // the last key and (window) before the first key's window ends
    const bool unmasked =
        all_live & (q0 >= k0 + SUB - 1) & ((p.window <= 0) | (q0 + QT - 1 < k0 + p.window));
#pragma unroll 1
    for (int qc = 0; qc < QT; qc += 8 * DKV_N) {
      const int at = qc * LD;
      float s[DKV_N][4], dp[DKV_N][4];  // Sᵀ = K·Qᵀ, dPᵀ = V·dOᵀ
#pragma unroll
      for (int n = 0; n < DKV_N; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int d = 0; d < D / 8; ++d) {
        uint32_t ab[4], as[4];
        kv_frag<D>(ab, as, kv, 0, warp, lane, d);
        st_step<D, DKV_N, true>(s, ab, as, Qb + at, Qsm + at, d, g, t);
        kv_frag<D>(ab, as, kv, 1, warp, lane, d);
        st_step<D, DKV_N, true>(dp, ab, as, Gb + at, Gsm + at, d, g, t);
      }
      if (unmasked)
        p_ds<false, DKV_N>(s, dp, p, alibi, slope, kpos, live, q0, qc, lse, dd, t);
      else
        p_ds<true, DKV_N>(s, dp, p, alibi, slope, kpos, live, q0, qc, lse, dd, t);
      acc_tile<D, DKV_N>(av, s, Gb + at, Gsm + at, g, t);   // dV += Pᵀ·dO
      acc_tile<D, DKV_N>(ak, dp, Qb + at, Qsm + at, g, t);  // dK += dSᵀ·Q
    }
  }
  // a lane's dK and dV: rows kr and kr + 8, columns 16m + 4t .. 16m + 4t + 3
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float* krow = dk + (long long)kpos[r] * p.rt + 4 * t;
    float* vrow = dv + (long long)kpos[r] * p.rt + 4 * t;
#pragma unroll
    for (int m = 0; m < D / 16; ++m) {
      const int e = 2 * r;
      *reinterpret_cast<float4*>(krow + 16 * m) =
          make_float4(ak[2 * m][e] * p.scale, ak[2 * m + 1][e] * p.scale,
                      ak[2 * m][e + 1] * p.scale, ak[2 * m + 1][e + 1] * p.scale);
      *reinterpret_cast<float4*>(vrow + 16 * m) =
          make_float4(av[2 * m][e], av[2 * m + 1][e], av[2 * m][e + 1], av[2 * m + 1][e + 1]);
    }
  }
}

// ---- fp32 K4a on the tensor cores (see the note at the top) ----

// The key ring's tiles and the warps' share of them
constexpr int DQ_KT = 32;  // keys of a stage (two stages)
// 8-key n-tiles a warp takes at once: a whole stage at Dh ≤ 64 (S and dP in
// 32 registers); at Dh 128 that spilled, so 16 keys at a time
template <int D>
constexpr int DQ_N = D <= 64 ? 4 : 2;
constexpr int SOME_PADDED = 1 << 30;  // tile list entry flag: a key of the tile is padded
static_assert(SUB % DQ_KT == 0 && DQ_KT % 16 == 0, "whole tiles a query block and a warp pass");

// Shared memory of flash_bwd_dq_tf32: the Q and dO tiles, then two stages of
// K's and V's big and small parts with the tile's key-mask values, the
// block's D and its key tile list (T / DQ_KT entries). Row stride D + 8 as
// in DkvSmem.
template <int D>
struct DqSmem {
  static constexpr int LD = D + 8;
  static constexpr int QG = 2 * SUB * LD;
  static constexpr int RING = 4 * DQ_KT * LD + DQ_KT;
  static size_t bytes(int T) {
    return sizeof(float) * ((size_t)QG + 2 * (size_t)RING + SUB) + sizeof(int) * (T / DQ_KT);
  }
};

// The key tiles [k0, k0 + DQ_KT) that hold a pair in causal and window range
// of query rows [q0, q0 + 64) and a live key, in key order: list[i] = k0,
// | SOME_PADDED unless every key of the tile is live. Each warp reads 128
// of the candidates' key-mask values a pass (16 bytes a lane: DQ_KT / 4
// lanes a tile) and votes; warp 0 compacts in place. Returns the count; the
// block synchronises.
__device__ __forceinline__ int key_tile_list(int* list, const int* kmg, int q0, int window) {
  constexpr int L = DQ_KT / 4;                          // lanes a tile
  constexpr unsigned BITS = L == 32 ? ~0u : (1u << L) - 1u;  // a tile's lanes in a ballot
  static_assert(32 % L == 0, "whole tiles a warp pass");
  __shared__ int count;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int k_lo = (window > 0 ? max(0, q0 - window + 1) : 0) / DQ_KT * DQ_KT;
  const int nk = q0 + SUB - k_lo, nc = nk / DQ_KT;  // candidate keys, tiles
  for (int c0 = warp * 128; c0 < nk; c0 += MMA_THREADS * 4) {
    const int c = c0 + 4 * lane;
    const int4 m = c < nk ? *reinterpret_cast<const int4*>(kmg + k_lo + c) : make_int4(0, 0, 0, 0);
    const unsigned some = __ballot_sync(0xffffffffu, (m.x | m.y | m.z | m.w) != 0);
    const unsigned every =
        __ballot_sync(0xffffffffu, (m.x != 0) & (m.y != 0) & (m.z != 0) & (m.w != 0));
    if (lane < 32 / L && c0 + lane * DQ_KT < nk) {
      const unsigned sm = some >> (lane * L) & BITS, ev = every >> (lane * L) & BITS;
      list[c0 / DQ_KT + lane] = (sm != 0) | ((ev == BITS) << 1);
    }
  }
  __syncthreads();
  if (warp == 0) {
    int n = 0;
    for (int base = 0; base < nc; base += 32) {
      const int i = base + lane, f = i < nc ? list[i] : 0;
      const unsigned ballot = __ballot_sync(0xffffffffu, f & 1);
      __syncwarp();  // every lane has read its flags before any entry is written
      if (f & 1)
        list[n + __popc(ballot & ((1u << lane) - 1u))] =
            (k_lo + i * DQ_KT) | (f & 2 ? 0 : SOME_PADDED);
      n += __popc(ballot);
    }
    if (lane == 0) count = n;
  }
  __syncthreads();
  return count;
}

// S, dP → dS = where(mask, P∘(dP − D), 0) with P = exp(s − lse) in place
// (in dp), s the score as the forward rounds it. The lane's element (n, e)
// is query qpos[e >> 1] and key k0 + 8n + 2t + ((e & 1) ^ (t >> 1)), k0 the
// chunk's first key and km its key-mask values.
// MASK = false: every pair is known to be allowed.
template <bool MASK, int N>
__device__ __forceinline__ void dq_ds(const float (&s)[N][4], float (&dp)[N][4], const Params& p,
                                      bool alibi, float slope, const int (&qpos)[2],
                                      const float (&lse)[2], const float (&dd)[2], int k0,
                                      const int* km, int t) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1, kk = 8 * n + 2 * t + ((e & 1) ^ (t >> 1)), kpos = k0 + kk;
      bool ok = true;
      if (MASK) ok = (km[kk] != 0) & in_range(qpos[r], kpos, p.window);
      const float pr = expf(score(s[n][e], p.scale, alibi, slope, kpos) - lse[r]);
      dp[n][e] = ok ? pr * (dp[n][e] - dd[r]) : 0.f;
    }
}

// fp32 K4a (D = Dh in {16, 32, 64, 128}): one block of 4 warps per (64
// query rows, head, batch row), query blocks in the slow grid order, the
// last first; warp w owns rows 16w .. 16w + 15 and keeps their dQ in
// registers while the listed key tiles stream through the ring.
template <int D>
__global__ void __launch_bounds__(MMA_THREADS, D <= 64 ? 2 : 1)
flash_bwd_dq_tf32(const Params p) {
  using S = DqSmem<D>;
  constexpr int LD = S::LD, KT = DQ_KT, N = DQ_N<D>;
  static_assert(KT % (8 * N) == 0, "whole n-tiles a stage");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* qgs = reinterpret_cast<float*>(smem_raw);  // the block's Q rows, then its dO rows
  float* ring = qgs + S::QG;
  float* d_s = ring + 2 * S::RING;
  int* list = reinterpret_cast<int*>(d_s + SUB);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const int NQ = p.T / SUB, HB = gridDim.x / NQ;  // query blocks; heads × batch rows
  const int slot = blockIdx.x / HB, hb = blockIdx.x - slot * HB, h = hb % p.H, b = hb / p.H;
  const int q0 = (NQ - 1 - slot) * SUB, qw = q0 + warp * 16;  // the last query block first
  const long long base = b * p.sb + h * p.sh;
  const float* kg = static_cast<const float*>(p.k) + base;
  const float* vg = static_cast<const float*>(p.v) + base;
  const float* gg = static_cast<const float*>(p.g) + b * p.gb + h * p.gh + q0 * p.gt;
  const float* og = static_cast<const float*>(p.o) + b * p.ob + h * p.oh + q0 * p.ot;
  const int* kmg = p.key_mask + (long long)b * p.T;
  const long long row0 = ((long long)b * p.H + h) * p.T + q0;  // into lse and dsum
  const bool alibi = p.slopes != nullptr;
  const float slope = alibi ? p.slopes[h] : 0.f;
  const int qpos[2] = {qw + g, qw + g + 8};

  // Q and dO into their tiles and O into the second stage (free until key
  // tile 1 is issued), in one group
  static_assert(SUB * LD <= S::RING, "O fits a stage");
  float* os = ring + S::RING;
  copy_rows_async<D, SUB>(qgs, static_cast<const float*>(p.q) + base + q0 * p.st, p.st);
  copy_rows_async<D, SUB>(qgs + SUB * LD, gg, p.gt);
  copy_rows_async<D, SUB>(os, og, p.ot);
  cp_async_commit();
  const int n = key_tile_list(list, kmg, q0, p.window);

  auto issue = [&](int i) {  // key tile i into stage i & 1: K, V, key-mask values
    float* st = ring + (i & 1) * S::RING;
    const int k0 = list[i] & ~SOME_PADDED;
    copy_rows_async<D, KT>(st, kg + k0 * p.st, p.st);
    copy_rows_async<D, KT>(st + 2 * KT * LD, vg + k0 * p.st, p.st);
    if (threadIdx.x < KT / 4)
      cp_async16(st + 4 * KT * LD + 4 * threadIdx.x, kmg + k0 + 4 * threadIdx.x, true);
  };
  if (n > 0) issue(0);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();  // Q, dO and O landed
  // D = rowsum(dO∘O) as flash_bwd_dq computes it: one warp a row, lanes
  // across Dh in column order, then the shuffle sum
#pragma unroll 4
  for (int j = 0; j < SUB / MMA_WARPS; ++j) {
    const int r = warp + MMA_WARPS * j;
    float x = 0.f;
    for (int c = lane; c < D; c += 32) x = fmaf(qgs[(SUB + r) * LD + c], os[r * LD + c], x);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    if (lane == 0) {
      d_s[r] = x;
      p.dsum[row0 + r] = x;
    }
  }
  __syncthreads();  // D visible, O's stage free

  const float lse[2] = {p.lse[row0 + warp * 16 + g], p.lse[row0 + warp * 16 + g + 8]};
  const float dd[2] = {d_s[warp * 16 + g], d_s[warp * 16 + g + 8]};
  float acc[D / 8][4];  // dQ
#pragma unroll
  for (int c = 0; c < D / 8; ++c) acc[c][0] = acc[c][1] = acc[c][2] = acc[c][3] = 0.f;

#pragma unroll 1
  for (int i = 0; i < n; ++i) {
    float* st = ring + (i & 1) * S::RING;
    float *Kb = st, *Ksm = st + KT * LD, *Vb = st + 2 * KT * LD, *Vsm = st + 3 * KT * LD;
    const int* km = reinterpret_cast<const int*>(st + 4 * KT * LD);
    cp_async_wait<0>();
    split_rows<D, KT>(Kb, Ksm);
    split_rows<D, KT>(Vb, Vsm);
    __syncthreads();  // key tile i landed and split; tile i - 1 consumed
    if (i + 1 < n) {  // the next key tile copies while this one computes
      issue(i + 1);
      cp_async_commit();
    }
    const int entry = list[i], k0 = entry & ~SOME_PADDED;
    // the warp's rows see a key of the tile: not all before it, not all past its window
    if ((k0 > qw + 15) | ((p.window > 0) & (k0 + KT - 1 <= qw - p.window))) continue;
    // every pair of the warp's rows and the tile allowed: all keys live, the
    // first row at or past the last key and (window) the last row before
    // the first key's window ends
    const bool unmasked = !(entry & SOME_PADDED) & (k0 + KT - 1 <= qw) &
                          ((p.window <= 0) | (qw + 15 < k0 + p.window));
#pragma unroll 1
    for (int kc = 0; kc < KT; kc += 8 * N) {
      const int at = kc * LD;
      float s[N][4], dp[N][4];  // S = Q·Kᵀ, dP = dO·Vᵀ
#pragma unroll
      for (int c = 0; c < N; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[c][e] = dp[c][e] = 0.f;
#pragma unroll
      for (int d = 0; d < D / 8; ++d) {
        uint32_t ab[4], as[4];
        kv_frag<D>(ab, as, qgs, 0, warp, lane, d);
        st_step<D, N, false>(s, ab, as, Kb + at, Ksm + at, d, g, t);
        kv_frag<D>(ab, as, qgs, 1, warp, lane, d);
        st_step<D, N, false>(dp, ab, as, Vb + at, Vsm + at, d, g, t);
      }
      if (unmasked)
        dq_ds<false, N>(s, dp, p, alibi, slope, qpos, lse, dd, k0 + kc, km + kc, t);
      else
        dq_ds<true, N>(s, dp, p, alibi, slope, qpos, lse, dd, k0 + kc, km + kc, t);
      acc_tile<D, N>(acc, dp, Kb + at, Ksm + at, g, t);  // dQ += dS·K
    }
  }
  // a lane's dQ: rows qpos[r], columns 16m + 4t .. 16m + 4t + 3
  float* dq = static_cast<float*>(p.dq) + b * p.rb + h * p.rh + 4 * t;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float* row = dq + (long long)qpos[r] * p.rt;
#pragma unroll
    for (int m = 0; m < D / 16; ++m) {
      const int e = 2 * r;
      *reinterpret_cast<float4*>(row + 16 * m) =
          make_float4(acc[2 * m][e] * p.scale, acc[2 * m + 1][e] * p.scale,
                      acc[2 * m][e + 1] * p.scale, acc[2 * m + 1][e + 1] * p.scale);
    }
  }
}

// ---- K4a and K4b at Dh 256 (GPT-J), fp32 and bf16 (see the note at the top) ----

constexpr int WIDE_QT = 16;             // K4b: query rows of a ring stage (two stages)
constexpr int WIDE_KT = DQ_KT / 2;      // K4a: keys of a ring stage, half a listed key tile
constexpr int DKV_WIDE_THREADS = 256;   // K4b: 8 warps, two to each 16 keys
static_assert(SUB % WIDE_QT == 0 && WIDE_KT % 8 == 0, "whole n-tiles a stage");

// two neighbouring values of a shared tile, widened to fp32
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 ld2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// four neighbouring values of a row of dq, dk or dv, rounded to its dtype
__device__ __forceinline__ void store4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(bf16* p, float a, float b, float c, float d) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(a, b), hi = __floats2bfloat162_rn(c, d);
  *reinterpret_cast<uint2*>(p) = make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                                            *reinterpret_cast<const uint32_t*>(&hi));
}

// Shared memory of flash_bwd_dkv_wide: the K and V tiles (64 rows each),
// then two stages of QT rows of Q and dO with the tile's lse and D; tiles in
// the input dtype, rows of D + 8 elements. fp32: 203,008 bytes.
template <typename T, int D>
struct DkvWideSmem {
  static constexpr int LD = D + 8;
  static constexpr size_t KV = 2 * SUB * LD;  // elements
  static constexpr size_t STAGE = 2 * WIDE_QT * LD * sizeof(T) + 2 * WIDE_QT * sizeof(float);
  static constexpr size_t BYTES = KV * sizeof(T) + 2 * STAGE;
};

// Shared memory of flash_bwd_dq_wide: the Q and dO tiles (64 rows each),
// then two stages of WIDE_KT keys of K and V with their key-mask values, the
// block's D and its key tile list. fp32 at T = 2048: 203,392 bytes.
template <typename T, int D>
struct DqWideSmem {
  static constexpr int LD = D + 8;
  static constexpr size_t QG = 2 * SUB * LD;  // elements
  static constexpr size_t STAGE = 2 * WIDE_KT * LD * sizeof(T) + WIDE_KT * sizeof(int);
  static size_t bytes(int T_) {
    return QG * sizeof(T) + 2 * STAGE + SUB * sizeof(float) + sizeof(int) * (T_ / DQ_KT);
  }
};

// kv_frag from a tile in the input dtype: the split A fragments of k-step d
// of the 16 rows at `rows` (row stride D + 8), each value split where it is
// read
template <typename T, int D>
__device__ __forceinline__ void a_frag_wide(uint32_t (&big)[4], uint32_t (&small)[4],
                                            const T* rows, int lane, int d) {
  constexpr int LD = D + 8;
  const T* at = rows + (lane >> 2) * LD + 8 * d + 2 * (lane & 3);
  const float2 lo = ld2(at), hi = ld2(at + 8 * LD);
  split_tf32(lo.x, big[0], small[0]);
  split_tf32(hi.x, big[1], small[1]);
  split_tf32(lo.y, big[2], small[2]);
  split_tf32(hi.y, big[3], small[3]);
}

// st_step from an unsplit tile in the input dtype: each lane splits the two
// values it reads for each n-tile into the parts split_rows would store, so
// the products are st_step's
template <typename T, int D, int N, bool SWAPPED>
__device__ __forceinline__ void st_step_wide(float (&s)[N][4], const uint32_t (&ab)[4],
                                             const uint32_t (&as)[4], const T* rows, int d,
                                             int g, int t) {
  constexpr int LD = D + 8;
  const T* at = rows + (g ^ (g >> 2 & 1)) * LD + 8 * d + 2 * t;
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const float2 v = ld2(at + 8 * n * LD);
    uint32_t bb0, bs0, bb1, bs1;
    split_tf32(v.x, bb0, bs0);
    split_tf32(v.y, bb1, bs1);
    if (SWAPPED)
      mma_3xtf32_swapped(s[n], ab, as, bb0, bb1, bs0, bs1);
    else
      mma_3xtf32(s[n], ab, as, bb0, bb1, bs0, bs1);
  }
}

// acc_tile over the C columns [col0, col0 + C) of an unsplit tile in the
// input dtype, each B value split where it is read: acc (16 rows x C) += X
// (16 rows x 8N) · B
template <typename T, int D, int N, int C>
__device__ __forceinline__ void acc_tile_wide(float (&acc)[C / 8][4], const float (&x)[N][4],
                                              const T* rows, int col0, int g, int t) {
  constexpr int LD = D + 8;
  const T* r0 = rows + (2 * t + (t >> 1)) * LD + col0 + 2 * g;
  const T* r1 = rows + (2 * t + 1 - (t >> 1)) * LD + col0 + 2 * g;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    uint32_t ab[4], as[4];
    split_tf32(x[j][0], ab[0], as[0]);
    split_tf32(x[j][2], ab[1], as[1]);
    split_tf32(x[j][1], ab[2], as[2]);
    split_tf32(x[j][3], ab[3], as[3]);
#pragma unroll
    for (int m = 0; m < C / 16; ++m) {
      const int o = 8 * j * LD + 16 * m;
      const float2 v0 = ld2(r0 + o), v1 = ld2(r1 + o);
      uint32_t b0, s0, b1, s1;
      split_tf32(v0.x, b0, s0);
      split_tf32(v1.x, b1, s1);
      mma_3xtf32(acc[2 * m], ab, as, b0, b1, s0, s1);
      split_tf32(v0.y, b0, s0);
      split_tf32(v1.y, b1, s1);
      mma_3xtf32(acc[2 * m + 1], ab, as, b0, b1, s0, s1);
    }
  }
}

// K4b at Dh 256, fp32 or bf16: one block of 8 warps per (64 keys, head,
// batch row), key blocks in the slow grid order. Warps w and w + 4 own keys
// 16(w % 4) .. + 15; each computes their Sᵀ and dPᵀ over all of Dh (the
// same products as flash_bwd_dkv_tf32) and keeps half of their dK and dV
// columns in registers, w < 4 the first 128, w ≥ 4 the last.
template <typename T, int D>
__global__ void __launch_bounds__(DKV_WIDE_THREADS, 1) flash_bwd_dkv_wide(const Params p) {
  using S = DkvWideSmem<T, D>;
  constexpr int LD = S::LD, QT = WIDE_QT, N = QT / 8, HALF = D / 2, NTH = DKV_WIDE_THREADS;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* kv = reinterpret_cast<T*>(smem_raw);  // the block's keys, then their values
  unsigned char* ring = smem_raw + S::KV * sizeof(T);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const int kw = warp & 3, col0 = (warp >> 2) * HALF;  // the warp's 16 keys; its columns
  const int HB = gridDim.x / (p.T / SUB);               // heads × batch rows
  const int kb = blockIdx.x / HB, hb = blockIdx.x - kb * HB, h = hb % p.H, b = hb / p.H;
  const int k0 = kb * SUB, kr = kw * 16 + g;  // kr, kr + 8: the lane's keys in the block
  const long long base = b * p.sb + h * p.sh;
  const T* qg = static_cast<const T*>(p.q) + base;
  const T* gg = static_cast<const T*>(p.g) + b * p.gb + h * p.gh;
  const long long rows = ((long long)b * p.H + h) * p.T;  // into lse and dsum
  const int* kmg = p.key_mask + (long long)b * p.T + k0;
  const bool alibi = p.slopes != nullptr;
  const float slope = alibi ? p.slopes[h] : 0.f;
  const int kpos[2] = {k0 + kr, k0 + kr + 8};
  const bool live[2] = {kmg[kr] != 0, kmg[kr + 8] != 0};
  T* dk = static_cast<T*>(p.dk) + b * p.rb + h * p.rh;
  T* dv = static_cast<T*>(p.dv) + b * p.rb + h * p.rh;

  const bool all_live = __syncthreads_and(threadIdx.x >= SUB || kmg[threadIdx.x] != 0);
  if (!__syncthreads_or(threadIdx.x < SUB && kmg[threadIdx.x] != 0)) {
    // all 64 keys padded: p = 0 on every pair, dK = dV = 0
    constexpr int C = D / 4;
    for (int e = threadIdx.x; e < SUB * C; e += NTH) {
      const long long at = (k0 + e / C) * p.rt + (e % C) * 4;
      store4(dk + at, 0.f, 0.f, 0.f, 0.f);
      store4(dv + at, 0.f, 0.f, 0.f, 0.f);
    }
    return;
  }
  const int q_end = p.window > 0 ? min(p.T, k0 + SUB - 1 + p.window) : p.T;
  const int n_tiles = (q_end - k0 + QT - 1) / QT;

  auto issue = [&](int i) {  // query tile i into stage i & 1: Q, dO, lse, D
    unsigned char* st = ring + (i & 1) * S::STAGE;
    T* qs = reinterpret_cast<T*>(st);
    const int q0 = k0 + i * QT;
    copy_rows_async<D, QT, NTH>(qs, qg + q0 * p.st, p.st);
    copy_rows_async<D, QT, NTH>(qs + QT * LD, gg + q0 * p.gt, p.gt);
    float* aux = reinterpret_cast<float*>(st + 2 * QT * LD * sizeof(T));
    if (threadIdx.x < QT / 4)
      cp_async16(aux + 4 * threadIdx.x, p.lse + rows + q0 + 4 * threadIdx.x, true);
    else if (threadIdx.x < QT / 2)
      cp_async16(aux + 4 * threadIdx.x, p.dsum + rows + q0 + 4 * threadIdx.x - QT, true);
  };

  // K and V tiles, in tile 0's group
  copy_rows_async<D, SUB, NTH>(kv, static_cast<const T*>(p.k) + base + k0 * p.st, p.st);
  copy_rows_async<D, SUB, NTH>(kv + SUB * LD, static_cast<const T*>(p.v) + base + k0 * p.st,
                               p.st);
  issue(0);
  cp_async_commit();

  float ak[HALF / 8][4], av[HALF / 8][4];  // the warp's columns of dK, dV
#pragma unroll
  for (int n = 0; n < HALF / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) ak[n][e] = av[n][e] = 0.f;
  const T* ka = kv + kw * 16 * LD;          // the warp's K rows (A)
  const T* va = kv + (SUB + kw * 16) * LD;  // their V rows

#pragma unroll 1
  for (int i = 0; i < n_tiles; ++i) {
    const unsigned char* st = ring + (i & 1) * S::STAGE;
    const T* Qs = reinterpret_cast<const T*>(st);
    const T* Gs = Qs + QT * LD;
    const float* lse = reinterpret_cast<const float*>(st + 2 * QT * LD * sizeof(T));
    const float* dd = lse + QT;
    cp_async_wait<0>();
    __syncthreads();  // tile i landed (at i = 0 also K, V); tile i - 1 consumed
    if (i + 1 < n_tiles) {  // tile i + 1 copies while this one computes
      issue(i + 1);
      cp_async_commit();
    }
    const int q0 = k0 + i * QT;
    const bool unmasked =
        all_live & (q0 >= k0 + SUB - 1) & ((p.window <= 0) | (q0 + QT - 1 < k0 + p.window));
    float s[N][4], dp[N][4];  // Sᵀ = K·Qᵀ, dPᵀ = V·dOᵀ
#pragma unroll
    for (int n = 0; n < N; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D / 8; ++d) {
      uint32_t ab[4], as[4];
      a_frag_wide<T, D>(ab, as, ka, lane, d);
      st_step_wide<T, D, N, true>(s, ab, as, Qs, d, g, t);
      a_frag_wide<T, D>(ab, as, va, lane, d);
      st_step_wide<T, D, N, true>(dp, ab, as, Gs, d, g, t);
    }
    if (unmasked)
      p_ds<false, N>(s, dp, p, alibi, slope, kpos, live, q0, 0, lse, dd, t);
    else
      p_ds<true, N>(s, dp, p, alibi, slope, kpos, live, q0, 0, lse, dd, t);
    acc_tile_wide<T, D, N, HALF>(av, s, Gs, col0, g, t);   // dV += Pᵀ·dO
    acc_tile_wide<T, D, N, HALF>(ak, dp, Qs, col0, g, t);  // dK += dSᵀ·Q
  }
  // a lane's dK and dV: rows kpos[r], columns col0 + 16m + 4t .. + 3
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    T* krow = dk + (long long)kpos[r] * p.rt + col0 + 4 * t;
    T* vrow = dv + (long long)kpos[r] * p.rt + col0 + 4 * t;
#pragma unroll
    for (int m = 0; m < HALF / 16; ++m) {
      const int e = 2 * r;
      store4(krow + 16 * m, ak[2 * m][e] * p.scale, ak[2 * m + 1][e] * p.scale,
             ak[2 * m][e + 1] * p.scale, ak[2 * m + 1][e + 1] * p.scale);
      store4(vrow + 16 * m, av[2 * m][e], av[2 * m + 1][e], av[2 * m][e + 1],
             av[2 * m + 1][e + 1]);
    }
  }
}

// K4a at Dh 256, fp32 or bf16: one block of 4 warps per (64 query rows,
// head, batch row), the last query block first; warp w owns rows 16w .. +
// 15 and keeps their dQ (all of Dh) in registers; Q's and dO's A fragments
// are read from their shared tiles at each k-step. The key tiles of
// key_tile_list stream through the ring in halves of WIDE_KT keys.
template <typename T, int D>
__global__ void __launch_bounds__(MMA_THREADS, 1) flash_bwd_dq_wide(const Params p) {
  using S = DqWideSmem<T, D>;
  constexpr int LD = S::LD, KT = WIDE_KT, N = KT / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* qgs = reinterpret_cast<T*>(smem_raw);  // the block's Q rows, then its dO rows
  unsigned char* ring = smem_raw + S::QG * sizeof(T);
  float* d_s = reinterpret_cast<float*>(ring + 2 * S::STAGE);
  int* list = reinterpret_cast<int*>(d_s + SUB);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const int NQ = p.T / SUB, HB = gridDim.x / NQ;  // query blocks; heads × batch rows
  const int slot = blockIdx.x / HB, hb = blockIdx.x - slot * HB, h = hb % p.H, b = hb / p.H;
  const int q0 = (NQ - 1 - slot) * SUB, qw = q0 + warp * 16;  // the last query block first
  const long long base = b * p.sb + h * p.sh;
  const T* kg = static_cast<const T*>(p.k) + base;
  const T* vg = static_cast<const T*>(p.v) + base;
  const T* gg = static_cast<const T*>(p.g) + b * p.gb + h * p.gh + q0 * p.gt;
  const T* og = static_cast<const T*>(p.o) + b * p.ob + h * p.oh + q0 * p.ot;
  const int* kmg = p.key_mask + (long long)b * p.T;
  const long long row0 = ((long long)b * p.H + h) * p.T + q0;  // into lse and dsum
  const bool alibi = p.slopes != nullptr;
  const float slope = alibi ? p.slopes[h] : 0.f;
  const int qpos[2] = {qw + g, qw + g + 8};

  copy_rows_async<D, SUB>(qgs, static_cast<const T*>(p.q) + base + q0 * p.st, p.st);
  copy_rows_async<D, SUB>(qgs + SUB * LD, gg, p.gt);
  cp_async_commit();
  const int n = 2 * key_tile_list(list, kmg, q0, p.window);  // half tiles

  auto issue = [&](int i) {  // half tile i into stage i & 1: K, V, key-mask values
    unsigned char* st = ring + (i & 1) * S::STAGE;
    T* ks = reinterpret_cast<T*>(st);
    const int k0 = (list[i >> 1] & ~SOME_PADDED) + (i & 1) * KT;
    copy_rows_async<D, KT>(ks, kg + k0 * p.st, p.st);
    copy_rows_async<D, KT>(ks + KT * LD, vg + k0 * p.st, p.st);
    if (threadIdx.x < KT / 4)
      cp_async16(st + 2 * KT * LD * sizeof(T) + 16 * threadIdx.x, kmg + k0 + 4 * threadIdx.x,
                 true);
  };
  if (n > 0) issue(0);
  cp_async_commit();
  // D = rowsum(dO∘O) while the tiles copy: one warp a row, lanes across Dh
  // in column order, then the shuffle sum (dO and O read from device memory)
#pragma unroll 4
  for (int j = 0; j < SUB / MMA_WARPS; ++j) {
    const int r = warp + MMA_WARPS * j;
    float x = 0.f;
    for (int c = lane; c < D; c += 32) x = fmaf(to_f(gg[r * p.gt + c]), to_f(og[r * p.ot + c]), x);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    if (lane == 0) {
      d_s[r] = x;
      p.dsum[row0 + r] = x;
    }
  }
  cp_async_wait<1>();
  __syncthreads();  // Q and dO landed, D visible

  const float lse[2] = {p.lse[row0 + warp * 16 + g], p.lse[row0 + warp * 16 + g + 8]};
  const float dd[2] = {d_s[warp * 16 + g], d_s[warp * 16 + g + 8]};
  float acc[D / 8][4];  // dQ
#pragma unroll
  for (int c = 0; c < D / 8; ++c) acc[c][0] = acc[c][1] = acc[c][2] = acc[c][3] = 0.f;
  const T* qa = qgs + warp * 16 * LD;          // the warp's Q rows (A)
  const T* ga = qgs + (SUB + warp * 16) * LD;  // its dO rows

#pragma unroll 1
  for (int i = 0; i < n; ++i) {
    const unsigned char* st = ring + (i & 1) * S::STAGE;
    const T* Ks = reinterpret_cast<const T*>(st);
    const T* Vs = Ks + KT * LD;
    const int* km = reinterpret_cast<const int*>(st + 2 * KT * LD * sizeof(T));
    cp_async_wait<0>();
    __syncthreads();  // half tile i landed; half tile i - 1 consumed
    if (i + 1 < n) {  // the next half tile copies while this one computes
      issue(i + 1);
      cp_async_commit();
    }
    const int entry = list[i >> 1], k0 = (entry & ~SOME_PADDED) + (i & 1) * KT;
    // the warp's rows see a key of the half tile: not all before it, not all past its window
    if ((k0 > qw + 15) | ((p.window > 0) & (k0 + KT - 1 <= qw - p.window))) continue;
    const bool unmasked = !(entry & SOME_PADDED) & (k0 + KT - 1 <= qw) &
                          ((p.window <= 0) | (qw + 15 < k0 + p.window));
    float s[N][4], dp[N][4];  // S = Q·Kᵀ, dP = dO·Vᵀ
#pragma unroll
    for (int c = 0; c < N; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[c][e] = dp[c][e] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D / 8; ++d) {
      uint32_t ab[4], as[4];
      a_frag_wide<T, D>(ab, as, qa, lane, d);
      st_step_wide<T, D, N, false>(s, ab, as, Ks, d, g, t);
      a_frag_wide<T, D>(ab, as, ga, lane, d);
      st_step_wide<T, D, N, false>(dp, ab, as, Vs, d, g, t);
    }
    if (unmasked)
      dq_ds<false, N>(s, dp, p, alibi, slope, qpos, lse, dd, k0, km, t);
    else
      dq_ds<true, N>(s, dp, p, alibi, slope, qpos, lse, dd, k0, km, t);
    acc_tile_wide<T, D, N, D>(acc, dp, Ks, 0, g, t);  // dQ += dS·K
  }
  // a lane's dQ: rows qpos[r], columns 16m + 4t .. 16m + 4t + 3
  T* dq = static_cast<T*>(p.dq) + b * p.rb + h * p.rh + 4 * t;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    T* row = dq + (long long)qpos[r] * p.rt;
#pragma unroll
    for (int m = 0; m < D / 16; ++m) {
      const int e = 2 * r;
      store4(row + 16 * m, acc[2 * m][e] * p.scale, acc[2 * m + 1][e] * p.scale,
             acc[2 * m][e + 1] * p.scale, acc[2 * m + 1][e + 1] * p.scale);
    }
  }
}

template <int D>
constexpr size_t dq_smem() {
  return sizeof(float) * ((size_t)4 * SUB * (D + 4) + (size_t)SUB * LDT + 3 * SUB);
}

template <int D>
constexpr size_t dkv_smem() {
  return sizeof(float) * ((size_t)4 * SUB * (D + 4) + (size_t)2 * SUB * LDT + 3 * SUB);
}

template <typename KernelT>
cudaError_t launch(KernelT kernel, size_t smem, dim3 grid, cudaStream_t st, const Params& p) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, NT, smem, st>>>(p);
  return cudaGetLastError();
}

// fp32 K4a and K4b, and both at Dh 256: one block of `threads` per (walk
// block, head, batch row) on a 1-D grid, the walk's block slowest
template <typename KernelT>
cudaError_t launch_tf32(KernelT kernel, size_t smem, int B, cudaStream_t st, const Params& p,
                        int threads = MMA_THREADS) {
  const long long blocks = (long long)(p.T / SUB) * p.H * B;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)blocks, threads, smem, st>>>(p);
  return cudaGetLastError();
}

// The one place a call meets its kernel: at Dh 256 K4a flash_bwd_dq_wide and
// K4b flash_bwd_dkv_wide on the tensor cores in both dtypes; below it fp32
// K4a flash_bwd_dq_tf32 and K4b flash_bwd_dkv_tf32 on the tensor cores, bf16
// K4a flash_bwd_dq and K4b flash_bwd_dkv on the CUDA cores. No fallback: a
// launch that fails returns its error.
template <typename T, int D>
cudaError_t launch_kernel(bool dkv, int B, cudaStream_t s, const Params& p) {
  if constexpr (D == 256) {
    return dkv ? launch_tf32(flash_bwd_dkv_wide<T, D>, DkvWideSmem<T, D>::BYTES, B, s, p,
                             DKV_WIDE_THREADS)
               : launch_tf32(flash_bwd_dq_wide<T, D>, DqWideSmem<T, D>::bytes(p.T), B, s, p);
  } else if constexpr (std::is_same_v<T, bf16>) {
    const dim3 grid(p.T / SUB, p.H, B);
    return dkv ? launch(flash_bwd_dkv<T, D>, dkv_smem<D>(), grid, s, p)
               : launch(flash_bwd_dq<T, D>, dq_smem<D>(), grid, s, p);
  } else {
    return dkv ? launch_tf32(flash_bwd_dkv_tf32<D>, DkvSmem<D>::BYTES, B, s, p)
               : launch_tf32(flash_bwd_dq_tf32<D>, DqSmem<D>::bytes(p.T), B, s, p);
  }
}

template <typename T>
cudaError_t dispatch(bool dkv, int B, int Dh, cudaStream_t s, const Params& p) {
  switch (Dh) {
    case 16: return launch_kernel<T, 16>(dkv, B, s, p);
    case 32: return launch_kernel<T, 32>(dkv, B, s, p);
    case 64: return launch_kernel<T, 64>(dkv, B, s, p);
    case 128: return launch_kernel<T, 128>(dkv, B, s, p);
    case 256: return launch_kernel<T, 256>(dkv, B, s, p);
    default: return cudaErrorInvalidValue;
  }
}

int run(bool dkv, int B, int Dh, int is_bf16, void* stream, const Params& p) {
  if (B < 1 || p.H < 1 || p.T < SUB || B > 65535 || p.H > 65535 || p.T % SUB)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? dispatch<bf16>(dkv, B, Dh, s, p) : dispatch<float>(dkv, B, Dh, s, p));
}

}  // namespace

// C entry points, bound with ctypes. q/k/v/g/out/dq/dk/dv: (B, H, T, Dh) fp32
// (is_bf16 = 0) or bf16 (is_bf16 = 1), element strides (sb, sh, st) for q, k
// and v, (gb, gh, gt) for g, (ob, oh, ot) for out and (rb, rh, rt) for dq, dk
// and dv; unit stride along Dh, rows 16-byte aligned. lse and dsum: (B, H, T)
// fp32. key_mask: (B, T) int32. slopes: (H,) fp32 or null (no ALiBi). T must
// divide by 64. K4a writes dq and dsum; K4b reads dsum and writes dk and dv,
// so it runs after K4a on the same stream. Each returns the launch's
// cudaError_t; 0 means launched.
extern "C" int sgpt_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* g, const void* out,
    const float* lse, float* dsum, void* dq, const int* key_mask, const float* slopes, int B,
    int H, int T, int Dh, long long sb, long long sh, long long st, long long gb, long long gh,
    long long gt, long long ob, long long oh, long long ot, long long rb, long long rh,
    long long rt, float scale, int window, int is_bf16, void* stream) {
  const Params p{q,  k,  v,  g,  out, lse, dsum, dq, nullptr, nullptr, key_mask, slopes,
                 H,  T,  sb, sh, st,  gb,  gh,   gt, ob,      oh,      ot,       rb,
                 rh, rt, scale, window > 0 ? window : 0};
  return run(false, B, Dh, is_bf16, stream, p);
}

extern "C" int sgpt_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* g, const float* lse,
    const float* dsum, void* dk, void* dv, const int* key_mask, const float* slopes, int B,
    int H, int T, int Dh, long long sb, long long sh, long long st, long long gb, long long gh,
    long long gt, long long rb, long long rh, long long rt, float scale, int window,
    int is_bf16, void* stream) {
  const Params p{q,  k,  v,  g,  nullptr, lse, const_cast<float*>(dsum), nullptr, dk, dv,
                 key_mask, slopes, H, T, sb, sh, st, gb, gh, gt, 0, 0, 0, rb, rh, rt, scale,
                 window > 0 ? window : 0};
  return run(true, B, Dh, is_bf16, stream, p);
}
