// Causal flash attention backward for Hopper (compiled for sm_90a): K4a, K4b.
//
// Replaces the two TPU kernels of sgpt_tpu/ops/pallas/flash_attention.py's
// flash_attention_bwd, the backward of every attention layer when GPT-Neo
// trains with use_flash at T % 128 == 0 (the long-context training path):
//   * flash_bwd_dq (K4a) replaces :231 _flash_bwd_dq_kernel;
//   * flash_bwd_dkv (K4b) replaces :276 _flash_bwd_dkv_kernel.
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
// it needs no TPU tile set: each block walks the 64 × 64 sub-tiles that hold
// a pair in causal and window range, and skips a sub-tile whose 64 keys are
// all padded. A skipped sub-tile has p = 0 on every pair: it adds nothing.
//   * K4a: one block per (64 query rows, head, batch row), dQ accumulated in
//     registers over the key sub-tiles the rows reach.
//   * K4b: one block per (64 keys, head, batch row), dK and dV accumulated in
//     registers over the query sub-tiles that reach the keys. Two kernels and
//     no atomics, split as the TPU splits them: the result is deterministic.
//
// Layout: q, k, v, out and dO are (B, H, T, Dh) with any strides whose Dh
// axis is contiguous and whose rows are 16-byte aligned (the decoder's
// (B, T, H·Dh) projection views); dq, dk and dv are written with q's strides,
// so the head transposes copy nothing on either side of the call.
//
// What bounds it on this card: at the long-context training shape (B=8,
// T=2048, H=12, Dh=64, fp32) a global layer needs 6·Dh FLOP a valid pair in
// K4a (S, dP, dQ: 77.4 GFLOP, 1.15 ms at 67 TFLOP/s) and 8·Dh in K4b (S, dP,
// dV, dK: 103.1 GFLOP, 1.54 ms), against ~0.08 ms of bytes: operations bind.
// The design answers with register tiling on the CUDA cores in exact fp32
// (no TF32): 256 threads as a 16 × 16 grid, each owning a 4 × 4 block of a
// 64 × 64 score tile (rows and columns in steps of 16, so a warp's 16-byte
// shared loads hit distinct banks) and 4 rows × Dh/16 columns of each
// accumulator; 16 fp32 FMAs per two 16-byte shared loads in the score
// products. Shared memory holds four 64 × Dh fp32 tiles and one (K4a) or two
// (K4b) 64 × 64 score tiles: 86 KB and 103 KB at Dh=64, 150 KB and 167 KB at
// Dh=128, where 32-row tiles are not needed since the accumulators live in
// registers. bf16 inputs are widened to fp32 on their way into shared memory
// and take the same fp32 path. Tensor cores (bf16 S and dP), wgmma,
// cp.async/TMA prefetch of the next tile and larger register tiles are later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_attention.cuh"

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

template <typename T>
cudaError_t dispatch(bool dkv, int Dh, dim3 grid, cudaStream_t s, const Params& p) {
  switch (Dh) {
    case 16: return dkv ? launch(flash_bwd_dkv<T, 16>, dkv_smem<16>(), grid, s, p)
                        : launch(flash_bwd_dq<T, 16>, dq_smem<16>(), grid, s, p);
    case 32: return dkv ? launch(flash_bwd_dkv<T, 32>, dkv_smem<32>(), grid, s, p)
                        : launch(flash_bwd_dq<T, 32>, dq_smem<32>(), grid, s, p);
    case 64: return dkv ? launch(flash_bwd_dkv<T, 64>, dkv_smem<64>(), grid, s, p)
                        : launch(flash_bwd_dq<T, 64>, dq_smem<64>(), grid, s, p);
    case 128: return dkv ? launch(flash_bwd_dkv<T, 128>, dkv_smem<128>(), grid, s, p)
                         : launch(flash_bwd_dq<T, 128>, dq_smem<128>(), grid, s, p);
    default: return cudaErrorInvalidValue;
  }
}

int run(bool dkv, int B, int Dh, int is_bf16, void* stream, const Params& p) {
  if (B < 1 || p.H < 1 || p.T < SUB || B > 65535 || p.H > 65535 || p.T % SUB)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(p.T / SUB, p.H, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? dispatch<bf16>(dkv, Dh, grid, s, p)
                       : dispatch<float>(dkv, Dh, grid, s, p));
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
