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
// What bounds it on this card: the O(T²) score work per (row, head) and
// shared-memory residency. The TPU kernel keeps one head's whole (T, T) fp32
// score tile in VMEM; at T=300 that is 360 KB, more than the 227 KB of shared
// memory a block may use. Design: one block per (batch row, head, BQ=16
// query rows). The block keeps a BQ × T fp32 score strip in dynamic shared
// memory (128 KB at T=2048), fills it by looping over *every* 64-key tile,
// runs an exact fp32 softmax over each whole row, then accumulates P·V over
// the key tiles again. The scores never leave the chip. No key tile is
// pruned: a padded query row that the window leaves with no valid key
// softmaxes to uniform 1/T over all T keys, as in the TPU kernel and its
// plain reference.
//
// Two kernels share that design and the masking and softmax code, which live
// in short_attention.cuh so that the backward (short_attention_bwd.cu)
// recomputes the same scores and probabilities:
//   * wmma_kernel (bf16, Dh in {16, 32, 64, 128}): Q·Kᵀ and P·V on the
//     tensor cores through warp-level WMMA 16x16x16 bf16 tiles with fp32
//     accumulators; tiles move global→shared as 16-byte vectors. At T=2048,
//     Dh=128 it holds 213 KB of shared memory. Measured on an H100 80GB HBM3
//     (700 W) at B=64, T=300, H=12, Dh=64: 0.99 ms, against 2.87 ms for the
//     scalar kernel and 1.39 ms for the plain PyTorch version.
//   * scalar_kernel (fp32, and bf16 at other head sizes): scalar fp32 FMAs on
//     the CUDA cores. fp32 stays off the tensor cores (TF32 would round q, k).
// wgmma, TMA, online softmax and tile pruning are later work.

#include <mma.h>

#include "short_attention.cuh"

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

// rows [r0, r0 + n) of one head (Dh bf16 values each) → shared tile with row
// stride ld, 16 bytes per load; rows at or past T are zero.
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int64_t row0, int64_t HD,
                                          int r0, int n, int T, int Dh, int ld, int tid) {
  const int nvec = Dh / 8;
  for (int e = tid; e < n * nvec; e += THREADS) {
    const int r = e / nvec, c = (e - r * nvec) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < T) val = *reinterpret_cast<const uint4*>(src + (row0 + r0 + r) * HD + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

__global__ void __launch_bounds__(THREADS)
wmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
            bf16* __restrict__ out, Mask mask, int T, int H, int Dh, int Tpad, int s_floats) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int ld = Dh + 8;  // bf16 tile row stride: 16-byte rows, staggered banks
  float* s = reinterpret_cast<float*>(smem_raw);  // BQ x Tpad fp32 scores; later P·V partials
  bf16* p = reinterpret_cast<bf16*>(s + s_floats);  // BQ x Tpad bf16 probabilities
  bf16* qs = p + BQ * Tpad;                         // BQ x ld
  bf16* kv = qs + BQ * ld;                          // BK x ld: the K tile, later the V tile

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int64_t row0 = (int64_t)blockIdx.z * T;
  const int64_t HD = (int64_t)H * Dh;

  load_rows(qs, q + h * Dh, row0, HD, q0, BQ, T, Dh, ld, tid);

  // Scores: warp w < BK/16 computes the 16 x 16 tile of keys k0 + 16w.
  for (int k0 = 0; k0 < T; k0 += BK) {
    __syncthreads();  // query tile written / previous key tile consumed
    load_rows(kv, k + h * Dh, row0, HD, k0, BK, T, Dh, ld, tid);
    __syncthreads();
    if (warp < BK / 16) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int d = 0; d < Dh; d += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;  // Kᵀ
        wmma::load_matrix_sync(a, qs + d, ld);
        wmma::load_matrix_sync(b, kv + warp * 16 * ld + d, ld);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(s + k0 + warp * 16, acc, Tpad, wmma::mem_row_major);
    }
    __syncthreads();
    mask_tile(s, mask, Tpad, k0, q0, row0, h, T, tid);
  }
  __syncthreads();

  // Softmax, one warp per row; P rounded to bf16, zero past T (V is zero there too).
  for (int r = warp; r < BQ; r += WARPS) {
    float* sr = s + r * Tpad;
    bf16* pr = p + r * Tpad;
    softmax_row(sr, 0, T, T, lane);
    for (int j = lane; j < Tpad; j += 32) pr[j] = __float2bfloat16(j < T ? sr[j] : 0.f);
  }

  // O = P·V: warp w owns output column tile w % nct and, when the Dh/16 column
  // tiles leave warps spare, the 16-key steps ≡ w / nct (mod nsplit).
  const int nct = Dh / 16, nsplit = WARPS / nct;
  const int ct = warp % nct, sp = warp / nct;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> o;
  wmma::fill_fragment(o, 0.f);
  for (int k0 = 0; k0 < T; k0 += BK) {
    __syncthreads();  // probabilities final / previous V tile consumed
    load_rows(kv, v + h * Dh, row0, HD, k0, BK, T, Dh, ld, tid);
    __syncthreads();
    for (int ks = sp; ks < BK / 16; ks += nsplit) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      wmma::load_matrix_sync(a, p + k0 + ks * 16, Tpad);
      wmma::load_matrix_sync(b, kv + ks * 16 * ld + ct * 16, ld);
      wmma::mma_sync(o, a, b, o);
    }
  }
  __syncthreads();  // the fp32 score strip is free: reuse it for the partial sums
  wmma::store_matrix_sync(s + warp * 256, o, 16, wmma::mem_row_major);
  __syncthreads();
  bf16* oh = out + h * Dh;
  for (int e = tid; e < BQ * Dh; e += THREADS) {
    const int r = e / Dh, d = e - r * Dh;
    const int qi = q0 + r;
    if (qi >= T) continue;
    const int c = d / 16, dc = d - c * 16;
    float a = 0.f;
    for (int j = 0; j < nsplit; ++j) a += s[(j * nct + c) * 256 + r * 16 + dc];
    oh[(row0 + qi) * HD + d] = __float2bfloat16(a);
  }
}

bool wmma_ok(const void* q, const void* k, const void* v, const void* out, int Dh) {
  const uintptr_t ptrs = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out;
  return (Dh == 16 || Dh == 32 || Dh == 64 || Dh == 128) && ptrs % 16 == 0;
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
  if (is_bf16 && wmma_ok(q, k, v, out, Dh)) {
    const int s_floats = BQ * Tpad > WARPS * 256 ? BQ * Tpad : WARPS * 256;
    const size_t smem = sizeof(float) * s_floats +
                        sizeof(bf16) * ((size_t)BQ * Tpad + (size_t)(BQ + BK) * (Dh + 8));
    if ((err = set_smem(wmma_kernel, smem)) != cudaSuccess) return (int)err;
    wmma_kernel<<<grid, THREADS, smem, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<bf16*>(out), mask, T, H, Dh, Tpad, s_floats);
    return (int)cudaGetLastError();
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
