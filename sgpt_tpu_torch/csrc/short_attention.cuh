// Shared by the fused short-T attention forward (short_attention.cu, K1) and
// backward (short_attention_bwd.cu, K2): tile constants, dtype conversions,
// the mask, the masked score and the fp32 row softmax. Both kernels include
// this one copy, so the backward recomputes exactly the forward's scores and
// probabilities.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int BQ = 16;        // query rows per block
constexpr int BK = 64;        // keys per shared-memory tile
constexpr int THREADS = 256;  // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int MAX_DH = 256;
constexpr float NEG = -1e9f;  // the TPU kernel's mask constant

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }

template <typename scalar_t> __device__ __forceinline__ scalar_t from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_float<bf16>(float x) {
  return __float2bfloat16(x);  // round to nearest even
}

struct Mask {
  const int* key_mask;   // (B, T)
  const float* slopes;   // (H,), read when use_alibi
  const int* segments;   // (B, T) or null
  const int* kpos;       // (B, T) or null: ALiBi key positions (default: key index)
  float scale;
  int window;
  int use_alibi;
};

// Whether query qi may attend to key ki < T (causal ∧ [window] ∧ key
// padding ∧ [same segment]); rows at or past T attend to nothing.
__device__ __forceinline__ bool allowed(const Mask m, int64_t row0, int qi, int ki, int T) {
  bool ok = qi < T && ki <= qi && m.key_mask[row0 + ki] > 0;
  if (m.window > 0) ok = ok && ki > qi - m.window;
  if (m.segments != nullptr && qi < T) ok = ok && m.segments[row0 + ki] == m.segments[row0 + qi];
  return ok;
}

// where(mask, dot·scale [+ slope·kpos], -1e9) for query qi and key ki < T of
// the batch row whose first token is row0, in the TPU kernel's order.
__device__ __forceinline__ float masked_score(const Mask m, float dot, int64_t row0, int h,
                                              int qi, int ki, int T) {
  float s = dot;
  if (m.scale != 1.f) s *= m.scale;
  if (m.use_alibi)  // two roundings, as the plain version: no contraction into one FMA
    s = __fadd_rn(s, __fmul_rn(m.slopes[h], (float)(m.kpos ? m.kpos[row0 + ki] : ki)));
  return allowed(m, row0, qi, ki, T) ? s : NEG;
}

// where(mask, …) over the BQ x BK tile of raw dot products at keys k0.. of
// the strip s (row stride Tpad); the block synchronises before and after.
__device__ __forceinline__ void mask_tile(float* s, const Mask m, int Tpad, int k0, int q0,
                                          int64_t row0, int h, int T, int tid) {
  for (int e = tid; e < BQ * BK; e += THREADS) {
    const int r = e / BK, ki = k0 + (e - r * BK);
    if (ki < T) s[r * Tpad + ki] = masked_score(m, s[r * Tpad + ki], row0, h, q0 + r, ki, T);
  }
}

// One warp: exact fp32 softmax of a row of n scores, in place over the
// entries sr[j0:j1] it holds (max, exp, sum, divide). The n - (j1 - j0)
// entries it does not hold are masked (-1e9) and count as such: they add
// expf(-1e9 - max) each to the sum, which is 1 when the whole row is masked
// (a uniform 1/n row) and 0 otherwise. Returns the row max and the sum, the
// same in every lane: a probability is expf(s - max) / sum, which the
// backward re-evaluates from these two.
__device__ __forceinline__ float2 softmax_row(float* sr, int j0, int j1, int n, int lane) {
  float mx = n > j1 - j0 ? NEG : -INFINITY;
  for (int j = j0 + lane; j < j1; j += 32) mx = fmaxf(mx, sr[j]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  float sum = 0.f;
  for (int j = j0 + lane; j < j1; j += 32) {
    const float e = expf(sr[j] - mx);
    sr[j] = e;
    sum += e;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  if (n > j1 - j0) sum += (float)(n - (j1 - j0)) * expf(NEG - mx);
  for (int j = j0 + lane; j < j1; j += 32) sr[j] = sr[j] / sum;
  return make_float2(mx, sum);
}

template <typename KernelT>
cudaError_t set_smem(KernelT kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace
