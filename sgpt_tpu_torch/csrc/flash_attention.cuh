// Shared by the flash attention forward (flash_attention.cu, K3) and backward
// (flash_attention_bwd.cu, K4a and K4b): the mask constant, the 64-row
// sub-tile, the pair and sub-tile masks, and the score as the plain version
// rounds it. Both sides include this one copy, so the backward recomputes
// exactly the forward's scores and masks.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr float NEG_INF = -1e30f;  // the TPU kernel's mask constant
constexpr int SUB = 64;            // query rows and keys of a sub-tile

// causal ∧ [window]: whether query qpos may see key kpos (key padding aside).
// Bitwise, not short-circuit, here and where callers add the key mask: the
// short-circuit form made nvcc branch and reload the window per score in
// K3's softmax, 13 % slower on an H100 at T=2048 (PERF.md).
__device__ __forceinline__ bool in_range(int qpos, int kpos, int window) {
  return (kpos <= qpos) & ((window <= 0) | (kpos > qpos - window));
}

// whether the sub-tile of query rows [q0, q0 + 64) and keys [k0, k0 + 64)
// holds any pair in range; false: every pair of it is masked
__device__ __forceinline__ bool subtile_in_range(int q0, int k0, int window) {
  return k0 <= q0 + SUB - 1 && (window <= 0 || k0 + SUB - 1 > q0 - window);
}

// a raw q·k → × scale (when != 1), + slope·kpos (ALiBi), in the plain
// version's order with two roundings: no contraction into one FMA
__device__ __forceinline__ float score(float dot, float scale, bool alibi, float slope,
                                       int kpos) {
  if (scale != 1.f) dot = __fmul_rn(dot, scale);
  if (alibi) dot = __fadd_rn(dot, __fmul_rn(slope, (float)kpos));
  return dot;
}

}  // namespace
