// Warp-level tensor-core building blocks of the bf16 attention forwards:
// K1 (short_attention.cu, `mma_kernel`) and K3 (flash_attention.cu,
// `flash_fwd_bf16`). The backward kernels (K2, K4a, K4b) do not include it.
//
// A block of MMA_WARPS warps owns a 64-row query tile; each warp owns 16 of
// its rows and keeps, for the whole block, the rows' Q as bf16 A fragments,
// the 16 x 64 score tile S and the 16 x D output O as fp32 accumulators of
// `mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32`, all in registers.
// In the m16n8 accumulator layout lane l holds rows l/4 and l/4 + 8 and
// columns 2(l%4), 2(l%4)+1 of every 8-column n-tile, so a row's reduction
// runs over the 4 lanes of a quad, and P = softmax(S) repacks from the S
// accumulator straight into the A fragments of P·V (FA2's trick): S, P and
// O never touch shared memory. K and V tiles stream through shared memory
// by `cp.async` (16-byte copies, zero-filled past the last row) into padded
// rows of D + 8 bf16 (16-byte aligned, and the 8 row addresses of an
// `ldmatrix` phase fall in 8 distinct 16-byte bank groups), read by
// `ldmatrix` (`.trans` for V, whose keys run down the rows).
//
// Next step: `wgmma`. `mma.sync` issues a 16 x 8 x 16 product per warp and
// reads both operands through registers, so the warps spend issue slots on
// ldmatrix and mma that Hopper's warpgroup MMA (64-row tiles, B read from
// shared memory by the tensor cores, asynchronous) would free for the
// softmax; with TMA feeding the K/V ring from one producer warp, that is
// the shape of the card's fastest attention kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MMA_TILE = 64;                   // query rows of a block, keys of a K/V tile
constexpr int MMA_WARPS = 4;                   // each warp: 16 query rows
constexpr int MMA_THREADS = 32 * MMA_WARPS;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global → shared, asynchronously; !valid: the 16 bytes are zeroed
// (no global read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// 4 bytes global → shared, asynchronously; !valid: zeroed
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a · b: one 16 x 8 x 16 bf16 product with fp32 accumulation
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// max and sum over the 4 lanes of a quad: one accumulator row
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// two fp32 → one register of two bf16 (round to nearest even), lo first
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// rows [r0, r0 + 64) of a bf16 array (row stride `stride` elements, D
// contiguous values a row) → a shared tile of row stride D + 8; rows at or
// past n_rows are zero-filled. Issued by all MMA_THREADS threads, each
// copying 16 bytes of every (MMA_THREADS / (D / 8))-th row; the caller
// commits the group.
template <int D>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                                long long stride, int r0, int n_rows) {
  constexpr int C = D / 8, LD = D + 8, ROWS = MMA_THREADS / C;
  static_assert(MMA_TILE % ROWS == 0, "whole rows a pass");
  const int r = r0 + threadIdx.x / C, c = (threadIdx.x % C) * 8;
  const __nv_bfloat16* s = src + (long long)r * stride + c;
  __nv_bfloat16* d = dst + (threadIdx.x / C) * LD + c;
#pragma unroll
  for (int i = 0; i < MMA_TILE / ROWS; ++i) {
    const bool ok = r + i * ROWS < n_rows;
    cp_async16(d + i * ROWS * LD, ok ? s + (long long)i * ROWS * stride : src, ok);
  }
}

// the A fragments of a warp's 16 rows of a shared tile (row stride D + 8):
// qf[d] covers columns 16d .. 16d + 15
template <int D>
__device__ __forceinline__ void load_a_frags(uint32_t (&qf)[D / 16][4], const __nv_bfloat16* rows,
                                             int lane) {
  const __nv_bfloat16* p = rows + (lane & 15) * (D + 8) + (lane >> 4) * 8;
#pragma unroll
  for (int d = 0; d < D / 16; ++d) ldmatrix_x4(qf[d], p + d * 16);
}

// S (16 rows x 64 keys) = Q · Kᵀ over a 64-key shared tile; s[n] holds keys
// 8n .. 8n + 7
template <int D>
__device__ __forceinline__ void qk_tile(float (&s)[8][4], const uint32_t (&qf)[D / 16][4],
                                        const __nv_bfloat16* ks, int lane) {
  const __nv_bfloat16* p = ks + ((lane & 7) + (lane >> 4) * 8) * (D + 8) + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int d = 0; d < D / 16; ++d) {
      uint32_t b[4];
      ldmatrix_x4(b, p + j * 16 * (D + 8) + d * 16);
      mma_bf16(s[2 * j], qf[d], b[0], b[1]);
      mma_bf16(s[2 * j + 1], qf[d], b[2], b[3]);
    }
  }
}

// qk_tile with Q's A fragments read from the warp's 16 rows of the shared
// Q tile (row stride D + 8) at every k-step instead of held in registers:
// at Dh 256 (GPT-J) the 64 registers of held fragments beside O's 128 and
// S's 32 would spill. Each s[n] adds the same products in the same k-step
// order as qk_tile, so the scores are the same bits.
template <int D>
__device__ __forceinline__ void qk_tile_smem(float (&s)[8][4], const __nv_bfloat16* qrows,
                                             const __nv_bfloat16* ks, int lane) {
  const __nv_bfloat16* pa = qrows + (lane & 15) * (D + 8) + (lane >> 4) * 8;
  const __nv_bfloat16* p = ks + ((lane & 7) + (lane >> 4) * 8) * (D + 8) + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D / 16; ++d) {
    uint32_t a[4];
    ldmatrix_x4(a, pa + d * 16);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t b[4];
      ldmatrix_x4(b, p + j * 16 * (D + 8) + d * 16);
      mma_bf16(s[2 * j], a, b[0], b[1]);
      mma_bf16(s[2 * j + 1], a, b[2], b[3]);
    }
  }
}

// P as the A fragments of P·V, straight from the S accumulator layout:
// key step k (keys 16k .. 16k + 15) is n-tiles 2k and 2k + 1
__device__ __forceinline__ void p_frags(uint32_t (&pf)[4][4], const float (&p)[8][4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    pf[k][0] = pack_bf16(p[2 * k][0], p[2 * k][1]);
    pf[k][1] = pack_bf16(p[2 * k][2], p[2 * k][3]);
    pf[k][2] = pack_bf16(p[2 * k + 1][0], p[2 * k + 1][1]);
    pf[k][3] = pack_bf16(p[2 * k + 1][2], p[2 * k + 1][3]);
  }
}

// O (16 rows x D) += P (16 x 64 keys, bf16) · V over a 64-key shared tile;
// o[n] holds columns 8n .. 8n + 7
template <int D>
__device__ __forceinline__ void pv_tile(float (&o)[D / 8][4], const uint32_t (&pf)[4][4],
                                        const __nv_bfloat16* vs, int lane) {
  const __nv_bfloat16* p = vs + ((lane & 7) + ((lane >> 3) & 1) * 8) * (D + 8) + (lane >> 4) * 8;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, p + k * 16 * (D + 8) + n * 16);
      mma_bf16(o[2 * n], pf[k], b[0], b[1]);
      mma_bf16(o[2 * n + 1], pf[k], b[2], b[3]);
    }
  }
}

// a warp's O rows → bf16(o / l) in its 16 rows of a shared staging tile (row
// stride D + 8); l0, l1: the divisors of rows lane/4 and lane/4 + 8
template <int D>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* rows, const float (&o)[D / 8][4],
                                           float l0, float l1, int lane) {
  __nv_bfloat16* p = rows + (lane >> 2) * (D + 8) + (lane & 3) * 2;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    *reinterpret_cast<__nv_bfloat162*>(p + n * 8) = __floats2bfloat162_rn(o[n][0] / l0, o[n][1] / l0);
    *reinterpret_cast<__nv_bfloat162*>(p + 8 * (D + 8) + n * 8) =
        __floats2bfloat162_rn(o[n][2] / l1, o[n][3] / l1);
  }
}

// the staging tile's rows [0, 64) → global rows r0 .. (row stride `stride`
// elements), 16 bytes a store; rows at or past n_rows are not written
template <int D>
__device__ __forceinline__ void store_tile(__nv_bfloat16* dst, long long stride,
                                           const __nv_bfloat16* st, int r0, int n_rows) {
  constexpr int C = D / 8, LD = D + 8, ROWS = MMA_THREADS / C;
  const int r = threadIdx.x / C, c = (threadIdx.x % C) * 8;
  __nv_bfloat16* d = dst + (long long)(r0 + r) * stride + c;
#pragma unroll
  for (int i = 0; i < MMA_TILE / ROWS; ++i)
    if (r0 + r + i * ROWS < n_rows)
      *reinterpret_cast<uint4*>(d + (long long)i * ROWS * stride) =
          *reinterpret_cast<const uint4*>(st + (r + i * ROWS) * LD + c);
}

// shared memory of the tiles: Q (later the output staging tile), then K
// and V, two stages each
template <int D>
constexpr size_t mma_tiles_bytes() {
  return sizeof(__nv_bfloat16) * 5 * MMA_TILE * (D + 8);
}

}  // namespace
