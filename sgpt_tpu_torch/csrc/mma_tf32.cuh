// Warp-level tensor-core building blocks of K1's fp32 forward
// (short_attention.cu, `tf32_kernel`, at Dh 256 `tf32_kernel_wide`), K2's
// fp32 backward (short_attention_bwd.cu, `tf32_rows` and `tf32_cols`, at Dh
// 256 `tf32_rows_wide` and `tf32_cols_wide`) and K3's fp32 forward
// (flash_attention.cu, `flash_fwd_tf32`): 3xTF32 products on
// `mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32`.
//
// 3xTF32. Each fp32 operand x splits into big = tf32(x) and small =
// tf32(x − big) (`cvt.rna`: round to nearest, ties away from zero), and a
// product is a_s·b_b + a_b·b_s + a_b·b_b, accumulated in fp32, the small
// terms first, each 8-deep step's three into a fresh accumulator that is
// then added to the running sum (mma_3xtf32). The dropped a_s·b_s and the
// rounding of small leave about 22 of fp32's 24 significand bits; one TF32
// product keeps 11.
//
// Fragments. In the m16n8k8 tf32 layout lane l (g = l/4, t = l%4) holds A
// at (row g, column t), (g + 8, t), (g, t + 4), (g + 8, t + 4), B at (row
// t, column g) and (t + 4, g), and the accumulator at (g, 2t), (g, 2t + 1),
// (g + 8, 2t), (g + 8, 2t + 1): the m16n8 layout of the bf16 m16n8k16
// accumulator, so k1_scores, k3_scores, quad_max and quad_sum read it
// unchanged.
// `ldmatrix` moves 16-bit elements (its .trans would split an fp32 value),
// so K and V fragments are plain 32-bit shared loads from tiles of row
// stride D + 4 floats: for QKᵀ lane l reads K[g][t] and K[g][t + 4], for
// P·V V rows 2t and 2t + 1 at column g, and both land in 32 distinct banks.
//
// P from S without a shuffle. The accumulator holds keys 2t and 2t + 1 of
// each 8-key n-tile, where a tf32 A fragment wants columns t and t + 4. So
// P·V takes the 8 keys of each k-step in a permuted order: A column t is key
// 2t and column t + 4 key 2t + 1, and B's rows t and t + 4 are V rows 2t and
// 2t + 1. The S registers are then P's A fragment as they stand; only the
// order in which the 8 products are summed changes.
#pragma once

#include "mma_attention.cuh"

namespace {

// `cvt.rna.tf32.f32` of a finite x: a half unit of the 10th stored mantissa
// bit added to the magnitude, the 13 bits below it cleared (round to
// nearest, ties away from zero; a carry moves into the exponent). Two
// integer instructions, where the cvt compiles to a longer sequence.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x → (big, small) = (tf32(x), tf32(x − big))
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

// d += a · b: one 16 x 8 x 8 TF32 product with fp32 accumulation
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a · b in 3xTF32, from the split operands: the three products, small
// terms first, into a zeroed accumulator whose sum is then added to d by an
// fp32 add (round to nearest). The tensor cores' own additions lose the low
// bits of the sum (relative to its largest term); into d directly, each of
// the 3 · Dh / 8 products of a score would lose them relative to the whole
// running score, which moved K1's ALiBi case past its fp32 gate.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4], uint32_t bb0, uint32_t bb1,
                                           uint32_t bs0, uint32_t bs1) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(t, as, bb0, bb1);
  mma_tf32(t, ab, bs0, bs1);
  mma_tf32(t, ab, bb0, bb1);
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] += t[e];
}

// rows [r0, r0 + R) of an fp32 array (row stride `stride` elements, D
// contiguous values a row) → a shared tile of row stride D + 4, by NTH
// threads; rows at or past n_rows are zero-filled. 16 bytes a copy; the
// caller commits the group.
template <int D, int R = MMA_TILE, int NTH = MMA_THREADS>
__device__ __forceinline__ void load_tile_async_f32(float* dst, const float* src,
                                                    long long stride, int r0, int n_rows) {
  constexpr int C = D / 4, LD = D + 4, ROWS = NTH / C;
  static_assert(R % ROWS == 0, "whole rows a pass");
  const int r = r0 + threadIdx.x / C, c = (threadIdx.x % C) * 4;
  const float* s = src + (long long)r * stride + c;
  float* d = dst + (threadIdx.x / C) * LD + c;
#pragma unroll
  for (int i = 0; i < R / ROWS; ++i) {
    const bool ok = r + i * ROWS < n_rows;
    cp_async16(d + i * ROWS * LD, ok ? s + (long long)i * ROWS * stride : src, ok);
  }
}

// The 16-byte chunks of a tile that this thread copied (load_tile_async_f32's
// mapping), once its copies have landed: x → big in place and small into
// the same place of `small`. Each thread splits only what it copied, so
// this needs no barrier of its own, and each value is split once for the
// block instead of once a warp.
template <int D>
__device__ __forceinline__ void split_own_chunks(float* tile, float* small) {
  constexpr int C = D / 4, LD = D + 4, ROWS = MMA_THREADS / C;
  const int at = (threadIdx.x / C) * LD + (threadIdx.x % C) * 4;
#pragma unroll
  for (int i = 0; i < MMA_TILE / ROWS; ++i) {
    float4* x = reinterpret_cast<float4*>(tile + at + i * ROWS * LD);
    const float4 v = *x;
    uint4 big, sm;
    split_tf32(v.x, big.x, sm.x);
    split_tf32(v.y, big.y, sm.y);
    split_tf32(v.z, big.z, sm.z);
    split_tf32(v.w, big.w, sm.w);
    *reinterpret_cast<uint4*>(x) = big;
    *reinterpret_cast<uint4*>(small + at + i * ROWS * LD) = sm;
  }
}

// the split A fragments of k-step d (columns 8d .. 8d + 7) of a warp's 16
// rows of a shared fp32 tile (row stride D + 4)
template <int D>
__device__ __forceinline__ void a_frag_3xtf32(uint32_t (&big)[4], uint32_t (&small)[4],
                                              const float* rows, int d, int lane) {
  const float* p = rows + (lane >> 2) * (D + 4) + 8 * d + (lane & 3);
  split_tf32(p[0], big[0], small[0]);
  split_tf32(p[8 * (D + 4)], big[1], small[1]);
  split_tf32(p[4], big[2], small[2]);
  split_tf32(p[8 * (D + 4) + 4], big[3], small[3]);
}

// S (16 rows x 64 keys) += Q · Kᵀ over k-step d of a 64-key K tile split into
// kb (big) and ksm (small) (row stride D + 4), from Q's split A fragments of
// that step; s[n] holds keys 8n .. 8n + 7
template <int D>
__device__ __forceinline__ void qk_step_3xtf32(float (&s)[8][4], const uint32_t (&ab)[4],
                                               const uint32_t (&as)[4], const float* kb,
                                               const float* ksm, int d, int lane) {
  const int at = (lane >> 2) * (D + 4) + 8 * d + (lane & 3);
  const uint32_t* b = reinterpret_cast<const uint32_t*>(kb) + at;
  const uint32_t* sm = reinterpret_cast<const uint32_t*>(ksm) + at;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int r = n * 8 * (D + 4);
    mma_3xtf32(s[n], ab, as, b[r], b[r + 4], sm[r], sm[r + 4]);
  }
}

// O (16 rows x D) += P (16 x 64 keys, fp32 in the accumulator layout) · V
// over a 64-key V tile split into vb (big) and vsm (small) (row stride D +
// 4), keys permuted within each 8-key step as the note at the top says; o[n]
// holds columns 8n .. 8n + 7
template <int D>
__device__ __forceinline__ void pv_tile_3xtf32(float (&o)[D / 8][4], const float (&p)[8][4],
                                               const float* vb, const float* vsm, int lane) {
  const int at = 2 * (lane & 3) * (D + 4) + (lane >> 2);
  const uint32_t* b = reinterpret_cast<const uint32_t*>(vb) + at;
  const uint32_t* sm = reinterpret_cast<const uint32_t*>(vsm) + at;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    uint32_t ab[4], as[4];
    split_tf32(p[j][0], ab[0], as[0]);  // (g, key 2t)
    split_tf32(p[j][2], ab[1], as[1]);  // (g + 8, key 2t)
    split_tf32(p[j][1], ab[2], as[2]);  // (g, key 2t + 1)
    split_tf32(p[j][3], ab[3], as[3]);  // (g + 8, key 2t + 1)
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int r0 = 8 * j * (D + 4) + 8 * n, r1 = r0 + D + 4;  // V rows 8j + 2t, 8j + 2t + 1
      mma_3xtf32(o[n], ab, as, b[r0], b[r1], sm[r0], sm[r1]);
    }
  }
}

// K2's cols pass (short_attention_bwd.cu, `tf32_cols`) computes Sᵀ = K·Qᵀ
// with K as A, where the rows pass and K1 compute S = Q·Kᵀ with Q as A. Its
// three products take the same terms in the same order as mma_3xtf32 does
// with the operands' roles swapped (q_s·k_b, q_b·k_s, q_b·k_b), so that
// both passes add the same numbers in the same order into a score.
__device__ __forceinline__ void mma_3xtf32_swapped(float (&d)[4], const uint32_t (&ab)[4],
                                                   const uint32_t (&as)[4], uint32_t bb0,
                                                   uint32_t bb1, uint32_t bs0, uint32_t bs1) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(t, ab, bs0, bs1);
  mma_tf32(t, as, bb0, bb1);
  mma_tf32(t, ab, bb0, bb1);
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] += t[e];
}

// qk_step_3xtf32 over 8N rows of the B tile instead of 64: S (16 rows x 8N)
// += A · Bᵀ over k-step d, B split into big and small parts (row stride
// D + 4). SWAPPED: the products in mma_3xtf32_swapped's order (K2's cols
// pass, whose A is K and B is Q)
template <int D, int N, bool SWAPPED = false>
__device__ __forceinline__ void qk_part_3xtf32(float (&s)[N][4], const uint32_t (&ab)[4],
                                               const uint32_t (&as)[4], const float* big,
                                               const float* small, int d, int lane) {
  const int at = (lane >> 2) * (D + 4) + 8 * d + (lane & 3);
  const uint32_t* b = reinterpret_cast<const uint32_t*>(big) + at;
  const uint32_t* sm = reinterpret_cast<const uint32_t*>(small) + at;
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const int r = n * 8 * (D + 4);
    if (SWAPPED)
      mma_3xtf32_swapped(s[n], ab, as, b[r], b[r + 4], sm[r], sm[r + 4]);
    else
      mma_3xtf32(s[n], ab, as, b[r], b[r + 4], sm[r], sm[r + 4]);
  }
}

// pv_tile_3xtf32 over 8J rows of the B tile (J k-steps) instead of 64: O
// (16 rows x D) += P (16 x 8J, the accumulator layout) · V (8J rows)
template <int D, int J>
__device__ __forceinline__ void pv_part_3xtf32(float (&o)[D / 8][4], const float (&p)[J][4],
                                               const float* vb, const float* vsm, int lane) {
  const int at = 2 * (lane & 3) * (D + 4) + (lane >> 2);
  const uint32_t* b = reinterpret_cast<const uint32_t*>(vb) + at;
  const uint32_t* sm = reinterpret_cast<const uint32_t*>(vsm) + at;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    uint32_t ab[4], as[4];
    split_tf32(p[j][0], ab[0], as[0]);
    split_tf32(p[j][2], ab[1], as[1]);
    split_tf32(p[j][1], ab[2], as[2]);
    split_tf32(p[j][3], ab[3], as[3]);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int r0 = 8 * j * (D + 4) + 8 * n, r1 = r0 + D + 4;
      mma_3xtf32(o[n], ab, as, b[r0], b[r1], sm[r0], sm[r1]);
    }
  }
}

// qk_part_3xtf32 from an unsplit fp32 B tile (row stride D + 4): each lane
// splits the two values it reads for each n-tile, into the same big and
// small parts split_own_chunks stores, so the products are the same. The
// kernels at Dh 256 take this: their tiles have no room for the small parts
// (K3's flash_fwd_tf32<256> with N = 8, K1's tf32_kernel_wide, K2's
// tf32_rows_wide and, SWAPPED, tf32_cols_wide).
template <int D, int N, bool SWAPPED = false>
__device__ __forceinline__ void qk_part_3xtf32_unsplit(float (&s)[N][4], const uint32_t (&ab)[4],
                                                       const uint32_t (&as)[4], const float* rows,
                                                       int d, int lane) {
  const float* b = rows + (lane >> 2) * (D + 4) + 8 * d + (lane & 3);
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const int r = n * 8 * (D + 4);
    uint32_t bb0, bs0, bb1, bs1;
    split_tf32(b[r], bb0, bs0);
    split_tf32(b[r + 4], bb1, bs1);
    if (SWAPPED)
      mma_3xtf32_swapped(s[n], ab, as, bb0, bb1, bs0, bs1);
    else
      mma_3xtf32(s[n], ab, as, bb0, bb1, bs0, bs1);
  }
}

// pv_part_3xtf32 over C of the B tile's columns from an unsplit fp32 tile,
// each lane splitting the values it reads: O (16 rows x C) += P (16 x 8J,
// the accumulator layout) · B (8J rows; `rows` points at the first of the
// C columns, row stride D + 4)
template <int D, int J, int C = D>
__device__ __forceinline__ void pv_part_3xtf32_unsplit(float (&o)[C / 8][4],
                                                       const float (&p)[J][4], const float* rows,
                                                       int lane) {
  const float* b = rows + 2 * (lane & 3) * (D + 4) + (lane >> 2);
#pragma unroll
  for (int j = 0; j < J; ++j) {
    uint32_t ab[4], as[4];
    split_tf32(p[j][0], ab[0], as[0]);
    split_tf32(p[j][2], ab[1], as[1]);
    split_tf32(p[j][1], ab[2], as[2]);
    split_tf32(p[j][3], ab[3], as[3]);
#pragma unroll
    for (int n = 0; n < C / 8; ++n) {
      const int r0 = 8 * j * (D + 4) + 8 * n, r1 = r0 + D + 4;  // B rows 8j + 2t, 8j + 2t + 1
      uint32_t bb0, bs0, bb1, bs1;
      split_tf32(b[r0], bb0, bs0);
      split_tf32(b[r1], bb1, bs1);
      mma_3xtf32(o[n], ab, as, bb0, bb1, bs0, bs1);
    }
  }
}

// a warp's O rows (C columns) → its 16 rows of a shared fp32 staging tile
// (row stride D + 4; `rows` points at the first of the C columns)
template <int D, int C = D>
__device__ __forceinline__ void stage_rows_f32(float* rows, const float (&o)[C / 8][4],
                                               int lane) {
  float* p = rows + (lane >> 2) * (D + 4) + (lane & 3) * 2;
#pragma unroll
  for (int n = 0; n < C / 8; ++n) {
    *reinterpret_cast<float2*>(p + n * 8) = make_float2(o[n][0], o[n][1]);
    *reinterpret_cast<float2*>(p + 8 * (D + 4) + n * 8) = make_float2(o[n][2], o[n][3]);
  }
}

// the staging tile's rows [0, 64) → global rows r0 .. (row stride `stride`
// elements), 16 bytes a store, by NTH threads; rows at or past n_rows are
// not written
template <int D, int NTH = MMA_THREADS>
__device__ __forceinline__ void store_tile_f32(float* dst, long long stride, const float* st,
                                               int r0, int n_rows) {
  constexpr int C = D / 4, LD = D + 4, ROWS = NTH / C;
  const int r = threadIdx.x / C, c = (threadIdx.x % C) * 4;
  float* d = dst + (long long)(r0 + r) * stride + c;
#pragma unroll
  for (int i = 0; i < MMA_TILE / ROWS; ++i)
    if (r0 + r + i * ROWS < n_rows)
      *reinterpret_cast<float4*>(d + (long long)i * ROWS * stride) =
          *reinterpret_cast<const float4*>(st + (r + i * ROWS) * LD + c);
}

// A warp pair's sum over a product's depth (the kernels at Dh 256): warps
// w and w + 4 of a block each sum half of Dh's k-steps into the same
// accumulator tiles (lower: k-steps 0-15, upper: 16-31). The upper warp's
// partials go through the pair's slot of a shared buffer (one float4 a lane
// and n-tile) to the lower warp, which adds them (lower + upper, each half
// summed from zero in k-step order) and hands the sums back, so that both
// warps hold the same bits:
//   if (upper) pair_store(x, xs); pair_barrier(p);
//   if (!upper) pair_add(x, xs); pair_barrier(p); if (upper) pair_load(x, xs);
// xs: the slot's float4 of this lane and n-tile 0 (n-tile n at xs[32 n]).
template <int N>
__device__ __forceinline__ void pair_store(const float (&x)[N][4], float4* xs) {
#pragma unroll
  for (int n = 0; n < N; ++n) xs[32 * n] = make_float4(x[n][0], x[n][1], x[n][2], x[n][3]);
}

template <int N>
__device__ __forceinline__ void pair_add(float (&x)[N][4], float4* xs) {
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const float4 u = xs[32 * n];
    x[n][0] += u.x, x[n][1] += u.y, x[n][2] += u.z, x[n][3] += u.w;
    xs[32 * n] = make_float4(x[n][0], x[n][1], x[n][2], x[n][3]);
  }
}

template <int N>
__device__ __forceinline__ void pair_load(float (&x)[N][4], const float4* xs) {
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const float4 u = xs[32 * n];
    x[n][0] = u.x, x[n][1] = u.y, x[n][2] = u.z, x[n][3] = u.w;
  }
}

// the 64 threads of warp pair p (warps p and p + 4): named barrier 1 + p
__device__ __forceinline__ void pair_barrier(int p) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(1 + p) : "memory");
}

// The pair sum of two accumulator sets a and b (K2's S and dP, or Sᵀ and
// dPᵀ) through the pair's slot xs (a's n-tiles, then b's), with its own two
// barriers; the caller keeps the upper warp's next store after the lower
// warp's reads (a block barrier between two calls does).
template <int N>
__device__ __forceinline__ void pair_sum(float (&a)[N][4], float (&b)[N][4], float4* xs,
                                         bool upper, int p) {
  if (upper) {
    pair_store(a, xs);
    pair_store(b, xs + 32 * N);
  }
  pair_barrier(p);
  if (!upper) {
    pair_add(a, xs);
    pair_add(b, xs + 32 * N);
  }
  pair_barrier(p);
  if (upper) {
    pair_load(a, xs);
    pair_load(b, xs + 32 * N);
  }
}

// shared memory of the fp32 tiles: Q (later the output staging tile), K in
// two stages, V, and the small parts of one K and one V tile
template <int D>
constexpr size_t tf32_tiles_bytes() {
  return sizeof(float) * 6 * MMA_TILE * (D + 4);
}

}  // namespace
