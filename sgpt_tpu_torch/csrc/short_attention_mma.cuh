// K1's per-key-tile mask inputs and masked scores in the mma.sync
// accumulator layout, shared by K1's tensor-core forwards (short_attention.cu:
// `mma_kernel`, `tf32_kernel`) and K2's fp32 pair (short_attention_bwd.cu:
// `tf32_rows`), so that the backward masks exactly as the forward does.
#pragma once

#include "mma_attention.cuh"
#include "short_attention.cuh"

namespace {

// One key tile's mask inputs in shared memory, loaded once per tile with
// its K (and V) rows: key padding, and for the general variant segment ids
// and ALiBi key positions. Keys at or past T load as 0: padded.
struct KeyAux {
  int km[MMA_TILE], seg[MMA_TILE], kpos[MMA_TILE];
};

template <bool GENERAL>
__device__ __forceinline__ void load_aux_async(KeyAux* a, const Mask& m, int64_t row0, int k0,
                                               int T) {
  const int j = threadIdx.x % MMA_TILE;
  const bool ok = k0 + j < T;
  const int64_t at = row0 + (ok ? k0 + j : 0);
  if (threadIdx.x < MMA_TILE) {
    cp_async4(a->km + j, m.key_mask + at, ok);
  } else if (GENERAL) {
    if (m.segments != nullptr) cp_async4(a->seg + j, m.segments + at, ok);
    if (m.kpos != nullptr) cp_async4(a->kpos + j, m.kpos + at, ok);
  }
}

// S of a warp's 16 rows and one 64-key tile at k0 → K1's masked scores
// (masked_score of short_attention.cuh: × scale, exact when it is 1; ALiBi
// with two roundings; where(mask, s, -1e9)) from the tile's shared mask
// inputs. A key at or past T is padded, so masked; the caller corrects l
// for it. MASK = false: every pair is known to be allowed. GENERAL = false:
// no ALiBi and no segments. qi[r], segq[r]: the query position and segment
// id of rows lane/4 and lane/4 + 8. Returns the rows' maxima. K2's rows pass
// (short_attention_bwd.cu) takes the tile in parts of N < 8 n-tiles: the
// part's first key is k0, key `at` of the tile whose mask inputs `a` holds.
template <bool MASK, bool GENERAL, int N = 8>
__device__ __forceinline__ float2 k1_scores(float (&s)[N][4], const Mask& m, float slope,
                                            const int (&qi)[2], const int (&segq)[2], int k0,
                                            const KeyAux* a, int lane, int at = 0) {
  const int c0 = (lane & 3) * 2;  // the lane's first column in each 8-key n-tile
  float ab[N][2];                  // per column: ALiBi term, liveness, segment id
  bool live[N][2];
  int sk[N][2];
#pragma unroll
  for (int n = 0; n < N; ++n) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int kk = n * 8 + c0 + j;
      if (GENERAL && m.use_alibi)  // two roundings, as the plain version: no FMA
        ab[n][j] = __fmul_rn(slope, (float)(m.kpos ? a->kpos[at + kk] : k0 + kk));
      if (MASK) live[n][j] = a->km[at + kk] > 0;
      if (MASK && GENERAL && m.segments != nullptr) sk[n][j] = a->seg[at + kk];
    }
  }
  // causal ∧ window as column bounds: allowed iff lo[r] < column - c0 ≤ hi[r]
  int hi[2], lo[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    hi[r] = qi[r] - k0 - c0;
    lo[r] = m.window > 0 ? qi[r] - m.window - k0 - c0 : -(1 << 30);
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int n = 0; n < N; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1, j = e & 1, c = n * 8 + j;
      float x = s[n][e] * m.scale;
      if (GENERAL && m.use_alibi) x = __fadd_rn(x, ab[n][j]);
      if (MASK) {
        bool ok = live[n][j] & (c <= hi[r]) & (c > lo[r]);
        if (GENERAL && m.segments != nullptr) ok = ok & (sk[n][j] == segq[r]);
        x = ok ? x : NEG;
      }
      s[n][e] = x;
      mx[r] = fmaxf(mx[r], x);
    }
  }
  return make_float2(quad_max(mx[0]), quad_max(mx[1]));
}

}  // namespace
