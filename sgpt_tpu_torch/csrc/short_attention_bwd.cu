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
// What bounds it on this card: one head's (T, T) fp32 tile is 360 KB at
// T=300, more than the 227 KB of shared memory a block may use, so the TPU's
// tile-per-head layout cannot carry over; dQ reduces along rows of P while
// dK and dV reduce along its columns, and blocks share nothing; and, kept in
// fp32 on the CUDA cores (TF32 would round q and k), the products are bound
// by shared-memory loads rather than by the FMAs. The design is
// deterministic, with no atomics, in two passes:
//   * rows_kernel, one block per (batch row, head, BQ=16 query rows): the
//     score strip and softmax over the key tiles the 16 rows can reach
//     (causal, window; the rest of each row is masked and enters the softmax
//     sum by count), then D = rowsum(dP∘P) in one sweep over those V tiles
//     and dS in a second (dP is recomputed, not kept: a second BQ x T strip
//     would not fit at T=2048), then dQ = dS·K. It stores each row's max m,
//     sum l and D: 3·B·H·T floats (1.4 MB at B=32, T=300, H=12).
//   * cols_kernel, one block per (batch row, head, BKB=16 keys): walks the
//     query tiles, rebuilds P = expf(s − m) / l — the expression the row
//     softmax evaluates, on scores summed in the same order, so both passes
//     see the same P bit for bit — and accumulates dV and dK. A query tile
//     none of whose rows can reach the key strip is skipped unless one of
//     its rows is fully masked, since that row's P is not 0.
// Head rows are zero-padded to Dhp, a multiple of 4, in shared memory, so
// every inner product reads 128-bit vectors: 5 shared loads per 16 FMAs in
// the score, dP and dQ sweeps, and 10 per 32 in the dK/dV accumulation.
// wgmma, TMA, tensor-core fp32 emulation and a fused single pass are later work.

#include "short_attention.cuh"

namespace {

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
  if (B < 1 || T < 1 || H < 1 || Dh < 1 || Dh > MAX_DH || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Mask mask{key_mask, slopes, segments, kpos, scale, window, use_alibi};
  if (is_bf16) return (int)launch<bf16>(q, k, v, g, dq, dk, dv, stats, mask, B, T, H, Dh, st);
  return (int)launch<float>(q, k, v, g, dq, dk, dv, stats, mask, B, T, H, Dh, st);
}
