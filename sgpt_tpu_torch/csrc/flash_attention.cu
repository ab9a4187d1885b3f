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
// What bounds it on this card: at the long-context encode shape (B=64,
// T=2048, H=12, Dh=64, bf16) a global layer needs 412.5 GFLOP for 805 MB of
// q/k/v/o (compute bound, 0.417 ms at 989 TFLOP/s) and a window-256 layer
// 96.7 GFLOP (memory bound, 0.242 ms at 3.35 TB/s). The design answers the
// compute side with tensor cores and the memory side by reading each K/V
// tile once per 64 query rows from L2-friendly order:
//   * flash_fwd_bf16<D>: one block of 4 warps per (64 query rows, head, batch
//     row); each warp owns 16 query rows. Q·Kᵀ and P·V run on the tensor
//     cores (WMMA 16x16x16 bf16, fp32 accumulators); the scores go through
//     shared memory for the masked online softmax (one warp per row group,
//     m and l in registers); the fp32 accumulator lives in shared memory and
//     is rescaled by exp(m_prev − m_new) per sub-tile, as acc·alpha + P·V.
//   * flash_fwd_f32<D>: the same walk with exact fp32 products on the CUDA cores
//     (no TF32), the accumulator in registers.
// Both skip the sub-tiles that cannot change any row of the block (see Walk).
// wgmma, TMA, warp specialisation and keeping S and P in registers are later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include "flash_attention.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int TQ = SUB;       // query rows per block
constexpr int TK = SUB;       // keys per sub-tile
constexpr int WARPS = 4;      // each warp owns TQ / WARPS = 16 query rows
constexpr int NTHREADS = 32 * WARPS;
constexpr int WR = TQ / WARPS;
static_assert(TQ == TK, "load_tile moves 64-row tiles of Q, K and V alike");

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

__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(bf16* p, float x) { *p = __float2bfloat16(x); }

// rows [0, 64) of one head starting at src (row stride st elements, D
// contiguous values each) → shared tile dst (row stride ld), 16 bytes per load.
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* src, long long st) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int NV = D / VEC;
  for (int e = threadIdx.x; e < TQ * NV; e += NTHREADS) {
    const int r = e / NV, c = (e - r * NV) * VEC;
    const uint4 val = *reinterpret_cast<const uint4*>(src + r * st + c);
    if ((ld * sizeof(T)) % 16 == 0) {
      *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
    } else {
      const T* x = reinterpret_cast<const T*>(&val);
#pragma unroll
      for (int i = 0; i < VEC; ++i) dst[r * ld + c + i] = x[i];
    }
  }
}

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
  // the block-wide barrier that starts each sub-tile; false: skip it
  __device__ bool begin(const Params& p, int k0, int key_mask) const {
    const bool any_key = __syncthreads_or(key_mask != 0);
    const bool masked = !any_key || !subtile_in_range(q0, k0, p.window);
    return !(all_live && masked);
  }
};

// One warp, its 16 query rows (query position qrow0 + r), one sub-tile of TK
// keys at k0: raw dot products S (row stride lds) → scale, ALiBi, mask →
// online-softmax update of m and l (registers, the same in every lane).
// alpha[r] = exp(m_prev − m_new); p goes to put(r, key, p).
template <typename Put>
__device__ __forceinline__ void online_softmax(const float* S, int lds, const int* kms,
                                               const Params& p, float slope, int qrow0, int k0,
                                               float (&m)[WR], float (&l)[WR], float (&alpha)[WR],
                                               int lane, Put put) {
#pragma unroll
  for (int r = 0; r < WR; ++r) {
    const int qpos = qrow0 + r;
    float s[TK / 32];
    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < TK / 32; ++j) {
      const int kk = lane + 32 * j, kpos = k0 + kk;
      const float x = score(S[r * lds + kk], p.scale, p.slopes != nullptr, slope, kpos);
      const bool ok = (kms[kk] != 0) & in_range(qpos, kpos, p.window);
      s[j] = ok ? x : NEG_INF;
      mx = fmaxf(mx, s[j]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float m_new = fmaxf(m[r], mx);
    alpha[r] = expf(m[r] - m_new);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < TK / 32; ++j) {
      const float e = expf(s[j] - m_new);
      sum += e;
      put(r, lane + 32 * j, e);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    l[r] = __fadd_rn(__fmul_rn(l[r], alpha[r]), sum);
    m[r] = m_new;
  }
}

// out rows of this warp = acc / l (l == 0 → 1), lse = m + log(l).
template <typename T, typename Acc>
__device__ __forceinline__ void finalize(const Params& p, int b, int h, int qrow0,
                                         const float (&m)[WR], const float (&l)[WR], int lane,
                                         int D, Acc acc) {
  T* ob = static_cast<T*>(p.o) + b * p.ob + h * p.oh;
#pragma unroll
  for (int r = 0; r < WR; ++r) {
    const float lr = l[r] == 0.f ? 1.f : l[r];
    T* orow = ob + (qrow0 + r) * p.ot;
    for (int c = lane; c < D; c += 32) store_out(orow + c, acc(r, c) / lr);
    if (lane == 0)
      p.lse[((long long)b * p.H + h) * p.T + qrow0 + r] = __fadd_rn(m[r], logf(lr));
  }
}

template <int D>
__global__ void __launch_bounds__(NTHREADS) flash_fwd_bf16(const Params p) {
  using namespace nvcuda;
  constexpr int LDH = D + 8;                     // bf16 tiles: 16-byte rows, staggered banks
  constexpr int LDS = (TK > D ? TK : D) + 4;     // fp32 scores, later the P·V partials
  constexpr int LDP = TK + 8;                    // bf16 probabilities
  constexpr int LDO = D + 4;                     // fp32 accumulator
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + TQ * LDH;
  bf16* Vs = Ks + TK * LDH;
  bf16* Ps = Vs + TK * LDH;
  float* Ss = reinterpret_cast<float*>(Ps + TQ * LDP);
  float* Os = Ss + TQ * LDS;
  int* kms = reinterpret_cast<int*>(Os + TQ * LDO);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * TQ, h = blockIdx.y, b = blockIdx.z;
  const long long base = b * p.sb + h * p.sh;
  const bf16* qg = static_cast<const bf16*>(p.q) + base;
  const bf16* kg = static_cast<const bf16*>(p.k) + base;
  const bf16* vg = static_cast<const bf16*>(p.v) + base;
  const int* kmg = p.key_mask + (long long)b * p.T;
  const float slope = p.slopes != nullptr ? p.slopes[h] : 0.f;

  load_tile<bf16, D>(Qs, LDH, qg + q0 * p.st, p.st);
  for (int e = threadIdx.x; e < TQ * LDO; e += NTHREADS) Os[e] = 0.f;
  float m[WR], l[WR], alpha[WR];
#pragma unroll
  for (int r = 0; r < WR; ++r) m[r] = NEG_INF, l[r] = 0.f;

  float* Sw = Ss + warp * WR * LDS;
  bf16* Pw = Ps + warp * WR * LDP;
  float* Ow = Os + warp * WR * LDO;
  const int qrow0 = q0 + warp * WR;
  const Walk walk(p, q0, kmg);
  for (int ki = 0; ki <= walk.last; ++ki) {
    if (!walk.visits(p, ki)) continue;
    for (int k0 = ki * p.block_kv; k0 < (ki + 1) * p.block_kv; k0 += TK) {
      const int km = threadIdx.x < TK ? kmg[k0 + threadIdx.x] : 0;
      if (!walk.begin(p, k0, km)) continue;  // barrier: Q written / previous K, V consumed
      load_tile<bf16, D>(Ks, LDH, kg + k0 * p.st, p.st);
      load_tile<bf16, D>(Vs, LDH, vg + k0 * p.st, p.st);
      if (threadIdx.x < TK) kms[threadIdx.x] = km;
      __syncthreads();
      // S (16 rows x TK keys of this warp) = Q Kᵀ
#pragma unroll
      for (int j = 0; j < TK / 16; ++j) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        wmma::fill_fragment(acc, 0.f);
#pragma unroll
        for (int d = 0; d < D; d += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kt;
          wmma::load_matrix_sync(a, Qs + warp * WR * LDH + d, LDH);
          wmma::load_matrix_sync(kt, Ks + j * 16 * LDH + d, LDH);
          wmma::mma_sync(acc, a, kt, acc);
        }
        wmma::store_matrix_sync(Sw + j * 16, acc, LDS, wmma::mem_row_major);
      }
      __syncwarp();
      online_softmax(Sw, LDS, kms, p, slope, qrow0, k0, m, l, alpha, lane,
                     [&](int r, int kk, float e) { Pw[r * LDP + kk] = __float2bfloat16(e); });
      __syncwarp();
      // P·V (P rounded to bf16) into the warp's score rows, then acc·alpha + P·V
#pragma unroll
      for (int c = 0; c < D / 16; ++c) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> pv;
        wmma::fill_fragment(pv, 0.f);
#pragma unroll
        for (int ks = 0; ks < TK / 16; ++ks) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vt;
          wmma::load_matrix_sync(a, Pw + ks * 16, LDP);
          wmma::load_matrix_sync(vt, Vs + ks * 16 * LDH + c * 16, LDH);
          wmma::mma_sync(pv, a, vt, pv);
        }
        wmma::store_matrix_sync(Sw + c * 16, pv, LDS, wmma::mem_row_major);
      }
      __syncwarp();
#pragma unroll
      for (int r = 0; r < WR; ++r)
        for (int c = lane; c < D; c += 32)
          Ow[r * LDO + c] = __fadd_rn(__fmul_rn(Ow[r * LDO + c], alpha[r]), Sw[r * LDS + c]);
    }
  }
  __syncwarp();
  finalize<bf16>(p, b, h, qrow0, m, l, lane, D,
                 [&](int r, int c) { return Ow[r * LDO + c]; });
}

template <int D>
__global__ void __launch_bounds__(NTHREADS) flash_fwd_f32(const Params p) {
  constexpr int LDQ = D;          // read as a broadcast: no padding needed
  constexpr int LDK = D + 1;      // lanes read 32 different keys: odd stride
  constexpr int LDV = D;          // lanes read consecutive columns
  constexpr int LDS = TK + 1;
  constexpr int NC = (D + 31) / 32;  // accumulator columns per lane
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Vs = Qs + TQ * LDQ;
  float* Ks = Vs + TK * LDV;
  float* Ss = Ks + TK * LDK;
  int* kms = reinterpret_cast<int*>(Ss + TQ * LDS);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * TQ, h = blockIdx.y, b = blockIdx.z;
  const long long base = b * p.sb + h * p.sh;
  const float* qg = static_cast<const float*>(p.q) + base;
  const float* kg = static_cast<const float*>(p.k) + base;
  const float* vg = static_cast<const float*>(p.v) + base;
  const int* kmg = p.key_mask + (long long)b * p.T;
  const float slope = p.slopes != nullptr ? p.slopes[h] : 0.f;

  load_tile<float, D>(Qs, LDQ, qg + q0 * p.st, p.st);
  float m[WR], l[WR], alpha[WR], o[WR][NC];
#pragma unroll
  for (int r = 0; r < WR; ++r) {
    m[r] = NEG_INF, l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < NC; ++j) o[r][j] = 0.f;
  }

  float* Sw = Ss + warp * WR * LDS;
  const float* Qw = Qs + warp * WR * LDQ;
  const int qrow0 = q0 + warp * WR;
  const Walk walk(p, q0, kmg);
  for (int ki = 0; ki <= walk.last; ++ki) {
    if (!walk.visits(p, ki)) continue;
    for (int k0 = ki * p.block_kv; k0 < (ki + 1) * p.block_kv; k0 += TK) {
      const int km = threadIdx.x < TK ? kmg[k0 + threadIdx.x] : 0;
      if (!walk.begin(p, k0, km)) continue;
      load_tile<float, D>(Ks, LDK, kg + k0 * p.st, p.st);
      load_tile<float, D>(Vs, LDV, vg + k0 * p.st, p.st);
      if (threadIdx.x < TK) kms[threadIdx.x] = km;
      __syncthreads();
      // S: lane -> keys lane and lane + 32 of the warp's 16 rows, fp32 FMAs
      float s[WR][TK / 32];
#pragma unroll
      for (int r = 0; r < WR; ++r)
#pragma unroll
        for (int j = 0; j < TK / 32; ++j) s[r][j] = 0.f;
      for (int d = 0; d < D; ++d) {
        float kd[TK / 32];
#pragma unroll
        for (int j = 0; j < TK / 32; ++j) kd[j] = Ks[(lane + 32 * j) * LDK + d];
#pragma unroll
        for (int r = 0; r < WR; ++r) {
          const float qv = Qw[r * LDQ + d];
#pragma unroll
          for (int j = 0; j < TK / 32; ++j) s[r][j] = fmaf(qv, kd[j], s[r][j]);
        }
      }
#pragma unroll
      for (int r = 0; r < WR; ++r)
#pragma unroll
        for (int j = 0; j < TK / 32; ++j) Sw[r * LDS + lane + 32 * j] = s[r][j];
      __syncwarp();
      online_softmax(Sw, LDS, kms, p, slope, qrow0, k0, m, l, alpha, lane,
                     [&](int r, int kk, float e) { Sw[r * LDS + kk] = e; });
      __syncwarp();
      // P·V: lane -> columns lane + 32 j of the warp's 16 rows
      float pv[WR][NC];
#pragma unroll
      for (int r = 0; r < WR; ++r)
#pragma unroll
        for (int j = 0; j < NC; ++j) pv[r][j] = 0.f;
      for (int kk = 0; kk < TK; ++kk) {
        float vk[NC];
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          const int c = lane + 32 * j;
          vk[j] = c < D ? Vs[kk * LDV + c] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < WR; ++r) {
          const float pr = Sw[r * LDS + kk];
#pragma unroll
          for (int j = 0; j < NC; ++j) pv[r][j] = fmaf(pr, vk[j], pv[r][j]);
        }
      }
#pragma unroll
      for (int r = 0; r < WR; ++r)
#pragma unroll
        for (int j = 0; j < NC; ++j) o[r][j] = __fadd_rn(__fmul_rn(o[r][j], alpha[r]), pv[r][j]);
      __syncwarp();
    }
  }
  finalize<float>(p, b, h, qrow0, m, l, lane, D,
                  [&](int r, int c) {
                    float x = 0.f;
#pragma unroll
                    for (int j = 0; j < NC; ++j)
                      if (c == lane + 32 * j) x = o[r][j];
                    return x;
                  });
}

template <int D>
size_t bf16_smem() {
  constexpr int LDH = D + 8, LDS = (TK > D ? TK : D) + 4, LDP = TK + 8, LDO = D + 4;
  return sizeof(bf16) * ((size_t)(TQ + 2 * TK) * LDH + (size_t)TQ * LDP) +
         sizeof(float) * ((size_t)TQ * LDS + (size_t)TQ * LDO) + sizeof(int) * TK;
}

template <int D>
size_t f32_smem() {
  return sizeof(float) * ((size_t)TQ * D + (size_t)TK * D + (size_t)TK * (D + 1) +
                          (size_t)TQ * (TK + 1)) + sizeof(int) * TK;
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
  return is_bf16 ? launch(flash_fwd_bf16<D>, bf16_smem<D>(), grid, st, p)
                 : launch(flash_fwd_f32<D>, f32_smem<D>(), grid, st, p);
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
    default: return (int)cudaErrorInvalidValue;
  }
}
