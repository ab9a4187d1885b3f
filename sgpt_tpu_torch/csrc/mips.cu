// Streaming exact MIPS top-k for Hopper (compiled for sm_90a).
//
// Replaces sgpt_tpu/ops/pallas/mips.py::_mips_kernel, the TPU kernel behind
// DenseIndex(kernel="pallas"), and computes what it computes: for each query,
// the k ≤ 16 corpus rows of highest inner product among the first
// `valid` rows, in the total order (score desc, row index asc), with fp32
// scores. The (Q, N) score matrix never reaches device memory.
//
// What bounds it on this card: reading the corpus. At the main shape (NQ's
// 2,681,468 rows × 768 bf16 = 4.1 GB, Q = 64) one search must stream 4.1 GB,
// 1.2 ms at the H100's 3.35 TB/s; the products are 264 GFLOP, which the
// tensor cores do in less. On the TPU the corpus tile index is a sequential
// grid axis and the running top-k lives in VMEM across it. Blocks on the card
// run in no order, so the scan is two passes:
//   * pass 1 (scan_wmma for bf16 with D % 16 == 0, scan_simt otherwise): grid
//     (query blocks × corpus splits). A block keeps QB queries in shared
//     memory and streams its split of the corpus in tiles of TN rows,
//     D-chunk by D-chunk, with 16-byte coalesced loads; the next chunk's loads
//     start, into registers, before the current chunk is multiplied. bf16
//     products go to the tensor cores (WMMA 16x16x16, fp32 accumulators: a
//     bf16 product is exact in fp32, so only the summation order differs from
//     the plain version); fp32 inputs stay on the CUDA cores (no TF32). Each
//     query's running top-k is kept in shared memory by one warp: a ballot
//     finds the tile's scores above the current k-th, and each is inserted
//     in order. Rows are scanned in increasing index, so an equal score never
//     displaces an entry (the entry has the lower index). Output: (splits, Q,
//     k) candidates, each split's list in the total order.
//   * pass 2 (merge_kernel): one block per query selects the k first of the
//     splits·k candidates in the same total order, so the result does not
//     depend on the number of splits.
// Shared memory bounds QB: the queries take QB·(D+8)·2 bytes in bf16, so QB
// is 64 at D = 768 and 32 at D = 2048 and 2560, and the corpus is read
// ceil(Q / QB) times. Slots that no valid row fills (valid < k) hold -1e30
// with index 0 (the TPU kernel repeats a masked column's index there).
// wgmma, TMA, a deeper pipeline and tuning are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <mma.h>

#include <climits>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int K_MAX = 16;
constexpr float NEG = -1e30f;      // the TPU kernel's mask value
constexpr size_t SMEM_MAX = 232448;  // 227 KB, a block's dynamic shared memory on sm_90
constexpr unsigned FULL = 0xffffffffu;

// tensor-core scan: TN corpus rows per tile, KD features per chunk
constexpr int WM_TN = 128;
constexpr int WM_KD = 128;
constexpr int WM_LDC = WM_KD + 8;  // padded chunk row, in bf16
constexpr int WM_VECS = WM_TN * WM_KD / 8 / THREADS;  // 16-byte loads per thread per chunk
// CUDA-core scan
constexpr int SM_TN = 64;
constexpr int SM_KD = 32;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }

// True when (va, ia) comes first in the order (score desc, index asc).
__device__ __forceinline__ bool before(float va, int ia, float vb, int ib) {
  return va > vb || (va == vb && ia < ib);
}

// Fold one query's tile scores s[0, n) of rows r0 + j into its running top-k
// (tv, ti; k entries in order). One warp; lane j < k holds entry j in
// registers while the warp works.
__device__ void fold_tile(const float* s, int n, int r0, float* tv, int* ti, int k,
                          int lane) {
  float lv = lane < k ? tv[lane] : NEG;
  int li = lane < k ? ti[lane] : 0;
  float kth = __shfl_sync(FULL, lv, k - 1);
  for (int base = 0; base < n; base += 32) {
    const int j = base + lane;
    const float sj = j < n ? s[j] : NEG;
    unsigned m = __ballot_sync(FULL, j < n && sj > kth);
    while (m) {
      const int src = __ffs(m) - 1;
      m &= m - 1;
      const float sv = __shfl_sync(FULL, sj, src);
      if (!(sv > kth)) continue;  // kth rose since the ballot (warp-uniform)
      // entries with a score >= sv stay ahead: equal scores have lower rows
      const int pos = __popc(__ballot_sync(FULL, lane < k && lv >= sv));
      const float up_v = __shfl_up_sync(FULL, lv, 1);
      const int up_i = __shfl_up_sync(FULL, li, 1);
      if (lane == pos) {
        lv = sv;
        li = r0 + base + src;
      } else if (lane > pos) {
        lv = up_v;
        li = up_i;
      }
      kth = __shfl_sync(FULL, lv, k - 1);
    }
  }
  if (lane < k) {
    tv[lane] = lv;
    ti[lane] = li;
  }
}

__device__ __forceinline__ void init_lists(float* tv, int* ti, int n) {
  for (int e = threadIdx.x; e < n; e += THREADS) {
    tv[e] = NEG;
    ti[e] = 0;
  }
}

__device__ __forceinline__ void write_lists(const float* tv, const int* ti, float* cand_v,
                                            int* cand_i, int split, int Q, int q0, int nq,
                                            int k) {
  for (int e = threadIdx.x; e < nq * k; e += THREADS) {
    const int ql = e / k, j = e - ql * k;
    const size_t off = ((size_t)split * Q + q0 + ql) * k + j;
    cand_v[off] = tv[ql * K_MAX + j];
    cand_i[off] = ti[ql * K_MAX + j];
  }
}

// One tile's D-chunk [d0, d0 + WM_KD) of rows [r0, r0 + WM_TN) into
// registers as 16-byte vectors; rows >= r_end and columns >= D read as 0.
__device__ __forceinline__ void load_chunk(uint4 (&stage)[WM_VECS], const bf16* __restrict__ c,
                                           int r0, int d0, int D, int r_end, int tid) {
  const int w = min(WM_KD, D - d0);
#pragma unroll
  for (int i = 0; i < WM_VECS; ++i) {
    const int e = tid + i * THREADS;
    const int r = e / (WM_KD / 8), v = e % (WM_KD / 8);
    stage[i] = make_uint4(0, 0, 0, 0);
    if (r0 + r < r_end && v * 8 < w)
      stage[i] = *reinterpret_cast<const uint4*>(c + (size_t)(r0 + r) * D + d0 + v * 8);
  }
}

size_t wmma_smem(int QB, int D) {
  return sizeof(bf16) * ((size_t)QB * (D + 8) + (size_t)WM_TN * WM_LDC) +
         (sizeof(float) + sizeof(int)) * (size_t)QB * K_MAX;
}

// Pass 1 on the tensor cores (bf16, D % 16 == 0, 16-byte aligned rows).
template <int QB>
__global__ void __launch_bounds__(THREADS)
scan_wmma(const bf16* __restrict__ q, const bf16* __restrict__ c, int Q, int D, int valid,
          int k, int rows_per_split, float* __restrict__ cand_v, int* __restrict__ cand_i) {
  using namespace nvcuda;
  constexpr int QT = QB / 16;  // query tiles; every warp covers all of them
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int ldq = D + 8;
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // QB x ldq
  bf16* cs = qs + (size_t)QB * ldq;               // WM_TN x WM_LDC chunk
  float* sc = reinterpret_cast<float*>(cs);       // QB x WM_TN scores, over the chunk
  float* tv = reinterpret_cast<float*>(cs + WM_TN * WM_LDC);  // QB x K_MAX
  int* ti = reinterpret_cast<int*>(tv + QB * K_MAX);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * QB;
  const int nq = min(QB, Q - q0);
  const int split = blockIdx.y;
  const int r_begin = split * rows_per_split;
  const int r_end = min(valid, r_begin + rows_per_split);

  const int dv = D / 8;  // 16-byte vectors per row
  for (int e = tid; e < QB * dv; e += THREADS) {
    const int r = e / dv, v = e - r * dv;
    uint4 x = make_uint4(0, 0, 0, 0);
    if (r < nq) x = *reinterpret_cast<const uint4*>(q + (size_t)(q0 + r) * D + v * 8);
    *reinterpret_cast<uint4*>(qs + (size_t)r * ldq + v * 8) = x;
  }
  init_lists(tv, ti, QB * K_MAX);

  const int n_chunks = (D + WM_KD - 1) / WM_KD;
  const int n_tiles = r_end > r_begin ? (r_end - r_begin + WM_TN - 1) / WM_TN : 0;
  const int steps = n_tiles * n_chunks;
  uint4 stage[WM_VECS];
  if (steps > 0) load_chunk(stage, c, r_begin, 0, D, r_end, tid);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[QT];
  for (int t = 0; t < steps; ++t) {
    const int chunk = t % n_chunks;
    const int r0 = r_begin + (t / n_chunks) * WM_TN;
    const int d0 = chunk * WM_KD;
    const int w = min(WM_KD, D - d0);
    __syncthreads();  // the previous chunk and scores are consumed
#pragma unroll
    for (int i = 0; i < WM_VECS; ++i) {
      const int e = tid + i * THREADS;
      const int r = e / (WM_KD / 8), v = e % (WM_KD / 8);
      *reinterpret_cast<uint4*>(cs + r * WM_LDC + v * 8) = stage[i];
    }
    __syncthreads();
    if (t + 1 < steps)  // in flight while this chunk multiplies
      load_chunk(stage, c, r_begin + ((t + 1) / n_chunks) * WM_TN,
                 ((t + 1) % n_chunks) * WM_KD, D, r_end, tid);
    if (chunk == 0) {
#pragma unroll
      for (int qt = 0; qt < QT; ++qt) wmma::fill_fragment(acc[qt], 0.f);
    }
    for (int kk = 0; kk < w; kk += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
      wmma::load_matrix_sync(b, cs + warp * 16 * WM_LDC + kk, WM_LDC);
#pragma unroll
      for (int qt = 0; qt < QT; ++qt) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, qs + (size_t)qt * 16 * ldq + d0 + kk, ldq);
        wmma::mma_sync(acc[qt], a, b, acc[qt]);
      }
    }
    if (chunk == n_chunks - 1) {
      __syncthreads();  // every warp is done with the chunk the scores overwrite
#pragma unroll
      for (int qt = 0; qt < QT; ++qt)
        wmma::store_matrix_sync(sc + qt * 16 * WM_TN + warp * 16, acc[qt], WM_TN,
                                wmma::mem_row_major);
      __syncthreads();
      const int n = min(WM_TN, r_end - r0);
      for (int ql = warp; ql < nq; ql += WARPS)
        fold_tile(sc + ql * WM_TN, n, r0, tv + ql * K_MAX, ti + ql * K_MAX, k, lane);
    }
  }
  __syncthreads();
  write_lists(tv, ti, cand_v, cand_i, split, Q, q0, nq, k);
}

size_t simt_smem(int QB, int D) {
  return sizeof(float) * ((size_t)D * QB + SM_TN * (SM_KD + 1) + (size_t)QB * SM_TN) +
         (sizeof(float) + sizeof(int)) * (size_t)QB * K_MAX;
}

// Pass 1 on the CUDA cores (fp32, and bf16 where the tensor-core scan does
// not apply). Thread -> one row of the tile and QB/4 queries.
template <typename T, int QB>
__global__ void __launch_bounds__(THREADS)
scan_simt(const T* __restrict__ q, const T* __restrict__ c, int Q, int D, int valid, int k,
          int rows_per_split, float* __restrict__ cand_v, int* __restrict__ cand_i) {
  constexpr int QPT = QB / 4;
  constexpr int LDC = SM_KD + 1;  // padded: threads on consecutive rows hit distinct banks
  extern __shared__ __align__(16) float smf[];
  float* qs = smf;                        // D x QB, queries of one feature contiguous
  float* cs = qs + (size_t)D * QB;        // SM_TN x LDC chunk
  float* sc = cs + SM_TN * LDC;           // QB x SM_TN scores
  float* tv = sc + QB * SM_TN;            // QB x K_MAX
  int* ti = reinterpret_cast<int*>(tv + QB * K_MAX);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * QB;
  const int nq = min(QB, Q - q0);
  const int split = blockIdx.y;
  const int r_begin = split * rows_per_split;
  const int r_end = min(valid, r_begin + rows_per_split);
  const int row = tid % SM_TN, g = tid / SM_TN;  // g is warp-uniform: query reads broadcast

  for (int e = tid; e < QB * D; e += THREADS) {
    const int qq = e / D, d = e - qq * D;
    qs[(size_t)d * QB + qq] = qq < nq ? to_float(q[(size_t)(q0 + qq) * D + d]) : 0.f;
  }
  init_lists(tv, ti, QB * K_MAX);

  for (int r0 = r_begin; r0 < r_end; r0 += SM_TN) {
    float acc[QPT];
#pragma unroll
    for (int j = 0; j < QPT; ++j) acc[j] = 0.f;
    for (int d0 = 0; d0 < D; d0 += SM_KD) {
      __syncthreads();  // queries written / previous chunk and scores consumed
      for (int e = tid; e < SM_TN * SM_KD; e += THREADS) {
        const int r = e / SM_KD, d = e - r * SM_KD;
        cs[r * LDC + d] = (r0 + r < r_end && d0 + d < D)
                              ? to_float(c[(size_t)(r0 + r) * D + d0 + d]) : 0.f;
      }
      __syncthreads();
      const int w = min(SM_KD, D - d0);
      const float* cr = cs + row * LDC;
      for (int d = 0; d < w; ++d) {
        const float cv = cr[d];
        const float* qd = qs + (size_t)(d0 + d) * QB + g * QPT;
#pragma unroll
        for (int j = 0; j < QPT; ++j) acc[j] = fmaf(qd[j], cv, acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < QPT; ++j) sc[(g * QPT + j) * SM_TN + row] = acc[j];
    __syncthreads();
    const int n = min(SM_TN, r_end - r0);
    for (int ql = warp; ql < nq; ql += WARPS)
      fold_tile(sc + ql * SM_TN, n, r0, tv + ql * K_MAX, ti + ql * K_MAX, k, lane);
  }
  __syncthreads();
  write_lists(tv, ti, cand_v, cand_i, split, Q, q0, nq, k);
}

// Pass 2: one block per query picks, k times, the first candidate after the
// previous pick in the order (score desc, index asc). Equal filler slots
// (-1e30, 0) collapse to one; the slots after it stay (-1e30, 0).
__global__ void __launch_bounds__(THREADS)
merge_kernel(const float* __restrict__ cand_v, const int* __restrict__ cand_i,
             float* __restrict__ out_v, int* __restrict__ out_i, int Q, int splits, int k) {
  __shared__ float wv[WARPS];
  __shared__ int wi[WARPS];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int qi = blockIdx.x;
  const int n = splits * k;
  float pv = CUDART_INF_F;  // the previous pick; (+inf, -1) precedes every candidate
  int pi = -1;
  for (int r = 0; r < k; ++r) {
    float bv = -CUDART_INF_F;  // (-inf, INT_MAX) follows every candidate
    int bi = INT_MAX;
    for (int e = tid; e < n; e += THREADS) {
      const int s = e / k, j = e - s * k;
      const size_t off = ((size_t)s * Q + qi) * k + j;
      const float v = cand_v[off];
      const int i = cand_i[off];
      if (before(pv, pi, v, i) && before(v, i, bv, bi)) {
        bv = v;
        bi = i;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o /= 2) {
      const float ov = __shfl_down_sync(FULL, bv, o);
      const int oi = __shfl_down_sync(FULL, bi, o);
      if (before(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (lane == 0) {
      wv[warp] = bv;
      wi[warp] = bi;
    }
    __syncthreads();
    bv = wv[0];
    bi = wi[0];
    for (int w = 1; w < WARPS; ++w) {
      if (before(wv[w], wi[w], bv, bi)) {
        bv = wv[w];
        bi = wi[w];
      }
    }
    __syncthreads();  // wv/wi are read by all before the next round writes them
    const bool none = bi == INT_MAX;
    if (tid == 0) {
      out_v[(size_t)qi * k + r] = none ? NEG : bv;
      out_i[(size_t)qi * k + r] = none ? 0 : bi;
    }
    if (!none) {
      pv = bv;
      pi = bi;
    }
  }
}

template <typename KernelT>
cudaError_t set_smem(KernelT kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int QB>
cudaError_t launch_wmma(const void* q, const void* c, float* cand_v, int* cand_i, int Q, int D,
                        int valid, int k, int splits, cudaStream_t st) {
  const size_t smem = wmma_smem(QB, D);
  const int rps = ((valid + splits - 1) / splits + WM_TN - 1) / WM_TN * WM_TN;
  cudaError_t err = set_smem(scan_wmma<QB>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Q + QB - 1) / QB, splits);
  scan_wmma<QB><<<grid, THREADS, smem, st>>>(static_cast<const bf16*>(q),
                                             static_cast<const bf16*>(c), Q, D, valid, k,
                                             rps > 0 ? rps : WM_TN, cand_v, cand_i);
  return cudaGetLastError();
}

template <typename T, int QB>
cudaError_t launch_simt(const void* q, const void* c, float* cand_v, int* cand_i, int Q, int D,
                        int valid, int k, int splits, cudaStream_t st) {
  const size_t smem = simt_smem(QB, D);
  const int rps = ((valid + splits - 1) / splits + SM_TN - 1) / SM_TN * SM_TN;
  cudaError_t err = set_smem(scan_simt<T, QB>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Q + QB - 1) / QB, splits);
  scan_simt<T, QB><<<grid, THREADS, smem, st>>>(static_cast<const T*>(q),
                                                static_cast<const T*>(c), Q, D, valid, k,
                                                rps > 0 ? rps : SM_TN, cand_v, cand_i);
  return cudaGetLastError();
}

// The smallest block of queries that holds all Q, as long as it fits in
// shared memory; else the largest that fits (0: none does).
template <typename SmemFn>
int pick_qb(int Q, int D, int lo, SmemFn smem) {
  int qb = 64;
  while (qb > lo && qb / 2 >= Q) qb /= 2;
  while (qb > lo && smem(qb, D) > SMEM_MAX) qb /= 2;
  return smem(qb, D) <= SMEM_MAX ? qb : 0;
}

template <typename T>
cudaError_t scan_simt_any(const void* q, const void* c, float* cv, int* ci, int Q, int D,
                          int valid, int k, int splits, cudaStream_t st) {
  switch (pick_qb(Q, D, 8, simt_smem)) {
    case 64: return launch_simt<T, 64>(q, c, cv, ci, Q, D, valid, k, splits, st);
    case 32: return launch_simt<T, 32>(q, c, cv, ci, Q, D, valid, k, splits, st);
    case 16: return launch_simt<T, 16>(q, c, cv, ci, Q, D, valid, k, splits, st);
    case 8: return launch_simt<T, 8>(q, c, cv, ci, Q, D, valid, k, splits, st);
    default: return cudaErrorInvalidValue;  // D too wide for 8 resident queries
  }
}

}  // namespace

// queries (Q, D) and corpus (N, D): contiguous, both bf16 or both fp32. Rows
// >= valid are not scanned. cand_v/cand_i: (splits, Q, k) scratch; out_v
// (Q, k) fp32 and out_i (Q, k) int32. Returns the CUDA error of the launches.
extern "C" int sgpt_mips_topk(const void* q, const void* c, void* cand_v, void* cand_i,
                              void* out_v, void* out_i, int Q, int N, int D, int valid, int k,
                              int splits, int is_bf16, void* stream) {
  if (Q < 1 || N < 0 || D < 1 || k < 1 || k > K_MAX || splits < 1 || splits > 65535 ||
      valid < 0 || valid > N)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* cv = static_cast<float*>(cand_v);
  int* ci = static_cast<int*>(cand_i);
  const bool aligned = (reinterpret_cast<uintptr_t>(q) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(c) % 16 == 0);
  cudaError_t err;
  if (is_bf16 && D % 16 == 0 && aligned) {
    switch (pick_qb(Q, D, 16, wmma_smem)) {
      case 64: err = launch_wmma<64>(q, c, cv, ci, Q, D, valid, k, splits, st); break;
      case 32: err = launch_wmma<32>(q, c, cv, ci, Q, D, valid, k, splits, st); break;
      case 16: err = launch_wmma<16>(q, c, cv, ci, Q, D, valid, k, splits, st); break;
      default: err = scan_simt_any<bf16>(q, c, cv, ci, Q, D, valid, k, splits, st);
    }
  } else if (is_bf16) {
    err = scan_simt_any<bf16>(q, c, cv, ci, Q, D, valid, k, splits, st);
  } else {
    err = scan_simt_any<float>(q, c, cv, ci, Q, D, valid, k, splits, st);
  }
  if (err != cudaSuccess) return (int)err;
  merge_kernel<<<Q, THREADS, 0, st>>>(cv, ci, static_cast<float*>(out_v),
                                      static_cast<int*>(out_i), Q, splits, k);
  return (int)cudaGetLastError();
}

// The block of queries pass 1 would use (0: the shape is refused), for the
// wrapper's record of bytes read per search.
extern "C" int sgpt_mips_query_block(int Q, int D, int is_bf16, int aligned) {
  if (is_bf16 && D % 16 == 0 && aligned) {
    const int qb = pick_qb(Q, D, 16, wmma_smem);
    if (qb) return qb;
  }
  return pick_qb(Q, D, 8, simt_smem);
}
