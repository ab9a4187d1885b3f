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
// 1.23 ms at the H100's 3.35 TB/s; the products are 264 GFLOP, 0.27 ms at
// the bf16 tensor-core peak. On the TPU the corpus tile index is a
// sequential grid axis and the running top-k lives in VMEM across it. Blocks
// on the card run in no order, so the scan is two passes:
//   * pass 1: grid (query blocks × corpus splits), about one block an SM,
//     each block with one contiguous split (`ops/mips.py` plans the splits).
//     scan_mma (bf16, D % 16 == 0, 16-byte aligned rows) keeps its QB
//     queries in shared memory, loaded once, and streams its split in tiles
//     of MM_TR = 256 rows through a ring of up to MM_MAX_STAGES stages of
//     256 rows × MM_KD = 32 features (16 KB), fed by 16-byte cp.async copies
//     into XOR-swizzled rows (each copy asks L2 for the 256 bytes around it,
//     so the next stages' pieces of a row come from L2). Rows at or past
//     `valid` are zero-filled from a clamped source address: no copy reads
//     past them. At QB = 64, D = 768 the ring has 7 stages and each barrier
//     hands over two (MM_GROUP), so 3-5 stages (48-80 KB) are in flight
//     while two are multiplied, and they stay in flight while a tile's
//     top-k is folded. Products: mma.sync m16n8k16 bf16 with ldmatrix,
//     corpus rows as A and queries as B (both D-contiguous, no transpose);
//     each warp owns 32 rows of a tile × all QB queries with fp32
//     accumulators in registers across the D-chunks, so it reads the
//     queries once per 32 rows (3 bytes of shared-memory reads per corpus
//     byte at QB = 64); a k-step's fragments are all loaded before its
//     products. A bf16 product is exact in fp32, so only the summation
//     order differs from the plain version.
//     Top-k: each query's running list (k entries in the total order) lives
//     in shared memory. After a tile each thread holds its accumulators
//     against the k-th entry of their queries, read once per tile, with the
//     order test `before`, in registers; only the survivors go to a block
//     queue (one shared atomicAdd a warp), which is folded into the lists by
//     insertion in the total order, so the queue's order does not matter,
//     and a stale k-th only admits more. The first tile of a split (every
//     k-th is the -1e30 filler) and any tile whose survivors overflow the
//     queue (all-equal rows, exact duplicates) take the full fold instead:
//     the tile's scores pass through shared memory 32 rows at a time in row
//     order, one warp a query (`fold_tile`). Output: (splits, Q, k)
//     candidates, each split's list in the total order.
//     scan_simt (fp32; bf16 at D % 16 != 0 or unaligned) stays on the CUDA
//     cores: thread → one row of a 64-row tile and QB/4 queries, scores
//     through shared memory, `fold_tile` on every tile.
//   * pass 2 (merge_kernel): one block per query selects the k first of the
//     splits·k candidates in the same total order, so the result does not
//     depend on the number of splits.
// Shared memory bounds QB: scan_mma's queries take QB·(D' + 8)·2 bytes (D'
// is D rounded up to 32) beside at least MM_MIN_STAGES ring stages, so QB is
// 64 at D = 768 and 32 at D = 2048 and 2560; the corpus is read ceil(Q / QB)
// times. Slots that no valid row fills (valid < k) hold -1e30 with index 0
// (the TPU kernel repeats a masked column's index there). Next: a larger
// effective QB for large Q (the queries streamed by D-chunk, as a GEMM
// streams its B), and wgmma/TMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <climits>
#include <cstdint>

#include "mma_attention.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int K_MAX = 16;
constexpr float NEG = -1e30f;      // the TPU kernel's mask value
constexpr size_t SMEM_MAX = 232448;  // 227 KB, a block's dynamic shared memory on sm_90
constexpr unsigned FULL = 0xffffffffu;

// tensor-core scan: a warp owns MM_WR rows of a tile; a ring stage holds
// the tile's MM_KD features of every row
constexpr int MM_WR = 32;
constexpr int MM_MT = MM_WR / 16;         // m16 tiles a warp
constexpr int MM_TR = WARPS * MM_WR;      // rows a tile
constexpr int MM_KD = 32;
constexpr int MM_CPR = MM_KD / 8;         // 16-byte chunks a stage row
constexpr int MM_STAGE = MM_TR * MM_KD;   // bf16 elements a stage
constexpr int MM_COPIES = MM_STAGE / 8 / THREADS;  // 16-byte copies a thread a stage
constexpr int MM_GROUP = 2;  // stages a barrier hands over (with at least 2 MM_GROUP stages)
constexpr int MM_MAX_STAGES = 8;
constexpr int MM_MIN_STAGES = 3;
constexpr int QCAP = 1024;  // candidate queue; its 8 KB also hold a 32-row slice of scores
static_assert(MM_CPR >= 2 && MM_CPR <= 8 && THREADS % MM_CPR == 0, "stage rows of 2-8 chunks");
static_assert(MM_WR * 64 <= 2 * QCAP, "a warp's slice of scores at QB = 64 fits the queue");
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

// 16 bytes global → shared, asynchronously, asking L2 for the 256 bytes
// around them (the next stages' pieces of the row); !valid: zeroed, no read
__device__ __forceinline__ void cp_async16_l2(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// wait until at most n of this thread's committed groups are in flight
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    default: cp_async_wait<6>(); break;
  }
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// 16-byte chunk of stage row r that holds features 8c .. 8c + 7: the 8 rows
// an ldmatrix phase reads at one c fall in 8 distinct 16-byte bank groups
__host__ __device__ constexpr int swz(int r, int c) {
  return c ^ ((r * MM_CPR / 8) & (MM_CPR - 1));
}

// Insert (sv, row) into one query's list (tv, ti: k entries in the total
// order) if it is among the k first. One warp; lane j < k keeps entry j.
__device__ __forceinline__ void insert(float* tv, int* ti, float sv, int row, int k, int lane) {
  const float lv = lane < k ? tv[lane] : NEG;
  const int li = lane < k ? ti[lane] : 0;
  const int pos = __popc(__ballot_sync(FULL, lane < k && before(lv, li, sv, row)));
  if (pos >= k) return;  // warp-uniform
  const float up_v = __shfl_up_sync(FULL, lv, 1);
  const int up_i = __shfl_up_sync(FULL, li, 1);
  if (lane == pos) {
    tv[lane] = sv;
    ti[lane] = row;
  } else if (lane > pos && lane < k) {
    tv[lane] = up_v;
    ti[lane] = up_i;
  }
}

// query row stride: D rounded up to whole barrier groups of features (the
// columns past D are 0), + 8
__host__ __device__ constexpr int mma_ldq(int D) {
  return (D + MM_KD * MM_GROUP - 1) / (MM_KD * MM_GROUP) * (MM_KD * MM_GROUP) + 8;
}

__host__ __device__ constexpr size_t mma_fixed_smem(int QB, int D) {
  return sizeof(bf16) * (size_t)QB * mma_ldq(D) + (sizeof(float) + sizeof(int)) * QB * K_MAX +
         (sizeof(float) + sizeof(int)) * QCAP + 16;
}

// Ring stages that fit beside the queries, lists and queue (< 2: none).
int mma_stages(int QB, int D) {
  const size_t fixed = mma_fixed_smem(QB, D);
  if (fixed >= SMEM_MAX) return 0;
  const size_t fit = (SMEM_MAX - fixed) / (sizeof(bf16) * MM_STAGE);
  return fit < MM_MAX_STAGES ? (int)fit : MM_MAX_STAGES;
}

size_t mma_smem(int QB, int D, int stages) {
  return sizeof(bf16) * (size_t)stages * MM_STAGE + mma_fixed_smem(QB, D);
}

// Pass 1 on the tensor cores (bf16, D % 16 == 0, 16-byte aligned rows).
// QB = 8 NT queries a block; each barrier hands over G ring stages.
template <int NT, int G>
__global__ void __launch_bounds__(THREADS, 1)
scan_mma(const bf16* __restrict__ q, const bf16* __restrict__ c, int Q, int D, int valid, int k,
         int rows_per_split, int stages, float* __restrict__ cand_v, int* __restrict__ cand_i) {
  constexpr int QB = 8 * NT;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int ldq = mma_ldq(D);
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);  // stages x MM_TR x MM_KD, swizzled
  bf16* qs = ring + (size_t)stages * MM_STAGE;     // QB x ldq
  float* tv = reinterpret_cast<float*>(qs + (size_t)QB * ldq);  // QB x K_MAX
  int* ti = reinterpret_cast<int*>(tv + QB * K_MAX);
  float* qv = reinterpret_cast<float*>(ti + QB * K_MAX);  // queue: score
  int* qc = reinterpret_cast<int*>(qv + QCAP);            // (row - r0) << 6 | query
  int* qn = qc + QCAP;                                    // entries pushed this tile
  float* slice = qv;  // full fold: QB x MM_WR scores of one warp's rows, over the queue

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * QB, nq = min(QB, Q - q0);
  const int r_begin = blockIdx.y * rows_per_split;
  const int r_end = min(valid, r_begin + rows_per_split);
  const int n_dc = (D + MM_KD * G - 1) / (MM_KD * G) * G;  // D-chunks a tile, whole groups
  const int n_tiles = r_end > r_begin ? (r_end - r_begin + MM_TR - 1) / MM_TR : 0;
  const int steps = n_tiles * n_dc;

  // the copies of step g (tile g / n_dc, D-chunk g % n_dc): this thread's
  // MM_COPIES chunks, all in column ch of rows cr + i * THREADS / MM_CPR;
  // columns past D are zero-filled
  const int cr = tid / MM_CPR, ch = tid % MM_CPR;
  const int dst0 = cr * MM_KD + swz(cr, ch) * 8;  // the same swizzle for every i
  int is_r0 = r_begin, is_d0 = 0, is_slot = 0;    // the next step to issue
  auto issue = [&](bool any) {
    if (any) {
      bf16* st = ring + (size_t)is_slot * MM_STAGE + dst0;
#pragma unroll
      for (int i = 0; i < MM_COPIES; ++i) {
        const int r = is_r0 + cr + i * (THREADS / MM_CPR);
        const bool ok = r < r_end && is_d0 + ch * 8 < D;
        cp_async16_l2(st + i * (THREADS / MM_CPR) * MM_KD,
                      ok ? c + (size_t)r * D + is_d0 + ch * 8 : c, ok);
      }
      is_d0 += MM_KD;
      if (is_d0 >= n_dc * MM_KD) {
        is_d0 = 0;
        is_r0 += MM_TR;
      }
      is_slot = is_slot + 1 == stages ? 0 : is_slot + 1;
    }
    cp_async_commit();  // one group a step, empty past the end: the waits count steps
  };
  for (int g = 0; g < stages - G; ++g) issue(g < steps);

  const int dv = ldq / 8;  // queries: rows >= nq and columns >= D are 0
  for (int e = tid; e < QB * dv; e += THREADS) {
    const int r = e / dv, v = e - r * dv;
    uint4 x = make_uint4(0, 0, 0, 0);
    if (r < nq && v * 8 < D) x = *reinterpret_cast<const uint4*>(q + (size_t)(q0 + r) * D + v * 8);
    *reinterpret_cast<uint4*>(qs + (size_t)r * ldq + v * 8) = x;
  }
  init_lists(tv, ti, QB * K_MAX);
  if (tid == 0) *qn = 0;

  // ldmatrix addresses: A (corpus rows of this warp) within a stage, B
  // (queries) within the query tile at feature 0
  int a_off[MM_MT][MM_KD / 16];
#pragma unroll
  for (int m = 0; m < MM_MT; ++m)
#pragma unroll
    for (int kk = 0; kk < MM_KD / 16; ++kk) {
      const int r = warp * MM_WR + m * 16 + (lane & 15);
      a_off[m][kk] = r * MM_KD + swz(r, kk * 2 + (lane >> 4)) * 8;
    }
  const bf16* qb = qs + (size_t)((lane & 7) + (lane >> 4) * 8) * ldq + ((lane >> 3) & 1) * 8;

  float acc[MM_MT][NT][4];
  int dc = 0, slot = 0, r0 = r_begin;
  for (int g = 0; g < steps; g += G) {
    cp_async_wait_upto(stages - 2 * G);  // this thread's copies of steps g .. g + G - 1 landed
    __syncthreads();  // everyone's landed; the stages of steps g - G .. g - 1 are consumed
#pragma unroll
    for (int i = 0; i < G; ++i) issue(g + stages - G + i < steps);
    if (dc == 0) {
#pragma unroll
      for (int m = 0; m < MM_MT; ++m)
#pragma unroll
        for (int n = 0; n < NT; ++n) acc[m][n][0] = acc[m][n][1] = acc[m][n][2] = acc[m][n][3] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const bf16* st = ring + (size_t)(slot + i < stages ? slot + i : slot + i - stages) * MM_STAGE;
      const bf16* qd = qb + (dc + i) * MM_KD;
#pragma unroll
      for (int kk = 0; kk < MM_KD / 16; ++kk) {
        uint32_t a[MM_MT][4], b[NT / 2 + NT % 2][4];
#pragma unroll
        for (int m = 0; m < MM_MT; ++m) ldmatrix_x4(a[m], st + a_off[m][kk]);
#pragma unroll
        for (int j = 0; j < NT / 2; ++j) ldmatrix_x4(b[j], qd + (size_t)j * 16 * ldq + kk * 16);
        if constexpr (NT % 2 == 1) {
          uint32_t b2[2];
          ldmatrix_x2(b2, qd + (size_t)(NT - 1) * 8 * ldq + kk * 16);
          b[NT / 2][0] = b2[0];
          b[NT / 2][1] = b2[1];
        }
#pragma unroll
        for (int m = 0; m < MM_MT; ++m)
#pragma unroll
          for (int n = 0; n < NT; ++n) mma_bf16(acc[m][n], a[m], b[n / 2][(n & 1) * 2],
                                                b[n / 2][(n & 1) * 2 + 1]);
      }
    }
    slot = slot + G < stages ? slot + G : slot + G - stages;
    dc += G;
    if (dc < n_dc) continue;
    dc = 0;

    // the tile's scores are in acc: lane holds rows r0 + warp * MM_WR + 16m +
    // lane / 4 (+ 8 for e >= 2) and queries 8n + 2(lane % 4) (+ 1 for odd e)
    bool full = r0 == r_begin;  // the first tile: every k-th is the filler
    if (!full) {
      // the order test against each query's k-th, in registers: bit 4n + e
      // of pass[m] is set when (score, row) comes before the k-th (a row
      // < valid of this split, a real query)
      uint32_t pass[MM_MT];
      int cnt = 0;
      {
        float kv[NT][2];
        int ki[NT][2];
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int at = (n * 8 + 2 * (lane & 3) + h) * K_MAX + k - 1;
            kv[n][h] = tv[at];
            ki[n][h] = ti[at];
          }
#pragma unroll
        for (int m = 0; m < MM_MT; ++m) {
          pass[m] = 0;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = r0 + warp * MM_WR + m * 16 + (lane >> 2) + (e >> 1) * 8;
#pragma unroll
            for (int n = 0; n < NT; ++n) {
              const bool in = row < r_end && n * 8 + 2 * (lane & 3) + (e & 1) < nq;
              if (in & before(acc[m][n][e], row, kv[n][e & 1], ki[n][e & 1]))
                pass[m] |= 1u << (4 * n + e);
            }
          }
          cnt += __popc(pass[m]);
        }
      }
      int incl = cnt;  // the warp's inclusive prefix of counts
#pragma unroll
      for (int o = 1; o < 32; o *= 2) {
        const int y = __shfl_up_sync(FULL, incl, o);
        if (lane >= o) incl += y;
      }
      const int total = __shfl_sync(FULL, incl, 31);
      if (total > 0) {
        int base = 0;
        if (lane == 31) base = atomicAdd(qn, total);
        base = __shfl_sync(FULL, base, 31) + incl - cnt;
        if (cnt > 0) {
#pragma unroll
          for (int m = 0; m < MM_MT; ++m)
#pragma unroll
            for (int n = 0; n < NT; ++n)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                if (pass[m] >> (4 * n + e) & 1u) {
                  if (base < QCAP) {
                    qv[base] = acc[m][n][e];
                    qc[base] = (warp * MM_WR + m * 16 + (lane >> 2) + (e >> 1) * 8) << 6 |
                               (n * 8 + 2 * (lane & 3) + (e & 1));
                  }
                  ++base;
                }
        }
      }
      __syncthreads();  // the queue is complete
      const int pushed = *qn;
      full = pushed > QCAP;
      if (!full && pushed > 0) {  // query ql's list belongs to warp ql % WARPS
        for (int b0 = 0; b0 < pushed; b0 += 32) {
          const int j = b0 + lane;
          const float s = j < pushed ? qv[j] : 0.f;
          const int code = j < pushed ? qc[j] : 0;
          unsigned mine = __ballot_sync(FULL, j < pushed && (code & 63) % WARPS == warp);
          while (mine) {
            const int src = __ffs(mine) - 1;
            mine &= mine - 1;
            const float sv = __shfl_sync(FULL, s, src);
            const int cd = __shfl_sync(FULL, code, src);
            insert(tv + (cd & 63) * K_MAX, ti + (cd & 63) * K_MAX, sv, r0 + (cd >> 6), k, lane);
          }
        }
      }
    }
    if (full) {  // every score of the tile, warp by warp in row order
      for (int w = 0; w < WARPS; ++w) {
        const int rs = r0 + w * MM_WR, n = min(MM_WR, r_end - rs);
        if (n <= 0) break;
        __syncthreads();  // the slice (and the queue under it) is free
        if (warp == w) {
#pragma unroll
          for (int m = 0; m < MM_MT; ++m)
#pragma unroll
            for (int nn = 0; nn < NT; ++nn)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                slice[(nn * 8 + 2 * (lane & 3) + (e & 1)) * MM_WR + m * 16 + (lane >> 2) +
                      (e >> 1) * 8] = acc[m][nn][e];
        }
        __syncthreads();
        for (int ql = warp; ql < nq; ql += WARPS)
          fold_tile(slice + ql * MM_WR, n, rs, tv + ql * K_MAX, ti + ql * K_MAX, k, lane);
      }
    }
    __syncthreads();  // the lists are up to date and the queue is read
    if (tid == 0) *qn = 0;
    r0 += MM_TR;
  }
  cp_async_wait<0>();
  __syncthreads();
  write_lists(tv, ti, cand_v, cand_i, blockIdx.y, Q, q0, nq, k);
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

template <int NT, int G>
cudaError_t launch_mma_g(const void* q, const void* c, float* cand_v, int* cand_i, int Q, int D,
                         int valid, int k, int splits, int stages, cudaStream_t st) {
  const size_t smem = mma_smem(8 * NT, D, stages);
  const int rps = ((valid + splits - 1) / splits + MM_TR - 1) / MM_TR * MM_TR;
  cudaError_t err = set_smem(scan_mma<NT, G>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Q + 8 * NT - 1) / (8 * NT), splits);
  scan_mma<NT, G><<<grid, THREADS, smem, st>>>(static_cast<const bf16*>(q),
                                               static_cast<const bf16*>(c), Q, D, valid, k,
                                               rps > 0 ? rps : MM_TR, stages, cand_v, cand_i);
  return cudaGetLastError();
}

// MM_GROUP stages a barrier where the ring has room for two groups, else one
template <int NT>
cudaError_t launch_mma(const void* q, const void* c, float* cand_v, int* cand_i, int Q, int D,
                       int valid, int k, int splits, cudaStream_t st) {
  const int stages = mma_stages(8 * NT, D);
  if (stages >= 2 * MM_GROUP)
    return launch_mma_g<NT, MM_GROUP>(q, c, cand_v, cand_i, Q, D, valid, k, splits, stages, st);
  return launch_mma_g<NT, 1>(q, c, cand_v, cand_i, Q, D, valid, k, splits, stages, st);
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

// scan_mma's block of queries: the smallest of 8-64 that holds all Q, halved
// while the ring would have fewer than MM_MIN_STAGES stages (0: not even two
// stages fit at QB = 8).
int mma_qb(int Q, int D) {
  int qb = 8;
  while (qb < 64 && qb < Q) qb *= 2;
  while (qb > 8 && mma_stages(qb, D) < MM_MIN_STAGES) qb /= 2;
  return mma_stages(qb, D) >= 2 ? qb : 0;
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
    switch (mma_qb(Q, D)) {
      case 64: err = launch_mma<8>(q, c, cv, ci, Q, D, valid, k, splits, st); break;
      case 32: err = launch_mma<4>(q, c, cv, ci, Q, D, valid, k, splits, st); break;
      case 16: err = launch_mma<2>(q, c, cv, ci, Q, D, valid, k, splits, st); break;
      case 8: err = launch_mma<1>(q, c, cv, ci, Q, D, valid, k, splits, st); break;
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
    const int qb = mma_qb(Q, D);
    if (qb) return qb;
  }
  return pick_qb(Q, D, 8, simt_smem);
}
