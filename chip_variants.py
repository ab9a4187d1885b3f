#!/usr/bin/env python3
"""Build variants of K1's, K2's, K3's, K4a's, K4b's or K5's source on one
NVIDIA card, check and time them in turns.

    python3 chip_variants.py [NAME ...]

Each variant is this tree's `sgpt_tpu_torch/csrc/short_attention.cu`,
`short_attention_bwd.cu` and `flash_attention.cu` and their headers with a
few text substitutions (VARIANTS below; "tree" is the source as it stands),
and names the kernel it is about: K1's fp32 forward (`tf32_kernel`), K2's
fp32 backward (`tf32_rows`, `tf32_cols`; `k2_p_probe` instead prints whether
both passes compute the same P bit for bit), K3's fp32 forward
(`flash_fwd_tf32`, the `k3_` names), K4a's fp32 backward
(`flash_bwd_dq_tf32`, the `k4a_` names: its key ring's stages, tile rows,
keys a warp takes at once, and the grid order) or K4b's fp32 backward
(`flash_bwd_dkv_tf32`, the `k4b_` names: its query ring's stages, tile
rows, queries a warp takes at once, and K and V split once in shared
memory or at each k-step) or K5's bf16 scan (`scan_mma`, the `k5_` names:
its ring's stages and the stages a barrier hands over, the features a
stage holds, the warp tile's rows, the register filter off, the copies'
L2 prefetch size; checked by K5's rule over NQ's corpus and its hazards,
timed at Q = 64 and 8, with the registers, spills and SASS mix of
`scan_mma<8, 2>` and `<8, 1>`). All variants build at once, one `nvcc`
each, into `build/variants/<name>/`; the port's wrappers then run on each
library in turn (`chip_smoke.kernels_of`). For every variant the script
prints the registers and spills of its kernels (K1, K2 at Dh=64 without
ALiBi or segments; K3, K4a and K4b at Dh 64 and 128), the fp32 error against
the plain version with the fp32 gate (K1 over `chip_smoke.CASES`: |Δ| ≤
1e-5 + 1e-5·|ref|; K2 over the same: |Δ| ≤ 1e-5·max|ref| + 1e-5·|ref| in
dq, dk and dv; K3 over `chip_smoke.FLASH_CASES`, output and lse: |Δ| ≤
1e-5 + 1e-5·|ref|; K4a and K4b over `chip_smoke.FBWD_CASES`: |Δ| ≤
1e-5·max|ref| + 1e-5·|ref| in dq, or in dk and dv, K4a's D bit for bit
against the first library's), and the time at the main path's shape over two
rounds in alternating order (K1, K2: the train shape B=32, T=300, H=12,
Dh=64, fp32, window 0 and 256, K2 also each pass alone under
torch.profiler; K3, K4a and K4b: the long train's B=8, T=2048, H=12,
Dh=64, fp32, block_kv 256, window 0 and 256), beside SDPA fp32 (K2, K4:
SDPA's backward, which computes dq, dk and dv) and the card's name and
power limit. A variant is a measurement, never a second path: the tree
keeps one kernel. A k4b_ variant's K4a, or a k4a_ variant's K4b, is not
checked and may be wrong (the substitutions of shared helpers are made for
the kernel the variant is about); the other kernel's runs take the first
library's.
"""
from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np

import chip_smoke as cs
from sgpt_tpu_torch.ops import _build

CSRC = Path("sgpt_tpu_torch/csrc")
OUT = Path("build/variants")
K2_EXP = [("short_attention_bwd.cu", f"expf(s[n][e] - {m})", f"__expf(s[n][e] - {m})")
          for m in ("m_new[e >> 1]", "m[r]", "qa->m[c]")]
BWD = "flash_attention_bwd.cu"
K4B_QT16 = (BWD, "constexpr int DKV_QT = 32;", "constexpr int DKV_QT = 16;")
K4B_QT64 = (BWD, "constexpr int DKV_QT = 32;", "constexpr int DKV_QT = 64;")
# K4b's ring in one stage: tile i + 1 is issued after tile i is consumed
K4B_ONE_STAGE = [
    (BWD, "((size_t)KV + 2 * (size_t)STAGE)", "((size_t)KV + (size_t)STAGE)"),
    (BWD, "ring + (i % 2) * S::STAGE", "ring"),
    (BWD, "    if (i + 1 < n_tiles) {  // tile i + 1 copies while this one computes\n"
          "      issue(i + 1);\n      cp_async_commit();\n    }\n", ""),
    (BWD, "      acc_tile<D, DKV_N>(ak, dp, Qb + at, Qsm + at, g, t);  // dK += dSᵀ·Q\n    }\n",
     "      acc_tile<D, DKV_N>(ak, dp, Qb + at, Qsm + at, g, t);  // dK += dSᵀ·Q\n    }\n"
     "    __syncthreads();  // tile i consumed\n    if (i + 1 < n_tiles) {\n"
     "      issue(i + 1);\n      cp_async_commit();\n    }\n")]
# K4b's K and V split once a block: they land raw (rows of Dh) in the ring,
# and each warp's A fragments are stored split in fragment order (entry
# (warp, k-step d, lane) holds the lane's four values as kv_frag reads them)
K4B_KV_SPLIT = [
    (BWD, "static constexpr int KV = 2 * SUB * LD;", "static constexpr int KV = 4 * SUB * D;"),
    (BWD, "template <int D, int R>\n__device__ __forceinline__ void copy_rows_async(float* dst, "
          "const float* src, long long stride) {\n  constexpr int C = D / 4, LD = D + 8;\n",
     "template <int D, int R, int LD = D + 8>\n__device__ __forceinline__ void copy_rows_async("
     "float* dst, const float* src, long long stride) {\n  constexpr int C = D / 4;\n"),
    (BWD, "// the split A fragments of k-step d",
     "template <int D>\n"
     "__device__ __forceinline__ void split_frags(uint4* big, uint4* small, const float* raw) {\n"
     "  for (int e = threadIdx.x; e < SUB / 16 * (D / 8) * 32; e += MMA_THREADS) {\n"
     "    const int lane = e % 32, d = e / 32 % (D / 8), w = e / 32 / (D / 8);\n"
     "    const float* x = raw + (w * 16 + (lane >> 2)) * D + 8 * d + 2 * (lane & 3);\n"
     "    uint4 b, sm;\n"
     "    split_tf32(x[0], b.x, sm.x);\n    split_tf32(x[8 * D], b.y, sm.y);\n"
     "    split_tf32(x[1], b.z, sm.z);\n    split_tf32(x[8 * D + 1], b.w, sm.w);\n"
     "    big[e] = b;\n    small[e] = sm;\n  }\n}\n\n// the split A fragments of k-step d"),
    (BWD, "  constexpr int LD = D + 8;\n  const float* at = kv + (which * SUB + w * 16 + (lane >> 2))"
          " * LD + 8 * d + 2 * (lane & 3);\n  const float2 lo = *reinterpret_cast<const float2*>(at);"
          "\n  const float2 hi = *reinterpret_cast<const float2*>(at + 8 * LD);\n"
          "  split_tf32(lo.x, big[0], small[0]);\n  split_tf32(hi.x, big[1], small[1]);\n"
          "  split_tf32(lo.y, big[2], small[2]);\n  split_tf32(hi.y, big[3], small[3]);\n",
     "  const uint4* f = reinterpret_cast<const uint4*>(kv) + which * SUB * D / 2;\n"
     "  const int e = (w * (D / 8) + d) * 32 + lane;\n"
     "  const uint4 b = f[e], sm = f[SUB * D / 4 + e];\n"
     "  big[0] = b.x, big[1] = b.y, big[2] = b.z, big[3] = b.w;\n"
     "  small[0] = sm.x, small[1] = sm.y, small[2] = sm.z, small[3] = sm.w;\n"),
    (BWD, "  // K and V tiles, in tile 0's group\n"
          "  copy_rows_async<D, SUB>(kv, static_cast<const float*>(p.k) + base + k0 * p.st, p.st);\n"
          "  copy_rows_async<D, SUB>(kv + SUB * LD, static_cast<const float*>(p.v) + base + k0 * "
          "p.st, p.st);\n",
     "  static_assert(S::BYTES / sizeof(float) - S::KV >= 2 * SUB * D, \"raw K, V fit the ring\");\n"
     "  copy_rows_async<D, SUB, D>(ring, static_cast<const float*>(p.k) + base + k0 * p.st, p.st);\n"
     "  copy_rows_async<D, SUB, D>(ring + SUB * D, static_cast<const float*>(p.v) + base + k0 * "
     "p.st, p.st);\n  cp_async_commit();\n  cp_async_wait<0>();\n  __syncthreads();\n"
     "  uint4* f = reinterpret_cast<uint4*>(kv);\n"
     "  split_frags<D>(f, f + SUB * D / 4, ring);\n"
     "  split_frags<D>(f + SUB * D / 2, f + 3 * SUB * D / 4, ring + SUB * D);\n"
     "  __syncthreads();  // the fragments written, the ring free\n")]
# K4a's ring in one stage: key tile i is issued once tile i - 1 is consumed
K4A_ONE_STAGE = [
    (BWD, "((size_t)QG + 2 * (size_t)RING + SUB)", "((size_t)QG + (size_t)RING + SUB)"),
    (BWD, "float* d_s = ring + 2 * S::RING;", "float* d_s = ring + S::RING;"),
    (BWD, "ring + (i & 1) * S::RING", "ring"),
    (BWD, "    cp_async_wait<0>();\n    split_rows<D, KT>(Kb, Ksm);",
     "    if (i > 0) {\n      __syncthreads();  // tile i - 1 consumed\n      issue(i);\n"
     "      cp_async_commit();\n    }\n    cp_async_wait<0>();\n    split_rows<D, KT>(Kb, Ksm);"),
    (BWD, "    if (i + 1 < n) {  // the next key tile copies while this one computes\n"
          "      issue(i + 1);\n      cp_async_commit();\n    }\n", "")]
SA = "short_attention.cu"
SAB = "short_attention_bwd.cu"
# K1 fp32 at Dh 256 (the tree: two warps to each 16 rows, each summing half
# of Dh into S, S = S_lo + S_hi through shared memory, and keeping half of
# O's columns): (b) both warps compute S over all of Dh, with no exchange;
# (a) besides, one warp to each 16 rows with all of O's columns (4 warps)
K1W_FULL_S = [
    (SA, "      for (int d = upper * (D / 16); d < (upper + 1) * (D / 16); ++d) {",
     "      for (int d = 0; d < D / 8; ++d) {"),
    (SA, "      if (upper) pair_store(s, xs);\n"
         "      __syncthreads();  // every warp has read K of tile kt; the upper halves stored\n"
         "      if (!upper) pair_add(s, xs);\n      pair_barrier(rw);\n"
         "      if (upper) pair_load(s, xs);\n",
     "      __syncthreads();  // every warp has read K of tile kt\n")]
K1W_ONE_WARP = [
    *K1W_FULL_S,
    (SA, "HALF = D / 2, NTH = K1W_THREADS;", "HALF = D, NTH = K1W_THREADS;"),
    (SA, "constexpr int K1W_THREADS = 2 * MMA_THREADS;",
     "constexpr int K1W_THREADS = MMA_THREADS;")]
# K2 fp32 at Dh 256 (the tree: in both passes two warps to each 16 rows or
# keys, each summing half of Dh into S and dP, or Sᵀ and dPᵀ, through
# shared memory, and keeping half of the gradient's columns): K4b's way,
# both warps computing the scores over all of Dh (+50 % of the products),
# with no exchange
K2W_DUP = [(SAB, "for (int d = upper * (D / 16); d < (upper + 1) * (D / 16); ++d) {",
            "for (int d = 0; d < D / 8; ++d) {")] + [
    (SAB, f"    pair_sum(s, dp, xs, upper, {w});\n", "") for w in ("warp", "kw")]


# K5: the tensor-core scan's ring capped at n stages (the tree: up to 8; 7
# at QB = 64, D = 768; below 4 a barrier hands over one stage, not two)
def k5_stages(n):
    return [("mips.cu", "constexpr int MM_MAX_STAGES = 8;", f"constexpr int MM_MAX_STAGES = {n};"),
            ("mips.cu", "constexpr int MM_MIN_STAGES = 3;",
             f"constexpr int MM_MIN_STAGES = {min(n, 3)};")]


# K5: a warp tile of n corpus rows × all QB queries (the tree: 32; the tile
# is 8 × n rows, and the queue grows to hold a warp's slice of scores)
def k5_warp_rows(n):
    return [("mips.cu", "constexpr int MM_WR = 32;", f"constexpr int MM_WR = {n};"),
            ("mips.cu", "constexpr int QCAP = 1024;", f"constexpr int QCAP = {max(1024, 32 * n)};")]


VARIANTS = {  # name: [(file, text in the tree, its replacement)]; "k2_*": K2's
    "tree": [],
    # the rounding as the PTX instruction rather than two integer operations
    "cvt_rna": [("mma_tf32.cuh", "return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;",
                 'uint32_t r; asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(r) : "f"(x)); return r;')],
    # the three products of a step straight into the running sum
    "running_sum": [("mma_tf32.cuh", "float t[4] = {0.f, 0.f, 0.f, 0.f};", "float (&t)[4] = d;"),
                    ("mma_tf32.cuh", "for (int e = 0; e < 4; ++e) d[e] += t[e];",
                     "for (int e = 0; e < 0; ++e) d[e] += t[e];")],
    # one TF32 product (big parts only): the accuracy 3xTF32 buys
    "one_tf32": [("mma_tf32.cuh", "mma_tf32(t, as, bb0, bb1);\n  mma_tf32(t, ab, bs0, bs1);\n",
                  "")],
    # the fast exponential in the online softmax
    "fast_exp": [("short_attention.cu", "s[n][e] = expf(s[n][e] - m_new[e >> 1]);",
                  "s[n][e] = __expf(s[n][e] - m_new[e >> 1]);")],
    # K2: the fast exponential in both passes
    "k2_fast_exp": K2_EXP,
    # K2: one TF32 product (big parts only) in both passes
    "k2_one_tf32": [("mma_tf32.cuh", "mma_tf32(t, as, bb0, bb1);\n  mma_tf32(t, ab, bs0, bs1);\n",
                     ""),
                    ("mma_tf32.cuh", "mma_tf32(t, ab, bs0, bs1);\n  mma_tf32(t, as, bb0, bb1);\n",
                     "")],
    # K3: Q split once a block, each warp's A fragments held split in
    # registers across the walk (the tree splits them at every k-step)
    "k3_q_in_regs": [
        ("flash_attention.cu", "  for (int i = 0; i < n; ++i) {\n    const int entry = list[i], "
         "k0 = entry & ~NEEDS_MASK, stage = i & 1;\n    float* kb",
         "  uint32_t qf[D / 8][2][4];\n  for (int i = 0; i < n; ++i) {\n    const int entry = "
         "list[i], k0 = entry & ~NEEDS_MASK, stage = i & 1;\n    float* kb"),
        ("flash_attention.cu", "// K of sub-tile i (and at i = 0 the Q tile) landed and split\n",
         "// K of sub-tile i (and at i = 0 the Q tile) landed and split\n    if (i == 0)\n"
         "#pragma unroll\n      for (int d = 0; d < D / 8; ++d) a_frag_3xtf32<D>(qf[d][0], "
         "qf[d][1], qrows, d, lane);\n"),
        ("flash_attention.cu", "      uint32_t ab[4], as[4];\n      a_frag_3xtf32<D>(ab, as, "
         "qrows, d, lane);  // Q's fragments, split at every k-step\n      qk_step_3xtf32<D>(s, "
         "ab, as, kb, Ksm, d, lane);",
         "      qk_step_3xtf32<D>(s, qf[d][0], qf[d][1], kb, Ksm, d, lane);")],
    # K3: the fast exponential for p
    "k3_fast_exp": [("flash_attention.cu", "s[c][e] = expf(s[c][e] - m_new[e >> 1]);",
                     "s[c][e] = __expf(s[c][e] - m_new[e >> 1]);")],
    # K4b: one stage of the query ring (the next tile copies after this one)
    "k4b_one_stage": K4B_ONE_STAGE,
    # K4b: 16-row stages
    "k4b_qt16": [K4B_QT16],
    # K4b: one stage of 64 query rows (K2's tf32_cols tile)
    "k4b_tile64": [K4B_QT64, *K4B_ONE_STAGE],
    # K4b: 32 queries a warp at a time (Sᵀ and dPᵀ in 32 registers)
    "k4b_n4": [("flash_attention_bwd.cu", "constexpr int DKV_N = 2;", "constexpr int DKV_N = 4;")],
    # K4b: one stage of 64 query rows taken whole (Sᵀ and dPᵀ in 64 registers)
    "k4b_full64": [K4B_QT64, *K4B_ONE_STAGE,
                   ("flash_attention_bwd.cu", "constexpr int DKV_N = 2;",
                    "constexpr int DKV_N = 8;")],
    # K4b: K and V split once a block into shared big and small parts in
    # fragment order (one 16-byte load a fragment part), beside two 16-row
    # stages at two blocks an SM
    "k4b_kv_split": [*K4B_KV_SPLIT, K4B_QT16],
    # K4b: the same with one 32-row stage
    "k4b_kv_split_one_stage": [*K4B_KV_SPLIT, *K4B_ONE_STAGE],
    # K4b: the chunks of a stage unrolled
    "k4b_unroll_chunks": [("flash_attention_bwd.cu", "#pragma unroll 1\n    for (int qc = 0;",
                           "#pragma unroll\n    for (int qc = 0;")],
    # K4b, a measurement: the fast exponential
    "k4b_fast_exp": [("flash_attention_bwd.cu",
                      "expf(score(s[n][e], p.scale, alibi, slope, kpos[r]) - lse[qi])",
                      "__expf(score(s[n][e], p.scale, alibi, slope, kpos[r]) - lse[qi])")],
    # K4b, a measurement: the raw score (right only at scale 1 without ALiBi)
    "k4b_raw_score": [("flash_attention_bwd.cu",
                       "expf(score(s[n][e], p.scale, alibi, slope, kpos[r]) - lse[qi])",
                       "expf(s[n][e] - lse[qi])")],
    # K4b, a measurement: the three products of a step straight into the
    # running sum (no fresh accumulator)
    "k4b_running_sum": [("mma_tf32.cuh", "float t[4] = {0.f, 0.f, 0.f, 0.f};",
                         "float (&t)[4] = d;"),
                        ("mma_tf32.cuh", "for (int e = 0; e < 4; ++e) d[e] += t[e];",
                         "for (int e = 0; e < 0; ++e) d[e] += t[e];")],
    # K4a: 16 keys a warp at a time at every Dh (S and dP in 16 registers)
    "k4a_n2": [(BWD, "constexpr int DQ_N = D <= 64 ? 4 : 2;", "constexpr int DQ_N = 2;")],
    # K4a: 8 keys a warp at a time
    "k4a_n1": [(BWD, "constexpr int DQ_N = D <= 64 ? 4 : 2;", "constexpr int DQ_N = 1;")],
    # K4a: 32 keys a warp at a time at every Dh (spills at Dh 128)
    "k4a_n4": [(BWD, "constexpr int DQ_N = D <= 64 ? 4 : 2;", "constexpr int DQ_N = 4;")],
    # K4a: 16-key stages
    "k4a_kt16": [(BWD, "constexpr int DQ_KT = 32;", "constexpr int DQ_KT = 16;"),
                 (BWD, "constexpr int DQ_N = D <= 64 ? 4 : 2;", "constexpr int DQ_N = 2;")],
    # K4a: 64-key stages (one block an SM at Dh 64)
    "k4a_kt64": [(BWD, "constexpr int DQ_KT = 32;", "constexpr int DQ_KT = 64;")],
    # K4a: one stage of the key ring
    "k4a_one_stage": K4A_ONE_STAGE,
    # K4a: the first query block (the shortest causal walk) first, as the
    # CUDA-core kernel's grid ran
    "k4a_short_first": [(BWD, "const int q0 = (NQ - 1 - slot) * SUB,", "const int q0 = slot * SUB,")],
    # K4a: D from dO and O in device memory (the shared copy of O left out)
    "k4a_d_global": [(BWD, "  copy_rows_async<D, SUB>(os, og, p.ot);\n", ""),
                     (BWD, "x = fmaf(qgs[(SUB + r) * LD + c], os[r * LD + c], x);",
                      "x = fmaf(gg[r * p.gt + c], og[r * p.ot + c], x);")],
    # K4a, a measurement: the fast exponential
    "k4a_fast_exp": [(BWD, "expf(score(s[n][e], p.scale, alibi, slope, kpos) - lse[r])",
                      "__expf(score(s[n][e], p.scale, alibi, slope, kpos) - lse[r])")],
    # K5: the ring at 3, 4 and 5 stages
    "k5_stages3": k5_stages(3),
    "k5_stages4": k5_stages(4),
    "k5_stages5": k5_stages(5),
    # K5: one stage a barrier (the tree: two where the ring holds four)
    "k5_group1": [("mips.cu", "constexpr int MM_GROUP = 2;", "constexpr int MM_GROUP = 1;")],
    # K5: stages of 256 rows × 64 features (32 KB; 3 at QB = 64, D = 768, so
    # one a barrier)
    "k5_kd64": [("mips.cu", "constexpr int MM_KD = 32;", "constexpr int MM_KD = 64;")],
    # K5: warp tiles of 16 and 64 rows (tiles of 128 and 512 rows)
    "k5_wr16": k5_warp_rows(16),
    "k5_wr64": k5_warp_rows(64),
    # K5: no register filter: every tile takes the full fold (scores through
    # shared memory, one warp a query)
    "k5_no_filter": [("mips.cu", "bool full = r0 == r_begin;", "bool full = true;")],
    # K5: the copies ask L2 for 128 bytes, or for nothing beyond them
    "k5_l2_128": [("mips.cu", "cp.async.cg.shared.global.L2::256B", "cp.async.cg.shared.global.L2::128B")],
    "k5_no_l2": [("mips.cu", "cp.async.cg.shared.global.L2::256B", "cp.async.cg.shared.global")],
    # K1 fp32 at Dh 256 (`tf32_kernel_wide`): (b) both warps of a pair
    # computing S over all of Dh; (a) one warp to each 16 rows with all of O
    "k1w_b": K1W_FULL_S,
    "k1w_a": K1W_ONE_WARP,
    # K1 fp32 at Dh 256: the score loop unrolled 2 or 8 deep (the tree: 4)
    "k1w_unroll2": [(SA, "#pragma unroll 4\n      for (int d = upper * (D / 16);",
                     "#pragma unroll 2\n      for (int d = upper * (D / 16);")],
    # K2 fp32 at Dh 256 (`tf32_rows_wide`, `tf32_cols_wide`): the scores
    # over all of Dh in both warps of a pair, as K4b's `_wide` takes them
    "k2w_dup": K2W_DUP,
    # K2, a probe (not timed): at T ≤ 64 and Dh = 64 the rows pass writes its
    # P into dq (row q, column key) and the cols pass its P into dk (row
    # key, column q), to see whether both passes compute the same P
    "k2_p_probe": [
        ("short_attention_bwd.cu", "s[n][e] = x * mask.scale;", "s[n][e] = p + 0.f * x;"),
        ("short_attention_bwd.cu",
         "pv_part_3xtf32<D, 4>(o, s, Kb + at * LD, Ksm + at * LD, lane);",
         "if constexpr (D == 64) for (int n = 0; n < 4; ++n) "
         "for (int e = 0; e < 4; ++e) o[(at >> 3) + n][e] = s[n][e];"),
        ("short_attention_bwd.cu", "pv_part_3xtf32<D, 4>(ak, dp, qb, qsm, lane);",
         "if constexpr (D == 64) for (int n = 0; n < 4; ++n) "
         "for (int e = 0; e < 4; ++e) ak[(c_at >> 3) + n][e] = s[n][e];")],
}


def group(name: str) -> str:
    """The kernel a variant is about: "k1w" (K1 fp32 at Dh 256), "k2", "k2w" (K2
    fp32 at Dh 256), "k3", "k4a", "k4b", "k5" or (the rest) "k1"."""
    return name.split("_")[0] if name.split("_")[0] in ("k1w", "k2", "k2w", "k3", "k4a", "k4b",
                                                         "k5") else "k1"


def sources(name: str) -> list:
    """The sources a variant's library is built from: the kernel it is about
    (short_attention.cu also holds the error-string entry point)."""
    if name == "tree":
        return ["short_attention.cu", "short_attention_bwd.cu", "flash_attention.cu",
                "flash_attention_bwd.cu", "mips.cu"]
    return {"k1": ["short_attention.cu"], "k1w": ["short_attention.cu"],
            "k2": ["short_attention.cu", "short_attention_bwd.cu"],
            "k2w": ["short_attention.cu", "short_attention_bwd.cu"],
            "k3": ["short_attention.cu", "flash_attention.cu"],
            "k4a": ["short_attention.cu", "flash_attention.cu", "flash_attention_bwd.cu"],
            "k4b": ["short_attention.cu", "flash_attention.cu",
                    "flash_attention_bwd.cu"],
            "k5": ["short_attention.cu", "mips.cu"]}[group(name)]


def build(names):
    nvcc = _build._nvcc()
    procs = {}
    for name in names:
        d = OUT / name
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        for f in list(CSRC.glob("*.cuh")) + [CSRC / c for c in sources(name)]:
            text = f.read_text()
            for fname, old, new in VARIANTS[name]:
                if fname == f.name:
                    if old not in text:
                        raise SystemExit(f"variant {name}: {fname} no longer holds {old!r}")
                    text = text.replace(old, new)
            (d / f.name).write_text(text)
        cmd = [nvcc, *_build.NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"),
               *(str(d / c) for c in sources(name))]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"variant {name}: nvcc failed\n{out[-4000:]}")
        lines = out.splitlines()
        for i, line in enumerate(lines):
            for kernel, inst, args in (("tf32_kernel_wide", "ILb0", "false"),
                                       ("tf32_rows_wide", "ILb0", "false"),
                                       ("tf32_cols_wide", "ILb0", "false"),
                                       ("tf32_kernel", "ILi64ELb0", "64, false"),
                                       ("tf32_rows", "ILi64ELb0", "64, false"),
                                       ("tf32_cols", "ILi64ELb0", "64, false"),
                                       ("flash_fwd_tf32", "ILi64E", "64"),
                                       ("flash_fwd_tf32", "ILi128E", "128"),
                                       ("flash_bwd_dq_tf32", "ILi64E", "64"),
                                       ("flash_bwd_dq_tf32", "ILi128E", "128"),
                                       ("flash_bwd_dkv_tf32", "ILi64E", "64"),
                                       ("flash_bwd_dkv_tf32", "ILi128E", "128"),
                                       ("scan_mma", "ILi8ELi2E", "8, 2"),
                                       ("scan_mma", "ILi8ELi1E", "8, 1"),
                                       ("scan_mma", "ILi1ELi2E", "1, 2")):
                if re.search(rf"Compiling entry function '.*{kernel}{inst}", line):
                    print(f"{name}: {kernel}<{args}>: "
                          + " | ".join(x.strip() for x in lines[i + 2:i + 4]), flush=True)
        if group(name) == "k4a" or name == "tree":
            sass_mix(OUT / name / "lib.so", "flash_bwd_dq_tf32ILi64E", name)
        if group(name) == "k4b" or name == "tree":
            sass_mix(OUT / name / "lib.so", "flash_bwd_dkv_tf32ILi64E", name)
        if group(name) == "k5" or name == "tree":
            sass_mix(OUT / name / "lib.so", "scan_mmaILi8ELi2E", name)
            sass_mix(OUT / name / "lib.so", "scan_mmaILi8ELi1E", name)
        lib = ctypes.CDLL(str(OUT / name / "lib.so"))
        p, i_, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
        if "short_attention_bwd.cu" in sources(name):
            lib.sgpt_short_attention_bwd.argtypes = [p] * 12 + [i_] * 4 + [f] + [i_] * 3 + [p]
            lib.sgpt_short_attention_bwd.restype = i_
        if "flash_attention.cu" in sources(name):
            lib.sgpt_flash_attention_fwd.argtypes = ([p] * 7 + [i_] * 4 + [ll] * 6 + [f]
                                                     + [i_] * 4 + [p])
            lib.sgpt_flash_attention_fwd.restype = i_
        if "flash_attention_bwd.cu" in sources(name):
            lib.sgpt_flash_attention_bwd_dq.argtypes = [p] * 10 + [i_] * 4 + [ll] * 12 + [f, i_, i_, p]
            lib.sgpt_flash_attention_bwd_dq.restype = i_
            lib.sgpt_flash_attention_bwd_dkv.argtypes = [p] * 10 + [i_] * 4 + [ll] * 9 + [f, i_, i_, p]
            lib.sgpt_flash_attention_bwd_dkv.restype = i_
        if "mips.cu" in sources(name):
            lib.sgpt_mips_topk.argtypes = [p] * 6 + [i_] * 7 + [p]
            lib.sgpt_mips_topk.restype = i_
            lib.sgpt_mips_query_block.argtypes = [i_] * 4
            lib.sgpt_mips_query_block.restype = i_
        lib.sgpt_short_attention_fwd.argtypes = [p] * 8 + [i_] * 4 + [f] + [i_] * 3 + [p]
        lib.sgpt_short_attention_fwd.restype = i_
        lib.sgpt_cuda_error_string.argtypes = [i_]
        lib.sgpt_cuda_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def sass_mix(lib, kernel: str, name: str) -> None:
    """The static instruction mix of one kernel of a built library
    (`cuobjdump -sass`): opcodes counted by their first name, the largest
    first; skipped where the toolkit has no cuobjdump."""
    tool = Path(_build._nvcc()).parent / "cuobjdump"
    if not tool.exists():
        return
    out = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True).stdout
    for func in out.split("Function : ")[1:]:
        if kernel in func.splitlines()[0]:
            ops = {}
            for m in re.finditer(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[0-9T]\s+)?([A-Z][A-Z0-9]*)", func):
                ops[m.group(1)] = ops.get(m.group(1), 0) + 1
            top = sorted(ops.items(), key=lambda kv: -kv[1])
            print(f"{name}: {kernel} SASS: {sum(ops.values())} instructions; "
                  + ", ".join(f"{k} {v}" for k, v in top[:16]), flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_variants: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    from sgpt_tpu_torch.ops import flash_attention as fa
    from sgpt_tpu_torch.ops import short_attention as sa

    names = sys.argv[1:] or list(VARIANTS)
    print(cs.card_line(), flush=True)
    libs = build(names)
    k1 = {n: lib for n, lib in libs.items() if group(n) == "k1"}  # "tree" among them
    k1w = {n: lib for n, lib in libs.items() if n == "tree" or group(n) == "k1w"}
    k2 = {n: lib for n, lib in libs.items()
          if n == "tree" or (group(n) == "k2" and n != "k2_p_probe")}
    k2w = {n: lib for n, lib in libs.items() if n == "tree" or group(n) == "k2w"}
    k3 = {n: lib for n, lib in libs.items() if n == "tree" or group(n) == "k3"}
    k4a = {n: lib for n, lib in libs.items() if n == "tree" or group(n) == "k4a"}
    k4b = {n: lib for n, lib in libs.items() if n == "tree" or group(n) == "k4b"}
    k5 = {n: lib for n, lib in libs.items() if n == "tree" or group(n) == "k5"}
    if len(k1) > 1 or names == ["tree"]:
        run_k1(torch, sa, k1)
    if len(k2) > 1 or names == ["tree"]:
        run_k2(torch, sa, k2)
    if len(k1w) > 1 or names == ["tree"]:
        run_k1w(torch, sa, k1w)
    if len(k2w) > 1 or names == ["tree"]:
        run_k2w(torch, sa, k2w)
    if len(k3) > 1 or names == ["tree"]:
        run_k3(torch, fa, k3)
    if len(k4a) > 1 or names == ["tree"]:
        run_k4a(torch, fa, k4a)
    if len(k4b) > 1 or names == ["tree"]:
        run_k4b(torch, fa, k4b)
    if len(k5) > 1 or names == ["tree"]:
        run_k5(torch, k5)
    if "k2_p_probe" in libs:
        probe_p(torch, sa, libs["k2_p_probe"])
    return 0


def probe_p(torch, sa, lib):
    """Whether K2's two passes compute the same P bit for bit: the probe
    build writes the rows pass's P into dq and the cols pass's Pᵀ into dk
    (B=4, T=64, H=1, Dh=64, one tile each way)."""
    for case, window, alibi, segments in (("causal", 0, False, False),
                                          ("window16", 16, False, False),
                                          ("alibi-kpos", 0, True, False),
                                          ("segments", 0, False, True)):
        rng = np.random.default_rng(len(case))
        args, extra = cs.attention_inputs(torch, rng, 4, 64, 1, 64, torch.float32,
                                          alibi=alibi, segments=segments)
        g = torch.zeros_like(args[0])
        with cs.kernels_of(lib):
            p_rows, p_cols, _ = sa.short_attention_bwd(*args, g, scale=0.125, window=window,
                                                       H=1, use_alibi=alibi, **extra)
        torch.cuda.synchronize()
        p_cols = p_cols.transpose(1, 2)
        differ = int((p_rows != p_cols).sum().item())
        print(f"k2_p_probe {case}: P of the rows pass and of the cols pass differ in "
              f"{differ} of {p_rows.numel()} entries (max |Δ| "
              f"{(p_rows - p_cols).abs().max().item():.3e})", flush=True)


def run_k1(torch, sa, libs):
    for name, lib in libs.items():
        errs, bad = [], []
        with cs.kernels_of(lib):
            for case, B, T, H, Dh, scale, window, alibi, segments in cs.CASES:
                args, extra = cs.attention_inputs(torch, np.random.default_rng(len(case)), B, T, H,
                                                  Dh, torch.float32, alibi=alibi,
                                                  segments=segments)
                got = sa.short_attention(*args, scale, window, H, alibi, **extra)
                want = sa.short_attention_reference(*args, scale=scale, window=window, H=H,
                                                    use_alibi=alibi, **extra)
                err = (got - want).abs()
                errs.append(f"{case} {err.max().item():.2e}")
                if ((err - cs.FP32_RTOL * want.abs()).max().item()) > cs.FP32_ATOL:
                    bad.append(case)
        print(f"{name}: fp32 gate {'FAILS in ' + ', '.join(bad) if bad else 'holds'}; "
              f"max |Δ|: {', '.join(errs)}", flush=True)
    args, _ = cs.attention_inputs(torch, np.random.default_rng(cs.SEED), 32, 300, 12, 64,
                                  torch.float32)
    q, k, v, km, _ = args
    qh, kh, vh = (cs.heads(t, 12) for t in (q, k, v))
    for window in (0, 256):
        def run():
            return sa.short_attention(*args, 1.0, window, 12, False)
        times = {name: [] for name in libs}
        for name in list(libs) + list(libs)[::-1]:
            with cs.kernels_of(libs[name]):
                times[name].append(cs.cuda_ms(torch, run))
        mask = cs.sdpa_mask(torch, km, window)
        sdpa = cs.cuda_ms(torch, lambda: torch.nn.functional.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=mask, scale=1.0))
        print(f"K1 fp32 B=32 T=300 window={window}: SDPA {sdpa:.4f} ms; " + "; ".join(
            f"{n} {np.mean(t):.4f} ms ({' '.join(f'{x:.4f}' for x in t)})"
            for n, t in times.items()), flush=True)


def run_k2(torch, sa, libs):
    for name, lib in libs.items():
        errs, bad = [], []
        with cs.kernels_of(lib):
            for case, B, T, H, Dh, scale, window, alibi, segments in cs.CASES:
                rng = np.random.default_rng(len(case))
                args, extra = cs.attention_inputs(torch, rng, B, T, H, Dh, torch.float32,
                                                  alibi=alibi, segments=segments)
                g = torch.from_numpy(rng.normal(0.0, 1.0, (B, T, H * Dh)).astype(np.float32)
                                     ).cuda()
                kw = dict(scale=scale, window=window, H=H, use_alibi=alibi, **extra)
                got = sa.short_attention_bwd(*args, g, **kw)
                want = sa.short_attention_bwd_reference(*args, g, **kw)
                worst = 0.0
                for gg, ww in zip(got, want):
                    err = (gg - ww).abs()
                    worst = max(worst, ((err - cs.FP32_RTOL * ww.abs()).max()
                                        / (cs.FP32_ATOL * ww.abs().max())).item())
                errs.append(f"{case} {worst:.2f}")
                if worst > 1:
                    bad.append(case)
        print(f"{name}: K2 fp32 gate {'FAILS in ' + ', '.join(bad) if bad else 'holds'}; "
              f"worst |Δ| − 1e-5·|ref| over 1e-5·max|ref|: {', '.join(errs)}", flush=True)
    rng = np.random.default_rng(cs.SEED)
    args, _ = cs.attention_inputs(torch, rng, 32, 300, 12, 64, torch.float32)
    g = torch.from_numpy(rng.normal(0.0, 1.0, (32, 300, 768)).astype(np.float32)).cuda()
    q, k, v, km, _ = args
    for window in (0, 256):
        def run():
            return sa.short_attention_bwd(*args, g, scale=1.0, window=window, H=12,
                                          use_alibi=False)
        times = {name: [] for name in libs}
        passes = {}
        for name in list(libs) + list(libs)[::-1]:
            with cs.kernels_of(libs[name]):
                times[name].append(cs.cuda_ms(torch, run, iters=10))
                passes[name] = cs.pass_ms(torch, run)
        qh, kh, vh = (cs.heads(t, 12).detach().contiguous().requires_grad_() for t in (q, k, v))
        out = torch.nn.functional.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=cs.sdpa_mask(torch, km, window), scale=1.0)
        gh = cs.heads(g, 12).contiguous()
        sdpa = cs.cuda_ms(torch, lambda: torch.autograd.grad(out, (qh, kh, vh), gh,
                                                             retain_graph=True), iters=10)
        print(f"K2 fp32 B=32 T=300 window={window}: SDPA backward {sdpa:.4f} ms; " + "; ".join(
            f"{n} {np.mean(t):.4f} ms ({' '.join(f'{x:.4f}' for x in t)}; rows pass "
            f"{passes[n][0]}, cols pass {passes[n][1]})" for n, t in times.items()), flush=True)


WIDE_CASES = [  # K1's and K2's fp32 cases at Dh 256: name, B, T, H, scale, window, rows, alibi
    ("gptj-train", 4, 300, 16, 1 / 16, 0, "pad", False),
    ("window16", 4, 200, 4, 1 / 16, 16, "pad", False),  # fully masked padded rows
    ("T77", 3, 77, 4, 1.0, 0, "pad", False),
    ("packed-t512", 4, 512, 4, 1 / 16, 0, "packed", False),
    ("packed-t2048-alibi", 2, 2048, 4, 1 / 16, 0, "packed", True),
]


def wide_inputs(torch, rng, B, T, H, rows, alibi):
    """GPT-J-shaped fp32 inputs (`chip_smoke.family_inputs`) with BLOOM's
    slopes where `alibi`: (q, k, v, key_mask, slopes) and the keywords."""
    from sgpt_tpu_torch.models.decoder import alibi_slopes

    q, k, v, km, seg, pos = cs.family_inputs(torch, rng, B, T, H, 256, torch.float32, rows)
    sl = alibi_slopes(H, "cuda") if alibi else None
    return (q, k, v, km, sl), dict(segments=seg, positions=pos if alibi else None)


def run_k1w(torch, sa, libs):
    """K1 fp32 at Dh 256: the fp32 gate over WIDE_CASES (with BLOOM's slopes
    at T=2048 held to fp64: no further from it than twice the plain
    version), then the time at GPT-J's training launch (B=4) and phase ab's
    B=16, T=300, H=16, scale 1/16, in turns, beside SDPA fp32."""
    for name, lib in libs.items():
        errs, bad = [], []
        with cs.kernels_of(lib):
            for case, B, T, H, scale, window, rows, alibi in WIDE_CASES:
                args, extra = wide_inputs(torch, np.random.default_rng(len(case)), B, T, H,
                                          rows, alibi)
                got = sa.short_attention(*args, scale, window, H, alibi, **extra)
                want = sa.short_attention_reference(*args, scale=scale, window=window, H=H,
                                                    use_alibi=alibi, **extra)
                try:
                    _, held = cs.hold(torch, f"k1w {case}", got, want, torch.float32, fp64=(
                        lambda: cs.k1_fp64(torch, args, window, scale, H, extra["segments"],
                                           extra["positions"])) if alibi else None)
                    errs.append(f"{case} {(got - want).abs().max().item():.2e} ({held})")
                except AssertionError as e:
                    bad.append(f"{case}: {e}")
                del args, extra, got, want
        print(f"{name}: K1 fp32 Dh 256 gate {'FAILS in ' + '; '.join(bad) if bad else 'holds'}; "
              f"max |Δ|: {', '.join(errs)}", flush=True)
    for B in (4, 16):
        (q, k, v, km, _), _ = cs.attention_inputs(torch, np.random.default_rng(cs.SEED), B, 300,
                                                  16, 256, torch.float32)

        def run():
            return sa.short_attention(q, k, v, km, None, 1 / 16, 0, 16, False)
        times = {name: [] for name in libs}
        for name in list(libs) + list(libs)[::-1]:
            with cs.kernels_of(libs[name]):
                times[name].append(cs.cuda_ms(torch, run, iters=10))
        qh, kh, vh = (cs.heads(t, 16) for t in (q, k, v))
        mask = cs.sdpa_mask(torch, km, 0)
        sdpa = cs.cuda_ms(torch, lambda: torch.nn.functional.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=mask, scale=1 / 16), iters=10)
        print(f"K1 fp32 B={B} T=300 H=16 Dh=256: SDPA {sdpa:.4f} ms; " + "; ".join(
            f"{n} {np.mean(t):.4f} ms ({' '.join(f'{x:.4f}' for x in t)})"
            for n, t in times.items()), flush=True)
        del q, k, v, km, qh, kh, vh, mask


def run_k2w(torch, sa, libs):
    """K2 fp32 at Dh 256: K2's fp32 gate over WIDE_CASES (|Δ| ≤
    1e-5·max|ref| + 1e-5·|ref| in dq, dk and dv; with BLOOM's slopes at
    T=2048 held to fp64), then the time at GPT-J's training launch (B=4) and
    phase ab's B=32, T=300, H=16, scale 1/16, each pass under
    torch.profiler, in turns, beside SDPA fp32's backward."""
    for name, lib in libs.items():
        errs, bad = [], []
        with cs.kernels_of(lib):
            for case, B, T, H, scale, window, rows, alibi in WIDE_CASES:
                rng = np.random.default_rng(len(case))
                args, extra = wide_inputs(torch, rng, B, T, H, rows, alibi)
                g = cs.card_normal(torch, rng, (B, T, H * 256), 1.0)
                kw = dict(scale=scale, window=window, H=H, use_alibi=alibi, **extra)
                got = sa.short_attention_bwd(*args, g, **kw)
                want = sa.short_attention_bwd_reference(*args, g, **kw)
                try:
                    e, held, _ = cs.hold_grads(torch, f"k2w {case}", got, want, torch.float32,
                                               fp64=(lambda: cs.k2_fp64(
                                                   torch, args, g, window, scale, H,
                                                   **extra)) if alibi else None)
                    errs.append(f"{case} {max(e):.2e} ({held})")
                except AssertionError as ex:
                    bad.append(f"{case}: {ex}")
                del args, extra, g, got, want
        print(f"{name}: K2 fp32 Dh 256 gate {'FAILS in ' + '; '.join(bad) if bad else 'holds'}; "
              f"max |Δ|: {', '.join(errs)}", flush=True)
    for B in (4, 32):
        rng = np.random.default_rng(cs.SEED)
        (q, k, v, km, _), _ = cs.attention_inputs(torch, rng, B, 300, 16, 256, torch.float32)
        g = cs.card_normal(torch, rng, (B, 300, 4096), 1.0)

        def run():
            return sa.short_attention_bwd(q, k, v, km, None, g, scale=1 / 16, window=0, H=16,
                                          use_alibi=False)
        times = {name: [] for name in libs}
        passes = {}
        for name in list(libs) + list(libs)[::-1]:
            with cs.kernels_of(libs[name]):
                times[name].append(cs.cuda_ms(torch, run, iters=10))
                passes[name] = cs.pass_ms(torch, run)
        qh, kh, vh = (cs.heads(t, 16).detach().contiguous().requires_grad_() for t in (q, k, v))
        out = torch.nn.functional.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=cs.sdpa_mask(torch, km, 0), scale=1 / 16)
        gh = cs.heads(g, 16).contiguous()
        sdpa = cs.cuda_ms(torch, lambda: torch.autograd.grad(out, (qh, kh, vh), gh,
                                                             retain_graph=True), iters=10)
        print(f"K2 fp32 B={B} T=300 H=16 Dh=256: SDPA backward {sdpa:.4f} ms; " + "; ".join(
            f"{n} {np.mean(t):.4f} ms ({' '.join(f'{x:.4f}' for x in t)}; rows pass "
            f"{passes[n][0]}, cols pass {passes[n][1]})" for n, t in times.items()), flush=True)
        del q, k, v, km, g, qh, kh, vh, out, gh


def run_k3(torch, fa, libs):
    for name, lib in libs.items():
        errs, bad = [], []
        with cs.kernels_of(lib):
            for case, B, T, H, Dh, block_kv, scale, window, alibi in cs.FLASH_CASES:
                B = min(B, 8)  # fp32 at the long train's batch, as phase flash takes it
                (q, k, v, km, slopes), _ = cs.attention_inputs(
                    torch, np.random.default_rng(len(case)), B, T, H, Dh, torch.float32,
                    alibi=alibi)
                slopes = slopes * 0.03 if alibi else None  # BLOOM-sized slopes
                qh, kh, vh = (cs.heads(t, H) for t in (q, k, v))
                kw = dict(scale=scale, window=window, block_kv=block_kv)
                got, lse = fa.flash_attention(qh, kh, vh, km, slopes, return_residuals=True,
                                              **kw)
                want, want_lse = fa.flash_attention_reference(qh, kh, vh, km, slopes, **kw)
                dead = want_lse == fa.NEG_INF
                err = (got - want).abs()
                lerr = (lse - want_lse).abs()[~dead]
                errs.append(f"{case} {err.max().item():.2e}/{lerr.max().item():.2e}")
                if (((err - cs.FP32_RTOL * want.abs()).max().item() > cs.FP32_ATOL)
                        or (lerr - cs.FP32_RTOL * want_lse.abs()[~dead]).max().item()
                        > cs.FP32_ATOL or not torch.equal(lse == fa.NEG_INF, dead)):
                    bad.append(case)
                del q, k, v, qh, kh, vh, got, want, lse, want_lse
        print(f"{name}: K3 fp32 gate {'FAILS in ' + ', '.join(bad) if bad else 'holds'}; "
              f"max |Δ| output/lse: {', '.join(errs)}", flush=True)
    (q, k, v, km, _), _ = cs.attention_inputs(torch, np.random.default_rng(cs.SEED), 8, 2048,
                                              12, 64, torch.float32)
    qh, kh, vh = (cs.heads(t, 12) for t in (q, k, v))
    for window in (0, 256):
        def run():
            return fa.flash_attention(qh, kh, vh, km, window=window, block_kv=256)
        times = {name: [] for name in libs}
        for name in list(libs) + list(libs)[::-1]:
            with cs.kernels_of(libs[name]):
                times[name].append(cs.cuda_ms(torch, run, iters=10))
        mask = cs.sdpa_mask(torch, km, window)
        sdpa = cs.cuda_ms(torch, lambda: torch.nn.functional.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=mask, scale=1.0), iters=5)
        print(f"K3 fp32 B=8 T=2048 window={window}: SDPA {sdpa:.4f} ms; " + "; ".join(
            f"{n} {np.mean(t):.4f} ms ({' '.join(f'{x:.4f}' for x in t)})"
            for n, t in times.items()), flush=True)
        del mask


def fbwd_cases(torch, fa, base):
    """`chip_smoke.FBWD_CASES` in fp32 at B ≤ 8: (name, K4's arguments from
    the base library's K3, the plain version's (dq, dk, dv))."""
    cases = []
    for case, B, T, H, Dh, block_kv, scale, window, alibi in cs.FBWD_CASES:
        rng = np.random.default_rng(len(case))
        (q, k, v, km, slopes), _ = cs.attention_inputs(torch, rng, min(B, 8), T, H, Dh,
                                                       torch.float32, alibi=alibi)
        slopes = slopes * 0.03 if alibi else None  # BLOOM-sized slopes
        qh, kh, vh = (cs.heads(t, H) for t in (q, k, v))
        g = cs.heads(torch.from_numpy(rng.normal(0.0, 1.0, q.shape).astype(np.float32)).cuda(),
                     H)
        kw = dict(scale=scale, window=window, block_kv=block_kv)
        with cs.kernels_of(base):
            out, lse = fa.flash_attention(qh, kh, vh, km, slopes, return_residuals=True, **kw)
        args = fa._bwd_args(qh, kh, vh, km, slopes, g, out, lse, scale, window, 128,
                            min(block_kv, T))
        want = fa.flash_attention_bwd_reference(qh, kh, vh, km, slopes, g, out, lse, **kw)
        cases.append((case, args, want))
    return cases


def gate_worst(got, want) -> float:
    """The largest |Δ| − 1e-5·|ref| over 1e-5·max|ref|: above 1 fails K4's fp32 gate."""
    return ((got - want).abs() - cs.FP32_RTOL * want.abs()).max().item() / (
        cs.FP32_ATOL * want.abs().max().item())


def run_k4a(torch, fa, libs):
    """K4a's fp32 gate over `chip_smoke.FBWD_CASES` (fp32, B ≤ 8, the
    residuals from the first library's K3) in dq, its D bit for bit against
    the first library's, then its time alone at B=8, T=2048, window 0 and
    256, in turns."""
    base = next(iter(libs.values()))
    cases = fbwd_cases(torch, fa, base)
    d_base = {}
    for name, lib in libs.items():
        errs, bad = [], []
        with cs.kernels_of(lib):
            for case, args, want in cases:
                try:
                    fa._launch_dq(args)
                except RuntimeError as e:  # e.g. more shared memory than a block may have
                    bad.append(f"{case} ({e})")
                    continue
                torch.cuda.synchronize()
                dsum = args["keep"][8].clone()
                same_d = torch.equal(d_base.setdefault(case, dsum), dsum)
                worst = gate_worst(args["grads"][0], want[0])
                errs.append(f"{case} {worst:.2f}")
                if worst > 1 or not same_d:
                    bad.append(case + ("" if same_d else " (D moved)"))
        print(f"{name}: K4a fp32 gate {'FAILS in ' + ', '.join(bad) if bad else 'holds'}; "
              f"worst |Δ| − 1e-5·|ref| over 1e-5·max|ref| in dq: {', '.join(errs)}", flush=True)
    del cases, d_base
    rng = np.random.default_rng(cs.SEED)
    (q, k, v, km, _), _ = cs.attention_inputs(torch, rng, 8, 2048, 12, 64, torch.float32)
    qh, kh, vh = (cs.heads(t, 12) for t in (q, k, v))
    g = cs.heads(torch.from_numpy(rng.normal(0.0, 1.0, q.shape).astype(np.float32)).cuda(), 12)
    for window in (0, 256):
        with cs.kernels_of(base):
            out, lse = fa.flash_attention(qh, kh, vh, km, window=window, block_kv=256,
                                          return_residuals=True)
        args = fa._bwd_args(qh, kh, vh, km, None, g, out, lse, 1.0, window, 128, 256)
        times = {name: [] for name in libs}
        for name in list(libs) + list(libs)[::-1]:
            with cs.kernels_of(libs[name]):
                times[name].append(cs.cuda_ms(torch, lambda: fa._launch_dq(args), iters=10))
        print(f"K4a fp32 B=8 T=2048 window={window}: "
              + "; ".join(f"{n} {np.mean(t):.4f} ms ({' '.join(f'{x:.4f}' for x in t)})"
                          for n, t in times.items()), flush=True)
        del out, lse, args


def run_k4b(torch, fa, libs):
    """K4b's fp32 gate over `chip_smoke.FBWD_CASES` (fp32, B ≤ 8; the
    residuals and D from the first library's K3 and K4a, which no k4b_
    variant changes), then its time alone at B=8, T=2048, window 0 and 256,
    in turns."""
    base = next(iter(libs.values()))
    cases = []
    for case, B, T, H, Dh, block_kv, scale, window, alibi in cs.FBWD_CASES:
        rng = np.random.default_rng(len(case))
        (q, k, v, km, slopes), _ = cs.attention_inputs(torch, rng, min(B, 8), T, H, Dh,
                                                       torch.float32, alibi=alibi)
        slopes = slopes * 0.03 if alibi else None  # BLOOM-sized slopes
        qh, kh, vh = (cs.heads(t, H) for t in (q, k, v))
        g = cs.heads(torch.from_numpy(rng.normal(0.0, 1.0, q.shape).astype(np.float32)).cuda(),
                     H)
        kw = dict(scale=scale, window=window, block_kv=block_kv)
        with cs.kernels_of(base):
            out, lse = fa.flash_attention(qh, kh, vh, km, slopes, return_residuals=True, **kw)
            args = fa._bwd_args(qh, kh, vh, km, slopes, g, out, lse, scale, window, 128,
                                min(block_kv, T))
            fa._launch_dq(args)  # D for K4b
        want = fa.flash_attention_bwd_reference(qh, kh, vh, km, slopes, g, out, lse, **kw)
        cases.append((case, args, want[1:]))
    for name, lib in libs.items():
        errs, bad = [], []
        with cs.kernels_of(lib):
            for case, args, want in cases:
                fa._launch_dkv(args)
                torch.cuda.synchronize()
                worst = 0.0
                for gg, ww in zip(args["grads"][1:], want):
                    err = (gg - ww).abs()
                    worst = max(worst, ((err - cs.FP32_RTOL * ww.abs()).max()
                                        / (cs.FP32_ATOL * ww.abs().max())).item())
                errs.append(f"{case} {worst:.2f}")
                if worst > 1:
                    bad.append(case)
        print(f"{name}: K4b fp32 gate {'FAILS in ' + ', '.join(bad) if bad else 'holds'}; "
              f"worst |Δ| − 1e-5·|ref| over 1e-5·max|ref| in dk, dv: {', '.join(errs)}",
              flush=True)
    del cases
    rng = np.random.default_rng(cs.SEED)
    (q, k, v, km, _), _ = cs.attention_inputs(torch, rng, 8, 2048, 12, 64, torch.float32)
    qh, kh, vh = (cs.heads(t, 12) for t in (q, k, v))
    g = cs.heads(torch.from_numpy(rng.normal(0.0, 1.0, q.shape).astype(np.float32)).cuda(), 12)
    for window in (0, 256):
        with cs.kernels_of(base):
            out, lse = fa.flash_attention(qh, kh, vh, km, window=window, block_kv=256,
                                          return_residuals=True)
            args = fa._bwd_args(qh, kh, vh, km, None, g, out, lse, 1.0, window, 128, 256)
            fa._launch_dq(args)
        times = {name: [] for name in libs}
        for name in list(libs) + list(libs)[::-1]:
            with cs.kernels_of(libs[name]):
                times[name].append(cs.cuda_ms(torch, lambda: fa._launch_dkv(args), iters=10))
        qs, ks, vs = (t.detach().contiguous().requires_grad_() for t in (qh, kh, vh))
        lib_out = torch.nn.functional.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=cs.sdpa_mask(torch, km, window), scale=1.0)
        gs = g.contiguous()
        sdpa = cs.cuda_ms(torch, lambda: torch.autograd.grad(lib_out, (qs, ks, vs), gs,
                                                             retain_graph=True), iters=5)
        print(f"K4b fp32 B=8 T=2048 window={window}: SDPA backward (dq, dk, dv) {sdpa:.4f} ms; "
              + "; ".join(f"{n} {np.mean(t):.4f} ms ({' '.join(f'{x:.4f}' for x in t)})"
                          for n, t in times.items()), flush=True)
        del out, lse, args, qs, ks, vs, lib_out, gs



def run_k5(torch, libs):
    """K5's bf16 scan against the plain version with K5's rule
    (`chip_smoke.check_topk`) over NQ's corpus (2,681,468 × 768 bf16): Q =
    64, 8, 65 and 1024, all-equal rows, duplicates on both sides of the
    tree's split boundaries and valid_count one row either side of a tile
    boundary; then its time at Q = 64 and Q = 8 (k = 10), two rounds in
    turns, with GB/s of the corpus read."""
    from sgpt_tpu_torch.ops import mips

    N, D = cs.NQ_ROWS, 768
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    c = cs.unit_rows(torch, gen, N, D, torch.bfloat16)
    q = cs.unit_rows(torch, gen, 1024, D, torch.bfloat16)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    b = mips._rows_per_split(N, mips._splits(64, N, sms, 64, mips.MMA_TILE_ROWS),
                             mips.MMA_TILE_ROWS)
    rows = [b - 1, b, b + 1, 2 * b - 1, 2 * b]
    eq = c[:300_000].clone()
    eq[:] = eq[11].clone()
    for name, lib in libs.items():
        bad = []
        with cs.kernels_of(lib):
            for case, qq, valid in (("Q64", q[:64], N), ("Q8", q[:8], N), ("Q65", q[:65], N),
                                    ("Q1024", q, N), ("valid-tile-1", q[:64], 40 * 256 - 1),
                                    ("valid-tile+1", q[:64], 40 * 256 + 1)):
                try:
                    cs.check_topk(torch, qq, c, mips.mips_topk(qq, c, valid, 10),
                                  mips.mips_topk_reference(qq, c, valid, 10), case)
                except AssertionError as e:
                    bad.append(f"{case}: {e}")
            got = mips.mips_topk(q[:64], eq, eq.shape[0], 10)
            if not (got[1] == torch.arange(10, device="cuda", dtype=torch.int32)).all():
                bad.append("all-equal: ids are not 0 .. 9")
            saved = c[rows].clone()
            c[rows] = c[5].clone()
            qs = q[:64].clone()
            qs[0] = c[5]
            got = mips.mips_topk(qs, c, N, 10)
            if got[1][0, :6].tolist() != [5, *rows]:
                bad.append(f"split-dups: {got[1][0, :6].tolist()}")
            c[rows] = saved
        print(f"{name}: K5 bf16 {'FAILS: ' + '; '.join(bad) if bad else 'holds K5 rule'} "
              f"(Q 64, 8, 65, 1024, valid at a tile boundary ± 1, all-equal, split-dups)",
              flush=True)
    del eq
    for Q in (64, 8):
        qq = q[:Q].contiguous()
        times = {name: [] for name in libs}
        for name in list(libs) + list(libs)[::-1]:
            with cs.kernels_of(libs[name]):
                times[name].append(cs.cuda_ms(torch, lambda: mips.mips_topk(qq, c, N, 10),
                                              iters=20, warmup=2))
        gb = c.numel() * 2 * -(-Q // 64) / 1e6
        print(f"K5 bf16 Q={Q} N={N} D={D} k=10: "
              + "; ".join(f"{n} {np.mean(t):.4f} ms, {gb / np.mean(t):.1f} GB/s "
                          f"({' '.join(f'{x:.4f}' for x in t)})" for n, t in times.items()),
              flush=True)
    del c, q


if __name__ == "__main__":
    sys.exit(main())
