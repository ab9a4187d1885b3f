"""Streaming exact MIPS top-k (counterpart of `sgpt_tpu/ops/pallas/mips.py`).

`mips_topk` launches the kernel of `csrc/mips.cu` (K5) on a CUDA tensor and
takes `mips_topk_reference`, the plain PyTorch version of the same function,
on a CPU tensor; the plain version is also the kernel's oracle on the card.
A CUDA tensor never takes the plain version: the kernel launches or the call
raises.

Both return, for each query, the top-k rows among the first `valid_count`
in the total order (score desc, row index asc), with fp32 scores. Slots that
no valid row fills (valid_count < k) hold -1e30 with index 0; the TPU kernel
puts -1e30 there too, with the index of a masked row, and `DenseIndex` trims
every slot at or below -1e29.
"""
from __future__ import annotations

import torch

NEG = -1e30   # the TPU kernel's mask value (ops/topk.py masks with -inf)
K_MAX = 16    # as the JAX function asserts: larger k goes to blockmax_topk
PLAIN_SCORES = 1 << 24  # (Q, rows) fp32 scores per chunk of the plain version
MMA_TILE_ROWS = 256  # rows a tile of the tensor-core scan (csrc/mips.cu MM_TR)
SIMT_TILE_ROWS = 64  # of the CUDA-core scan (SM_TN)
SIMT_BLOCKS_PER_SM = 2  # blocks of the CUDA-core scan planned an SM (the
# tensor-core scan's ring fills an SM's shared memory: one block an SM)
# the tensor-core scan's shared memory (csrc/mips.cu): a block's 227 KB hold
# the queries (rows of D rounded up to 64, + 8), the lists, the candidate
# queue and ring stages of 256 rows × 32 bf16 features
SMEM_MAX = 232448
MMA_STAGE_BYTES = MMA_TILE_ROWS * 32 * 2
MMA_MAX_STAGES, MMA_MIN_STAGES = 8, 3
QUEUE = 1024

# kernel launches made by `mips_topk`; reset and read by chip_smoke.py
launches = 0


def _check_k(k: int):
    if not 1 <= k <= K_MAX:
        raise ValueError(f"mips_topk: k={k} outside [1, {K_MAX}]; use blockmax_topk "
                         "for large k")


def mips_topk_reference(queries: torch.Tensor, corpus: torch.Tensor, valid_count,
                        k: int = 10):
    """Plain PyTorch version: fp32 scores over corpus chunks (the (Q, N)
    matrix is never whole), each merged into a running (Q, k) buffer by a
    stable descending sort. The buffer precedes the chunk, and its rows are
    lower, so ties keep the lower row first."""
    _check_k(k)
    Q = queries.shape[0]
    N = corpus.shape[0]
    valid = max(0, min(int(valid_count), N))
    dev = queries.device
    vals = torch.full((Q, k), NEG, dtype=torch.float32, device=dev)
    idx = torch.zeros((Q, k), dtype=torch.int32, device=dev)
    qf = queries.float()
    chunk = max(1024, PLAIN_SCORES // max(Q, 1))
    for s in range(0, valid, chunk):
        e = min(valid, s + chunk)
        scores = qf @ corpus[s:e].float().T
        cat_v = torch.cat([vals, scores], dim=1)
        cat_i = torch.cat([idx, torch.arange(s, e, dtype=torch.int32, device=dev)
                           .expand(Q, e - s)], dim=1)
        top_v, pos = torch.sort(cat_v, dim=1, descending=True, stable=True)
        vals = top_v[:, :k]
        idx = torch.gather(cat_i, 1, pos[:, :k])
    return vals, idx


def _rows_per_split(valid: int, splits: int, tile_rows: int) -> int:
    """Rows of each split as pass 1 computes them (`csrc/mips.cu`,
    `launch_mma`/`launch_simt`): an equal share rounded up to whole tiles;
    the last split ends at `valid`."""
    share = -(-valid // splits)
    return max(tile_rows, -(-share // tile_rows) * tile_rows)


def _splits(Q: int, valid: int, slots: int, qb: int, tile_rows: int) -> int:
    """Corpus splits of pass 1: one contiguous split per block, and blocks
    (query blocks × splits) that fill `slots` (resident blocks on the card)
    in the fewest waves that use at least 90 % of them, so each block
    streams its split without draining its ring between splits. Never more
    splits than tiles, and none left empty: the count is recomputed from the
    rows each split gets."""
    blocks = -(-Q // qb)
    rows = max(valid, 1)
    splits = 1
    for waves in range(1, 9):
        s = waves * slots // blocks
        if s >= 1 and blocks * s >= 0.9 * waves * slots:
            splits = s
            break
    splits = max(1, min(splits, -(-rows // tile_rows), 65535))
    return -(-rows // _rows_per_split(rows, splits, tile_rows))


def _mma_stages(qb: int, D: int) -> int:
    """Ring stages of the tensor-core scan beside qb queries of width D
    (`mma_stages` in csrc/mips.cu)."""
    fixed = 2 * qb * (-(-D // 64) * 64 + 8) + 8 * qb * K_MAX + 8 * QUEUE + 16
    return 0 if fixed >= SMEM_MAX else min(MMA_MAX_STAGES, (SMEM_MAX - fixed) // MMA_STAGE_BYTES)


def _mma_query_block(Q: int, D: int) -> int:
    """The tensor-core scan's block of queries (`mma_qb` in csrc/mips.cu,
    which `query_block` asks): the smallest of 8, 16, 32, 64 that holds all
    Q, halved while fewer than MMA_MIN_STAGES ring stages fit (0: not even
    two fit at 8)."""
    qb = 8
    while qb < 64 and qb < Q:
        qb *= 2
    while qb > 8 and _mma_stages(qb, D) < MMA_MIN_STAGES:
        qb //= 2
    return qb if _mma_stages(qb, D) >= 2 else 0


def _tile_rows(dtype: torch.dtype, D: int, aligned: bool) -> int:
    """Rows of a pass-1 tile: the tensor-core scan's (bf16, D % 16 == 0,
    16-byte aligned rows) or the CUDA-core scan's."""
    return MMA_TILE_ROWS if dtype == torch.bfloat16 and D % 16 == 0 and aligned \
        else SIMT_TILE_ROWS


def query_block(Q: int, D: int, dtype: torch.dtype, aligned: bool = True) -> int:
    """Queries a block of pass 1 keeps resident (the corpus is read
    ceil(Q / block) times per search)."""
    from ._build import library
    return library().sgpt_mips_query_block(Q, D, int(dtype == torch.bfloat16), int(aligned))


def mips_topk(queries: torch.Tensor, corpus: torch.Tensor, valid_count, k: int = 10):
    """queries (Q, D) and corpus (N, D), both float32 or both bfloat16;
    rows >= valid_count (clamped to [0, N]) are masked; k <= 16. Returns
    (vals (Q, k) fp32 descending, idx (Q, k) int32): K5 on a CUDA tensor,
    `mips_topk_reference` on a CPU tensor. Compare ids only in slots above
    -1e29."""
    global launches
    _check_k(k)
    if queries.device.type == "cpu":
        return mips_topk_reference(queries, corpus, valid_count, k)
    if queries.device.type != "cuda":
        raise RuntimeError(f"mips_topk: no kernel for device {queries.device}")
    if queries.dim() != 2 or corpus.dim() != 2 or queries.shape[1] != corpus.shape[1]:
        raise ValueError(f"mips_topk: queries {tuple(queries.shape)} and corpus "
                         f"{tuple(corpus.shape)} are not (Q, D) and (N, D)")
    if queries.dtype not in (torch.float32, torch.bfloat16) or corpus.dtype != queries.dtype:
        raise TypeError(f"mips_topk: dtypes {queries.dtype}, {corpus.dtype}; the kernel "
                        "takes both float32 or both bfloat16")
    if corpus.device != queries.device:
        raise ValueError(f"mips_topk: corpus on {corpus.device}, queries on {queries.device}")
    if not corpus.is_contiguous():
        raise ValueError("mips_topk: corpus is not contiguous")
    if corpus.shape[0] >= 2**31:
        raise ValueError(f"mips_topk: N={corpus.shape[0]} rows; row ids are int32")
    queries = queries.contiguous()
    Q, D = queries.shape
    N = corpus.shape[0]
    out_v = torch.empty((Q, k), dtype=torch.float32, device=queries.device)
    out_i = torch.empty((Q, k), dtype=torch.int32, device=queries.device)
    if Q == 0:
        return out_v, out_i
    from ._build import check, library

    valid = max(0, min(int(valid_count), N))
    aligned = queries.data_ptr() % 16 == 0 and corpus.data_ptr() % 16 == 0
    tile_rows = _tile_rows(queries.dtype, D, aligned)
    qb = query_block(Q, D, queries.dtype, aligned)
    if qb == 0:
        raise ValueError(f"mips_topk: D={D} leaves no room for a block of queries")
    slots = torch.cuda.get_device_properties(queries.device).multi_processor_count
    if tile_rows == SIMT_TILE_ROWS:
        slots *= SIMT_BLOCKS_PER_SM
    splits = _splits(Q, valid, slots, qb, tile_rows)
    cand_v = torch.empty((splits, Q, k), dtype=torch.float32, device=queries.device)
    cand_i = torch.empty((splits, Q, k), dtype=torch.int32, device=queries.device)
    with torch.cuda.device(queries.device):
        code = library().sgpt_mips_topk(
            queries.data_ptr(), corpus.data_ptr(), cand_v.data_ptr(), cand_i.data_ptr(),
            out_v.data_ptr(), out_i.data_ptr(), Q, N, D, valid, k, splits,
            int(queries.dtype == torch.bfloat16),
            torch.cuda.current_stream(queries.device).cuda_stream)
    check(code, "mips_topk")
    launches += 1
    return out_v, out_i
