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


def _splits(Q: int, valid: int, sms: int) -> int:
    """Corpus splits of pass 1: about two blocks per SM in all, at least 128
    rows each, as the kernel sees queries in blocks of up to 64."""
    per_split_rows = -(-max(valid, 1) // 128)
    return max(1, min(per_split_rows, -(-2 * sms // -(-Q // 64)), 65535))


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
    sms = torch.cuda.get_device_properties(queries.device).multi_processor_count
    splits = _splits(Q, valid, sms)
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
