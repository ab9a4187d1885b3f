"""Exact top-k inner-product search in plain PyTorch (counterpart of `sgpt_tpu/ops/topk.py`).

`merge_topk`, `chunked_topk` and `blockmax_topk` keep the JAX algorithms
step for step, so that they return the same ids as the JAX functions, ties
included. `jax.lax.top_k` puts the lower index first among equal values;
`torch.topk` promises no order, so every selection here is a stable
descending sort (`_top_k`). Scores are fp32: the operands are upcast before
the product, which is exact for bf16 and int8 values, as the JAX einsum with
`preferred_element_type=float32` is. Masked columns score -inf (`NEG`); the
streaming kernel `ops/mips.py` masks with -1e30 instead, as its TPU
original does.
"""
from __future__ import annotations

import torch

NEG = float("-inf")


def _top_k(x: torch.Tensor, k: int):
    """`jax.lax.top_k` along the last axis: values descending, ties to the
    lower position."""
    vals, pos = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], pos[..., :k]


def merge_topk(vals_a, idx_a, vals_b, idx_b, k: int):
    """Merge two (Q, ka|kb) candidate sets into the top-k union; on equal
    values the first set's candidates come first."""
    vals = torch.cat([vals_a, vals_b], dim=-1)
    idx = torch.cat([idx_a, idx_b], dim=-1)
    top_vals, pos = _top_k(vals, k)
    return top_vals, torch.gather(idx, -1, pos)


def _scores(queries, tile):
    """(Q, D) · (C, D)ᵀ in fp32 with exact products."""
    return queries.float() @ tile.float().T


def chunked_topk(queries: torch.Tensor, corpus: torch.Tensor, valid_count,
                 k: int = 10, chunk_size: int = 4096, normalized: bool = True):
    """Top-k inner-product search, one corpus chunk at a time with a running
    merge. corpus: (N, D) with N a multiple of chunk_size; rows at or beyond
    `valid_count` are masked. Returns (scores (Q, k) fp32, indices (Q, k) int32)."""
    del normalized  # cosine == dot on pre-normalized inputs
    Q = queries.shape[0]
    N = corpus.shape[0]
    assert N % chunk_size == 0, "pad corpus to a multiple of chunk_size"
    dev = queries.device
    run_vals = torch.full((Q, k), NEG, dtype=torch.float32, device=dev)
    run_idx = torch.zeros((Q, k), dtype=torch.int32, device=dev)
    col = torch.arange(chunk_size, dtype=torch.int32, device=dev)
    kk = min(k, chunk_size)
    for base in range(0, N, chunk_size):
        scores = _scores(queries, corpus[base: base + chunk_size])
        scores = torch.where((base + col)[None, :] < valid_count, scores, NEG)
        t_vals, t_idx = _top_k(scores, kk)
        run_vals, run_idx = merge_topk(run_vals, run_idx, t_vals,
                                       (base + t_idx).to(torch.int32), k)
    return run_vals, run_idx


def blockmax_topk(queries: torch.Tensor, corpus: torch.Tensor, valid_count,
                  k: int = 100, block_size: int = 128, slab_size: int = 1 << 20,
                  corpus_scale=None, row_mask=None):
    """Exact top-k MIPS by block-max candidate filtering, slab by slab.

    Per slab: fp32 scores (Q, S); the maximum of each block of `block_size`
    docs; the k blocks with the highest maxima; the top-k of those blocks'
    scores. A doc of the true top-k scores at least the k-th best, so its
    block's maximum does too, and the k best blocks cover the true top-k
    (modulo ties, which follow the JAX order). Slabs merge into a running
    (Q, k) buffer.

    corpus: (N, D), N % block_size == 0; rows >= valid_count are masked.
    corpus_scale: optional (N,) fp32 row scales of an int8 corpus; the
    queries are rounded to bf16 and the scores are (q_bf16 · row) × scale.
    row_mask: optional (N,) bool; False rows score -inf (tombstones).
    """
    Q, D = queries.shape
    N = corpus.shape[0]
    assert N % block_size == 0, "pad corpus to a multiple of block_size"
    slab_size = min(slab_size, N)
    slab_size = max(block_size, slab_size - slab_size % block_size)
    if N % slab_size:  # one slab when N doesn't tile evenly
        slab_size = N
    n_slabs = N // slab_size
    blocks_per_slab = slab_size // block_size
    kb = min(k, blocks_per_slab)
    dev = queries.device
    if corpus_scale is not None:
        assert corpus.dtype == torch.int8, "corpus_scale implies an int8 corpus"
        queries = queries.to(torch.bfloat16)
    col = torch.arange(slab_size, dtype=torch.int64, device=dev)

    def slab_topk(base: int):
        slab = corpus[base: base + slab_size]
        scores = _scores(queries, slab)
        if corpus_scale is not None:
            scores = scores * corpus_scale[base: base + slab_size].float()[None, :]
        scores = torch.where((base + col)[None, :] < valid_count, scores, NEG)
        if row_mask is not None:
            scores = torch.where(row_mask[base: base + slab_size][None, :], scores, NEG)
        tiled = scores.reshape(Q, blocks_per_slab, block_size)
        blockmax = tiled.amax(dim=2)                                   # (Q, S/B)
        _, blk_idx = _top_k(blockmax, kb)                              # (Q, kb)
        cand = torch.gather(tiled, 1, blk_idx[:, :, None].expand(Q, kb, block_size))
        cand = cand.reshape(Q, kb * block_size)
        kk = min(k, kb * block_size)
        c_vals, c_pos = _top_k(cand, kk)                               # (Q, kk)
        c_blk = torch.gather(blk_idx, 1, torch.div(c_pos, block_size, rounding_mode="floor"))
        c_doc = base + c_blk * block_size + c_pos % block_size
        return c_vals, c_doc.to(torch.int32)

    if n_slabs == 1:
        vals, idx = slab_topk(0)
        if vals.shape[1] < k:
            pad = k - vals.shape[1]
            vals = torch.cat([vals, torch.full((Q, pad), NEG, device=dev)], dim=1)
            idx = torch.cat([idx, torch.zeros((Q, pad), dtype=torch.int32, device=dev)],
                            dim=1)
        return vals, idx

    run_vals = torch.full((Q, k), NEG, dtype=torch.float32, device=dev)
    run_idx = torch.zeros((Q, k), dtype=torch.int32, device=dev)
    for i in range(n_slabs):
        c_vals, c_doc = slab_topk(i * slab_size)
        run_vals, run_idx = merge_topk(run_vals, run_idx, c_vals, c_doc, k)
    return run_vals, run_idx
