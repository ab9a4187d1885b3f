"""The served search's index rows and the reference's exact top-k.

The index is the benchmark's own: N unit rows of width D, drawn from the seed
on the device chunk by chunk (float32 normal rows, normalised, rounded to
bfloat16), so the reference can draw any chunk again instead of holding the
corpus beside the program's copy.
"""
from __future__ import annotations

from typing import Iterator, List, Sequence, Tuple

import torch

from .model import group_seed, strict_fp32

CHUNK_ROWS = 1 << 18
CORPUS_GROUP = 1 << 20   # group ids of corpus chunks start here (weights use 0..L)


def corpus_chunk(seed: int, c: int, n: int, d: int, device,
                 dtype=torch.bfloat16) -> torch.Tensor:
    """Rows [c·CHUNK_ROWS, min((c+1)·CHUNK_ROWS, n)) of the index."""
    rows = min(CHUNK_ROWS, n - c * CHUNK_ROWS)
    gen = torch.Generator(device=device).manual_seed(group_seed(seed, CORPUS_GROUP + c))
    x = torch.randn((rows, d), generator=gen, device=device)
    return (x / x.norm(dim=1, keepdim=True)).to(dtype)


def corpus_chunks(seed: int, n: int, d: int, device) -> Iterator[Tuple[int, torch.Tensor]]:
    for c in range((n + CHUNK_ROWS - 1) // CHUNK_ROWS):
        yield c * CHUNK_ROWS, corpus_chunk(seed, c, n, d, device)


def exact_scores(seed: int, n: int, d: int, queries: torch.Tensor, k: int,
                 ids: Sequence[Sequence[int]]) -> Tuple[torch.Tensor, torch.Tensor, List[List[float]]]:
    """Over the whole index, in float32 with TF32 off: each query's k best
    scores and their rows, descending, and the scores of the rows `ids[i]`
    (what the program returned for query i). queries: (Q, D) float32 unit
    rows on the index's device."""
    device = queries.device
    best_v = torch.full((queries.shape[0], k), float("-inf"), device=device)
    best_i = torch.zeros((queries.shape[0], k), dtype=torch.long, device=device)
    got = [[None] * len(r) for r in ids]
    with strict_fp32(), torch.no_grad():
        for base, rows in corpus_chunks(seed, n, d, device):
            s = queries @ rows.float().T                       # (Q, rows)
            v, i = torch.topk(torch.cat([best_v, s], 1), k, dim=1)
            cand = torch.cat([best_i, base + torch.arange(s.shape[1], device=device)
                              .expand(s.shape[0], -1)], 1)
            best_v, best_i = v, cand.gather(1, i)
            for qi, r in enumerate(ids):
                for j, row in enumerate(r):
                    if base <= row < base + s.shape[1]:
                        got[qi][j] = float(s[qi, row - base])
    return best_v, best_i, got
