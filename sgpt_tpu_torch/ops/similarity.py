"""Similarity scores (counterpart of `sgpt_tpu/ops/similarity.py`).

Scores are computed and returned in fp32 whatever the embedding dtype, as
the JAX functions accumulate with `preferred_element_type=float32` at the
highest precision. `_norm` normalises in fp32 and casts back to the input
dtype, as JAX does, so bf16 embeddings are rounded once more before scoring.
"""
from __future__ import annotations

import torch


def _norm(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    x32 = x.float()
    n = torch.linalg.vector_norm(x32, dim=-1, keepdim=True)
    return (x32 / n.clamp_min(eps)).to(x.dtype)


def dot_score(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(Na, D) x (Nb, D) -> (Na, Nb) fp32 inner products."""
    return a.float() @ b.float().T


def cos_sim(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(Na, D) x (Nb, D) -> (Na, Nb) cosine similarities."""
    return dot_score(_norm(a), _norm(b))


def pairwise_cos_sim(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row-wise cosine of equal-shaped (N, D) tensors -> (N,)."""
    return (_norm(a).float() * _norm(b).float()).sum(-1)
