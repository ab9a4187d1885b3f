"""Pooling: hidden states (B, T, D) + attention mask (B, T) → sentence embedding (B, D).

Counterpart of `sgpt_tpu/ops/pooling.py` for the methods the encode path
uses. The dtype flow is the JAX one: accumulate in fp32, cast to the hidden
dtype; `normalize` again computes in fp32 and casts back. In bf16 the
embedding is therefore rounded twice, and parity with the JAX package
depends on that.
"""
from __future__ import annotations

import torch


def _masked(hidden: torch.Tensor, mask: torch.Tensor):
    m = mask.float()[..., None]                       # (B, T, 1)
    return hidden.float() * m, m


def mean_pool(hidden: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    h, m = _masked(hidden, mask)
    return (h.sum(1) / m.sum(1).clamp_min(1e-9)).to(hidden.dtype)


def weighted_mean_pool(hidden: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Position-weighted mean: weight of position t (0-based) is t+1, on the
    *padded* index (with right padding the two agree)."""
    T = hidden.shape[1]
    w = torch.arange(1, T + 1, dtype=torch.float32, device=hidden.device)[None, :, None]
    h, m = _masked(hidden, mask)
    return ((h * w).sum(1) / (m * w).sum(1).clamp_min(1e-9)).to(hidden.dtype)


def last_token_pool(hidden: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """State at the last unpadded position (index = sum(mask) - 1)."""
    idx = (mask.sum(1).to(torch.int64) - 1).clamp_min(0)
    return hidden[torch.arange(hidden.shape[0], device=hidden.device), idx]


def normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    x32 = x.float()
    n = torch.linalg.vector_norm(x32, dim=-1, keepdim=True)
    return (x32 / n.clamp_min(eps)).to(x.dtype)


POOLERS = {
    "mean": mean_pool,
    "weightedmean": weighted_mean_pool,
    "lasttoken": last_token_pool,
}
