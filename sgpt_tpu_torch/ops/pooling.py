"""Pooling: hidden states (B, T, D) + attention mask (B, T) → sentence embedding (B, D).

Counterpart of `sgpt_tpu/ops/pooling.py`, every method of it:

  mean, weightedmean, lasttoken, max, cls   one layer's states (B, T, D)
  meanmean, lasttokenmean                   the stack of all layers (L+1, B, T, D)
  learned_weightedmean, tokenweightedmean,  with a trained weight vector
  weightedlayer

The dtype flow is the JAX one: accumulate in fp32, cast to the hidden
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


def learned_weighted_mean_pool(hidden: torch.Tensor, mask: torch.Tensor,
                               position_weights: torch.Tensor) -> torch.Tensor:
    """Learnt per-position weights: the first T of `position_weights`."""
    T = hidden.shape[1]
    w = position_weights[:T].float()[None, :, None]
    h, m = _masked(hidden, mask)
    return ((h * w).sum(1) / (m * w).sum(1).clamp_min(1e-9)).to(hidden.dtype)


def _last_index(mask: torch.Tensor) -> torch.Tensor:
    return (mask.sum(1).to(torch.int64) - 1).clamp_min(0)


def last_token_pool(hidden: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """State at the last unpadded position (index = sum(mask) - 1)."""
    return hidden[torch.arange(hidden.shape[0], device=hidden.device), _last_index(mask)]


def mean_mean_pool(all_hidden: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean over layers AND tokens of stacked hidden states (L, B, T, D)."""
    L = all_hidden.shape[0]
    m = mask.float()[None, :, :, None]
    s = (all_hidden.float() * m).sum((0, 2))
    denom = (L * mask.float().sum(1)[:, None]).clamp_min(1e-9)
    return (s / denom).to(all_hidden.dtype)


def last_token_mean_pool(all_hidden: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Last-token state averaged over all layers (stacked (L, B, T, D) input)."""
    g = all_hidden[:, torch.arange(all_hidden.shape[1], device=all_hidden.device),
                   _last_index(mask)]
    return g.float().mean(0).to(all_hidden.dtype)


def token_weighted_mean_pool(hidden: torch.Tensor, mask: torch.Tensor,
                             token_weights: torch.Tensor) -> torch.Tensor:
    """Mean pool with per-token weights (B, T), e.g. idf values looked up per
    input id (ST's WordWeights)."""
    w = token_weights.float()[..., None]
    h, m = _masked(hidden, mask)
    return ((h * w * m).sum(1) / (m * w).sum(1).clamp_min(1e-9)).to(hidden.dtype)


def weighted_layer_pool(all_hidden: torch.Tensor, mask: torch.Tensor,
                        layer_weights: torch.Tensor, layer_start: int = 0) -> torch.Tensor:
    """Weighted average over layers (weights normalised to sum 1, no
    softmax), then the masked token mean. all_hidden: (L, B, T, D);
    layer_weights: (L - layer_start,)."""
    stack = all_hidden[layer_start:].float()
    w = layer_weights.float()
    w = w / w.sum().clamp_min(1e-9)
    mixed = torch.einsum("l,lbtd->btd", w, stack)
    return mean_pool(mixed, mask).to(all_hidden.dtype)


def max_pool(hidden: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked max over tokens; padded positions hold -1e9 in the hidden dtype."""
    neg = torch.tensor(-1e9, dtype=hidden.dtype, device=hidden.device)
    return torch.where(mask[..., None].bool(), hidden, neg).amax(1)


def cls_pool(hidden: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """First-token state."""
    del mask
    return hidden[:, 0]


def normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    x32 = x.float()
    n = torch.linalg.vector_norm(x32, dim=-1, keepdim=True)
    return (x32 / n.clamp_min(eps)).to(x.dtype)


# methods over the final (or layeridx-selected) hidden state
POOLERS = {
    "mean": mean_pool,
    "weightedmean": weighted_mean_pool,
    "lasttoken": last_token_pool,
    "max": max_pool,
    "cls": cls_pool,
}

# methods over the full hidden-state stack (L+1, B, T, D)
STACK_POOLERS = {
    "meanmean": mean_mean_pool,
    "lasttokenmean": last_token_mean_pool,
}


def pool(method: str, hidden_or_stack: torch.Tensor, mask: torch.Tensor, **kw) -> torch.Tensor:
    if method in POOLERS:
        return POOLERS[method](hidden_or_stack, mask, **kw)
    if method in STACK_POOLERS:
        return STACK_POOLERS[method](hidden_or_stack, mask, **kw)
    if method == "learned_weightedmean":
        return learned_weighted_mean_pool(hidden_or_stack, mask, **kw)
    raise ValueError(f"unknown pooling method {method!r}")
