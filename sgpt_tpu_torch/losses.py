"""Contrastive losses (counterpart of `sgpt_tpu/losses.py`).

MultipleNegativesRankingLoss, the SGPT training loss: cosine (or dot)
similarity of each anchor with every in-batch candidate, times the scale,
and cross-entropy with anchor i's label at candidate i. Ported here: MNRL.
The other losses of the JAX module and the sharded `mnrl_loss_dp` are still
to come (ROADMAP Queue 1 items 10 and 12).
"""
from __future__ import annotations

from typing import Optional

import torch

from .ops.similarity import cos_sim, dot_score


def _cross_entropy(scores: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(scores, dim=-1)
    return -logp.gather(1, labels[:, None]).mean()


def mnrl_loss(anchors: torch.Tensor, positives: torch.Tensor,
              negatives: Optional[torch.Tensor] = None, *,
              scale: float = 20.0, similarity: str = "cos_sim") -> torch.Tensor:
    """Anchor i must match candidate i among [positives; hard negatives]."""
    sim = cos_sim if similarity == "cos_sim" else dot_score
    candidates = positives if negatives is None else torch.cat([positives, negatives], 0)
    scores = sim(anchors, candidates) * scale
    labels = torch.arange(anchors.shape[0], device=anchors.device)
    return _cross_entropy(scores, labels)
