"""Training losses (counterpart of `sgpt_tpu/losses.py`).

MultipleNegativesRankingLoss, the SGPT training loss: cosine (or dot)
similarity of each anchor with every in-batch candidate, times the scale,
and cross-entropy with anchor i's label at candidate i. Beside it, the rest
of the JAX module's loss surface (the upstream sentence-transformers losses):
softmax (NLI head), triplet, contrastive and online contrastive, margin-MSE,
MSE, cosine similarity, symmetric MNRL, contrastive tension (plain and
in-batch), the batch-triplet family over a label-driven distance matrix and
MegaBatchMargin. Each follows the JAX function's arithmetic, masks included
(static-shape `where`s, not the upstream code's boolean indexing), so that
value and gradient match it. Every loss is a plain function of tensors.
`mnrl_loss_dp` is MNRL over a mesh's dp rows (per-row lists of tensors, the
single-controller form of the JAX shard_map loss), which the trainer's mesh
step runs.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from .ops.similarity import _norm, cos_sim, dot_score, pairwise_cos_sim
from .parallel.collectives import all_gather, all_reduce_sum


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


def mnrl_loss_dp(anchors: Sequence[torch.Tensor], positives: Sequence[torch.Tensor],
                 negatives: Optional[Sequence[torch.Tensor]] = None, *,
                 scale: float = 20.0, similarity: str = "cos_sim") -> List[torch.Tensor]:
    """MNRL over a mesh's dp axis (the JAX shard_map form): each argument is
    a list with one (n_local, D) block per dp row, on that row's device.
    Row r's anchors are scored against the positives (and hard negatives)
    of every row, gathered in row order on its device, with labels offset
    by r·n_local; the loss is the mean of the rows' losses, one copy per
    row on its device (the JAX `pmean`). Value and gradients equal
    `mnrl_loss` on the rows concatenated."""
    sim = cos_sim if similarity == "cos_sim" else dot_score
    candidates = all_gather(positives, dim=0)
    if negatives is not None:
        candidates = [torch.cat([p, n], 0)
                      for p, n in zip(candidates, all_gather(negatives, dim=0))]
    losses = []
    for r, (a, c) in enumerate(zip(anchors, candidates)):
        n_local = a.shape[0]
        labels = torch.arange(n_local, device=a.device) + r * n_local
        losses.append(_cross_entropy(sim(a, c) * scale, labels))
    return [t / len(losses) for t in all_reduce_sum(losses)]


def _euclidean(a, b):
    return torch.sqrt(((a - b) ** 2).sum(-1).clamp_min(1e-12))


def _cosine_distance(a, b):
    return 1.0 - (_norm(a) * _norm(b)).sum(-1)


def softmax_loss(u: torch.Tensor, v: torch.Tensor, classifier_w: torch.Tensor,
                 labels: torch.Tensor, classifier_b: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """SoftmaxLoss (NLI classification head): logits = [u; v; |u-v|] @ W,
    W of shape (3·D, num_labels)."""
    logits = torch.cat([u, v, (u - v).abs()], dim=-1) @ classifier_w
    if classifier_b is not None:
        logits = logits + classifier_b
    return _cross_entropy(logits, labels.long())


def triplet_loss(anchors, positives, negatives, *, margin: float = 5.0,
                 distance: str = "euclidean") -> torch.Tensor:
    dist = _euclidean if distance == "euclidean" else _cosine_distance
    return torch.relu(dist(anchors, positives) - dist(anchors, negatives) + margin).mean()


def contrastive_loss(u, v, labels, *, margin: float = 0.5,
                     distance: str = "cosine") -> torch.Tensor:
    """0.5 * (y * d^2 + (1-y) * relu(margin - d)^2)."""
    dist = _cosine_distance if distance == "cosine" else _euclidean
    d = dist(u, v)
    y = labels.float()
    return (0.5 * (y * d ** 2 + (1 - y) * torch.relu(margin - d) ** 2)).mean()


def online_contrastive_loss(u, v, labels, *, margin: float = 0.5,
                            distance: str = "cosine") -> torch.Tensor:
    """ContrastiveLoss over the hard pairs only: positives farther than the
    closest negative, negatives closer than the farthest positive. The sum,
    not the mean, as the reference returns it; a batch with a single
    positive (negative) takes the mean distance as the threshold, as the
    reference's `len(x) > 1` guards do."""
    dist = _cosine_distance if distance == "cosine" else _euclidean
    d = dist(u, v)
    y = labels.bool()
    zero = torch.zeros((), dtype=d.dtype, device=d.device)
    big = torch.full((), 1e9, dtype=d.dtype, device=d.device)
    n_pos, n_neg = y.sum(), (~y).sum()
    neg_min = torch.where(~y, d, big).amin()
    pos_max = torch.where(y, d, -big).amax()
    pos_mean = torch.where(y, d, zero).sum() / n_pos.clamp_min(1)
    neg_mean = torch.where(~y, d, zero).sum() / n_neg.clamp_min(1)
    pos_threshold = torch.where(n_neg > 1, neg_min, pos_mean)
    neg_threshold = torch.where(n_pos > 1, pos_max, neg_mean)
    hard_pos = y & (d > pos_threshold)
    hard_neg = ~y & (d < neg_threshold)
    pos_term = torch.where(hard_pos, d ** 2, zero)
    neg_term = torch.where(hard_neg, torch.relu(margin - d) ** 2, zero)
    return pos_term.sum() + neg_term.sum()


def margin_mse_loss(queries, positives, negatives, gold_margins) -> torch.Tensor:
    """MarginMSE (distillation): MSE between dot-score margins and teacher margins."""
    pred = (queries * positives).sum(-1) - (queries * negatives).sum(-1)
    return ((pred - gold_margins) ** 2).mean()


def mse_loss(student: torch.Tensor, teacher: torch.Tensor) -> torch.Tensor:
    return ((student - teacher) ** 2).mean()


def cosine_similarity_loss(u, v, labels) -> torch.Tensor:
    """MSE between cosine similarity and gold score (STS regression training)."""
    pred = (_norm(u) * _norm(v)).sum(-1)
    return ((pred - labels.float()) ** 2).mean()


def mnrl_symmetric_loss(anchors: torch.Tensor, positives: torch.Tensor,
                        negatives: Optional[torch.Tensor] = None, *,
                        scale: float = 20.0, similarity: str = "cos_sim") -> torch.Tensor:
    """MultipleNegativesSymmetricRankingLoss: the MNRL loss plus the reverse
    direction (given a positive, find its anchor among all anchors) over the
    anchor-positive block only; hard negatives join the forward term alone."""
    sim = cos_sim if similarity == "cos_sim" else dot_score
    candidates = positives if negatives is None else torch.cat([positives, negatives], 0)
    scores = sim(anchors, candidates) * scale
    labels = torch.arange(anchors.shape[0], device=anchors.device)
    forward_loss = _cross_entropy(scores, labels)
    backward_loss = _cross_entropy(scores[:, : positives.shape[0]].T, labels)
    return (forward_loss + backward_loss) / 2


def contrastive_tension_loss(reps1: torch.Tensor, reps2: torch.Tensor,
                             labels: torch.Tensor) -> torch.Tensor:
    """ContrastiveTensionLoss: BCE with logits, summed, on raw dot products
    of two independent towers; label 1 marks the identical-sentence pair, 0
    the sampled negatives."""
    logits = (reps1 * reps2).sum(-1).float()
    y = labels.float()
    per = torch.relu(logits) - logits * y + torch.log1p(torch.exp(-logits.abs()))
    return per.sum()


def contrastive_tension_in_batch_negatives_loss(
        reps1: torch.Tensor, reps2: torch.Tensor, *, logit_scale: torch.Tensor
) -> torch.Tensor:
    """ContrastiveTensionLossInBatchNegatives: symmetric in-batch CE with a
    trainable temperature (`logit_scale`, init log(20); exp() applied here)."""
    scores = cos_sim(reps1, reps2) * torch.exp(logit_scale)
    labels = torch.arange(scores.shape[0], device=scores.device)
    return (_cross_entropy(scores, labels) + _cross_entropy(scores.T, labels)) / 2


# ---------------------------------------------------------------------------
# Batch-triplet family (labels-driven triplet mining within a batch).
# ---------------------------------------------------------------------------

def pairwise_distances(embeddings: torch.Tensor, *, metric: str = "euclidean",
                       squared: bool = False) -> torch.Tensor:
    """(B, B) distance matrix. Euclidean: negatives clamped to 0, and the
    exact zeros (the diagonal) guarded before the square root, whose
    gradient would be infinite there (NaN after the chain rule); cosine:
    1 - cos_sim."""
    if metric == "cosine":
        return 1.0 - cos_sim(embeddings, embeddings)
    dot = embeddings @ embeddings.T
    sq = torch.diagonal(dot)
    d2 = (sq[:, None] - 2.0 * dot + sq[None, :]).clamp_min(0.0)
    if squared:
        return d2
    zero = d2 == 0.0
    d = torch.sqrt(d2 + torch.where(zero, 1e-16, 0.0))
    return torch.where(zero, torch.zeros((), dtype=d.dtype, device=d.device), d)


def _eye(n: int, device) -> torch.Tensor:
    return torch.eye(n, dtype=torch.bool, device=device)


def _positive_mask(labels):
    same = labels[:, None] == labels[None, :]
    return same & ~_eye(labels.shape[0], labels.device)


def _negative_mask(labels):
    return labels[:, None] != labels[None, :]


def _hardest_pos_neg(labels, embeddings, metric):
    d = pairwise_distances(embeddings, metric=metric)
    pos = _positive_mask(labels)
    neg = _negative_mask(labels)
    hardest_pos = torch.where(pos, d, torch.zeros_like(d)).amax(1)
    # invalid negatives get the row max added so that the min skips them
    row_max = d.amax(1, keepdim=True)
    hardest_neg = torch.where(neg, d, d + row_max).amin(1)
    return hardest_pos, hardest_neg


def batch_hard_triplet_loss(labels: torch.Tensor, embeddings: torch.Tensor, *,
                            margin: float = 5.0, metric: str = "euclidean") -> torch.Tensor:
    """relu(hardest_positive - hardest_negative + margin), batch mean."""
    hp, hn = _hardest_pos_neg(labels, embeddings, metric)
    return torch.relu(hp - hn + margin).mean()


def batch_hard_soft_margin_triplet_loss(labels: torch.Tensor, embeddings: torch.Tensor, *,
                                        metric: str = "euclidean") -> torch.Tensor:
    """Soft-margin variant: log1p(exp(hardest_pos - hardest_neg))."""
    hp, hn = _hardest_pos_neg(labels, embeddings, metric)
    return torch.log1p(torch.exp(hp - hn)).mean()


def batch_all_triplet_loss(labels: torch.Tensor, embeddings: torch.Tensor, *,
                           margin: float = 5.0, metric: str = "euclidean") -> torch.Tensor:
    """Mean over the valid triplets (a, p, n) with a positive loss: a != p,
    label(a) == label(p), label(a) != label(n)."""
    d = pairwise_distances(embeddings, metric=metric)
    tl = d[:, :, None] - d[:, None, :] + margin            # (a, p, n)
    same = labels[:, None] == labels[None, :]
    valid = ((same & ~_eye(labels.shape[0], labels.device))[:, :, None]
             & (~same)[:, None, :])
    tl = torch.where(valid, torch.relu(tl), torch.zeros_like(tl))
    num_positive = (tl > 1e-16).sum()
    return tl.sum() / (num_positive + 1e-16)


def batch_semi_hard_triplet_loss(labels: torch.Tensor, embeddings: torch.Tensor, *,
                                 margin: float = 5.0, metric: str = "euclidean") -> torch.Tensor:
    """Semi-hard mining (the TF recipe): for each (a, p) the closest negative
    farther than d(a, p) if one exists, else the farthest negative (an
    anchor with no negative at all takes its row minimum); mean hinge over
    the positive pairs."""
    d = pairwise_distances(embeddings, metric=metric)
    neg = _negative_mask(labels)                                     # (a, n)
    # [a, p, n]: n is a negative of a and d(a, n) > d(a, p)
    outside_mask = neg[:, None, :] & (d[:, None, :] > d[:, :, None])
    big = d.amax()
    negatives_outside = torch.where(outside_mask, d[:, None, :], big + 1.0).amin(2)
    has_outside = outside_mask.any(2)
    has_neg = neg.any(1)
    negatives_inside = torch.where(
        has_neg, torch.where(neg, d, torch.full_like(d, float("-inf"))).amax(1), d.amin(1))
    semi_hard = torch.where(has_outside, negatives_outside, negatives_inside[:, None])
    loss_mat = d - semi_hard + margin
    pos = _positive_mask(labels)
    return torch.where(pos, torch.relu(loss_mat), torch.zeros_like(loss_mat)).sum() / pos.sum()


def megabatch_margin_loss(anchors, positives, *, positive_margin: float = 0.8,
                          negative_margin: float = 0.3) -> torch.Tensor:
    """MegaBatchMarginLoss (ParaNMT): each anchor's hardest in-batch negative
    is the most similar other positive, chosen without a gradient; loss =
    relu(pos_margin − cos(a, p)) + relu(cos(a, hardest_neg) − neg_margin)."""
    n = anchors.shape[0]
    with torch.no_grad():
        scores = cos_sim(anchors, positives)
        hard_ids = (scores - 2.0 * torch.eye(n, dtype=scores.dtype,
                                             device=scores.device)).argmax(1)
    pos_cos = pairwise_cos_sim(anchors, positives)
    neg_cos = pairwise_cos_sim(anchors, positives[hard_ids])
    return (torch.relu(positive_margin - pos_cos) + torch.relu(neg_cos - negative_margin)).mean()
