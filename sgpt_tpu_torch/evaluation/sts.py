"""EmbeddingSimilarityEvaluator — STS dev-set eval during training.

The port's own copy of `sgpt_tpu/evaluation/sts.py`, with the same behaviour: the
port imports nothing of the JAX package.

Parity target: sentence_transformers/evaluation/EmbeddingSimilarityEvaluator.py:66-98
(pearson+spearman over cosine / euclidean / manhattan / dot; fit() selects
spearman-cosine as the score to maximize).
"""
from __future__ import annotations

import logging
from typing import List, Sequence

import numpy as np

from .metrics import pearson, spearman

logger = logging.getLogger(__name__)


class EmbeddingSimilarityEvaluator:
    def __init__(self, sentences1: Sequence[str], sentences2: Sequence[str],
                 scores: Sequence[float], main_similarity: str = "cosine",
                 name: str = ""):
        assert len(sentences1) == len(sentences2) == len(scores)
        self.s1, self.s2 = list(sentences1), list(sentences2)
        self.gold = list(scores)
        self.main = main_similarity
        self.name = name

    def compute(self, encode_fn) -> dict:
        """encode_fn(list[str]) -> (N, D). Returns all 8 correlation metrics."""
        e1 = np.asarray(encode_fn(self.s1), np.float64)
        e2 = np.asarray(encode_fn(self.s2), np.float64)

        n1 = e1 / np.clip(np.linalg.norm(e1, axis=1, keepdims=True), 1e-12, None)
        n2 = e2 / np.clip(np.linalg.norm(e2, axis=1, keepdims=True), 1e-12, None)
        cosine = np.sum(n1 * n2, axis=1).tolist()
        euclid = (-np.linalg.norm(e1 - e2, axis=1)).tolist()
        manhattan = (-np.abs(e1 - e2).sum(axis=1)).tolist()
        dot = np.sum(e1 * e2, axis=1).tolist()

        out = {}
        for key, pred in [("cosine", cosine), ("euclidean", euclid),
                          ("manhattan", manhattan), ("dot", dot)]:
            out[f"pearson_{key}"] = pearson(pred, self.gold)
            out[f"spearman_{key}"] = spearman(pred, self.gold)
        logger.info("STS%s: spearman_cosine=%.4f", f"[{self.name}]" if self.name else "",
                    out["spearman_cosine"])
        return out

    def __call__(self, encode_fn) -> float:
        return self.compute(encode_fn)[f"spearman_{self.main}"]
