"""MS MARCO hard-negative triplet stream for asymmetric-search training.

The port's own copy of `sgpt_tpu/data/msmarco.py`, with the same behaviour: the
port imports nothing of the JAX package.

Parity targets from examples/training/ms_marco/train_bi-encoder_mnrl.py:
  * CE-score margin filter on mined negatives: keep neg if
    ce(neg) < ce(strongest positive) - margin (:282-329, margin=3.0)
  * per-query pop/rotate of positives and shuffled negatives so epochs cycle
    through different pairs (MSMARCODataset.__getitem__, :336-367)
"""
from __future__ import annotations

import random
from typing import Dict, List, Optional, Sequence, Tuple

from .batching import InputExample

DEFAULT_CE_MARGIN = 3.0


def filter_hard_negatives(
    negs_with_scores: Sequence[Tuple[str, float]],
    positive_scores: Sequence[float],
    ce_margin: float = DEFAULT_CE_MARGIN,
    max_negs: Optional[int] = None,
) -> List[str]:
    """Keep a negative only if its CE score <= min(positive CE scores) - margin
    (train_bi-encoder_mnrl.py:296-316)."""
    if not positive_scores:
        return []
    threshold = min(positive_scores) - ce_margin
    out = [doc for doc, s in negs_with_scores if s <= threshold]
    return out[:max_negs] if max_negs else out


class MSMARCOTriplets:
    """query → rotating (positive, hard-negative) pairs."""

    def __init__(self, queries: Dict[str, str], corpus: Dict[str, str],
                 qrels: Dict[str, Dict[str, List[str]]], seed: int = 0):
        """qrels[qid] = {'pos': [docids], 'neg': [docids]}."""
        self.queries = queries
        self.corpus = corpus
        self.state = {}
        rng = random.Random(seed)
        for qid, sides in qrels.items():
            pos, neg = list(sides["pos"]), list(sides["neg"])
            if not pos or not neg:
                continue
            rng.shuffle(neg)
            self.state[qid] = {"pos": pos, "neg": neg}
        self.qids = sorted(self.state)
        rng.shuffle(self.qids)

    def __len__(self) -> int:
        return len(self.qids)

    def example(self, qid: str) -> InputExample:
        """Pop the head positive/negative and rotate them to the tail (:352-364)."""
        st = self.state[qid]
        pos = st["pos"].pop(0); st["pos"].append(pos)
        neg = st["neg"].pop(0); st["neg"].append(neg)
        return InputExample(texts=(self.queries[qid], self.corpus[pos],
                                   self.corpus[neg]))

    def epoch(self) -> List[InputExample]:
        return [self.example(q) for q in self.qids]
