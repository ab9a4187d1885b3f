"""AllNLI triplet construction for symmetric-search training.

The port's own copy of `sgpt_tpu/data/nli.py`, with the same behaviour: the
port imports nothing of the JAX package.

Parity target: training_nli_v2.py:140-161 — group premises, attach entailment
hypotheses as positives and contradiction hypotheses as (hard) negatives, emit
(anchor, positive, negative) triplets.
File format: TSV with columns split,sentence1,sentence2,label (AllNLI.tsv.gz
layout) or any iterable of (premise, hypothesis, label) rows.
"""
from __future__ import annotations

import csv
import gzip
import random
from collections import defaultdict
from typing import Iterable, List, Tuple

from .batching import InputExample


def load_nli_tsv(path: str, split: str = "train") -> Iterable[Tuple[str, str, str]]:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        reader = csv.DictReader(f, delimiter="\t", quoting=csv.QUOTE_NONE)
        for row in reader:
            if row.get("split", split) != split:
                continue
            yield row["sentence1"], row["sentence2"], row["label"]


def build_nli_triplets(rows: Iterable[Tuple[str, str, str]],
                       seed: int = 0) -> List[InputExample]:
    """(premise, hypothesis, label) rows → (anchor, entail, contradict) triplets."""
    groups: dict = defaultdict(lambda: {"entailment": set(), "contradiction": set()})
    for s1, s2, label in rows:
        if label in ("entailment", "contradiction"):
            groups[s1][label].add(s2)

    rng = random.Random(seed)
    triplets: List[InputExample] = []
    for anchor, sides in groups.items():
        ent, con = sorted(sides["entailment"]), sorted(sides["contradiction"])
        if not ent or not con:
            continue
        for pos in ent:
            triplets.append(InputExample(texts=(anchor, pos, rng.choice(con))))
    rng.shuffle(triplets)
    return triplets
