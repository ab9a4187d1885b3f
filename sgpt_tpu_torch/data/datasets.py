"""Remaining dataset utilities from the ST fork's `datasets/` (SURVEY.md §2b).

The port's own copy of `sgpt_tpu/data/datasets.py`, with the same behaviour: the
port imports nothing of the JAX package.

SentenceLabelBatcher  — label-grouped batches (triplet-style sampling),
                        sentence_transformers/datasets/SentenceLabelDataset.py
ParallelSentencesData — (source, translation) pairs + teacher embeddings for
                        multilingual distillation (ParallelSentencesDataset.py)
denoise_text          — deletion noise for TSDAE-style denoising training
                        (DenoisingAutoEncoderDataset.py)
"""
from __future__ import annotations

import random
from collections import defaultdict
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

from .batching import InputExample


class SentenceLabelBatcher:
    """Batches with `samples_per_label` examples of each sampled label —
    feeds triplet/contrastive losses that build pairs inside the batch."""

    def __init__(self, examples: Sequence[InputExample], batch_size: int,
                 samples_per_label: int = 2, seed: int = 0,
                 with_replacement: bool = False):
        assert batch_size % samples_per_label == 0
        self.batch_size = batch_size
        self.spl = samples_per_label
        self.rng = random.Random(seed)
        self.with_replacement = with_replacement
        self.groups: Dict[float, List[InputExample]] = defaultdict(list)
        for ex in examples:
            self.groups[ex.label].append(ex)
        # only labels with enough examples participate (ST behavior)
        self.labels = [l for l, g in self.groups.items() if len(g) >= self.spl]
        self.n_usable = sum(len(self.groups[l]) for l in self.labels)

    def __len__(self) -> int:
        return self.n_usable // self.batch_size

    def __iter__(self) -> Iterator[List[InputExample]]:
        labels_per_batch = self.batch_size // self.spl
        for _ in range(len(self)):
            batch: List[InputExample] = []
            chosen = self.rng.sample(self.labels,
                                     min(labels_per_batch, len(self.labels)))
            for label in chosen:
                group = self.groups[label]
                if self.with_replacement:
                    batch.extend(self.rng.choices(group, k=self.spl))
                else:
                    batch.extend(self.rng.sample(group, self.spl))
            yield batch


class ParallelSentencesData:
    """(source, target) sentence pairs with teacher embeddings of the source —
    the multilingual-distillation feed (student mimics teacher via mse_loss)."""

    def __init__(self, teacher_encode: Callable[[List[str]], "object"],
                 batch_size: int = 32):
        self.teacher_encode = teacher_encode
        self.batch_size = batch_size
        self.pairs: List[Tuple[str, str]] = []

    def add_dataset(self, rows: Sequence[Sequence[str]],
                    max_sentences: Optional[int] = None):
        """rows: each a [source, translation1, translation2, ...] sequence."""
        added = 0
        for row in rows:
            src = row[0]
            for tgt in row[1:] if len(row) > 1 else [row[0]]:
                self.pairs.append((src, tgt))
                added += 1
                if max_sentences and added >= max_sentences:
                    return

    def batches(self) -> Iterator[Tuple[List[str], "object"]]:
        """Yields (student_texts, teacher_embeddings) ready for mse_loss."""
        for s in range(0, len(self.pairs) - self.batch_size + 1, self.batch_size):
            chunk = self.pairs[s : s + self.batch_size]
            sources = [p[0] for p in chunk]
            targets = [p[1] for p in chunk]
            yield targets, self.teacher_encode(sources)


def contrastive_tension_batches(sentences: Sequence[str], batch_size: int,
                                pos_neg_ratio: int = 8, seed: int = 0
                                ) -> Iterator[List[InputExample]]:
    """ContrastiveTension batch stream (losses/ContrastiveTensionLoss.py:
    ContrastiveTensionDataLoader:73-108): every pos_neg_ratio-th example is an
    identical pair (label 1); the rest pair consecutive distinct sentences
    (label 0). batch_size must divide by pos_neg_ratio."""
    if batch_size % pos_neg_ratio:
        raise ValueError(
            f"batch_size {batch_size} must be divisible by pos_neg_ratio "
            f"{pos_neg_ratio}")
    sents = list(sentences)
    random.Random(seed).shuffle(sents)
    i = 0
    batch: List[InputExample] = []
    while i + 1 < len(sents):
        s1 = sents[i]
        if len(batch) % pos_neg_ratio > 0:
            i += 1
            s2, label = sents[i], 0.0
        else:
            s2, label = s1, 1.0
        i += 1
        batch.append(InputExample(texts=(s1, s2), label=label))
        if len(batch) >= batch_size:
            yield batch
            batch = []


class DenoisingBatcher:
    """(noisy, original) sentence-pair batches for TSDAE
    (datasets/DenoisingAutoEncoderDataset.py equivalent: noise applied on the
    fly each epoch, deterministic per (seed, epoch))."""

    def __init__(self, sentences: Sequence[str], batch_size: int, *,
                 del_ratio: float = 0.6, seed: int = 0):
        self.sentences = list(sentences)
        self.batch_size = batch_size
        self.del_ratio = del_ratio
        self.seed = seed
        self.epoch = 0

    def __len__(self) -> int:
        return len(self.sentences) // self.batch_size

    def __iter__(self) -> Iterator[List[InputExample]]:
        rng = random.Random(f"{self.seed}:{self.epoch}")
        self.epoch += 1
        order = list(self.sentences)
        rng.shuffle(order)
        for s in range(0, len(order) - self.batch_size + 1, self.batch_size):
            yield [InputExample(texts=(denoise_text(t, self.del_ratio, rng), t))
                   for t in order[s : s + self.batch_size]]


def denoise_text(text: str, del_ratio: float = 0.6,
                 rng: Optional[random.Random] = None) -> str:
    """TSDAE deletion noise: DELETE each token with prob del_ratio (keep with
    prob 1−del_ratio, the reference's `rand > del_ratio` keep rule); min 1 kept."""
    rng = rng or random
    words = text.split()
    if not words:
        return text
    kept = [w for w in words if rng.random() > del_ratio]
    if not kept:
        kept = [rng.choice(words)]
    return " ".join(kept)
