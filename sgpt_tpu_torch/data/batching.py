"""Batch formation utilities.

The port's own copy of `sgpt_tpu/data/batching.py`, with the same behaviour: the
port imports nothing of the JAX package.

`NoDuplicatesBatcher` re-implements the ST fork's NoDuplicatesDataLoader
(sentence_transformers/datasets/NoDuplicatesDataLoader.py:4-40): build each
batch so no text appears twice — duplicate texts inside a batch would be false
negatives for the in-batch-negatives MNRL loss. The NLI training entry uses it
(training_nli_v2.py:168).
"""
from __future__ import annotations

import dataclasses
import logging
import random
from typing import Iterator, List, Optional, Sequence, Tuple

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class InputExample:
    """(texts, label) container (ref: sentence_transformers/readers/InputExample.py)."""
    texts: Tuple[str, ...]
    label: float = 0.0
    guid: str = ""


class NoDuplicatesBatcher:
    """Yields batches of examples with batch-unique texts, cycling the pool."""

    def __init__(self, examples: Sequence[InputExample], batch_size: int,
                 seed: int = 0):
        self.examples = list(examples)
        self.batch_size = batch_size
        self.rng = random.Random(seed)
        self.rng.shuffle(self.examples)
        self.pointer = 0

    def __len__(self) -> int:
        return len(self.examples) // self.batch_size

    def __iter__(self) -> Iterator[List[InputExample]]:
        for _ in range(len(self)):
            batch: List[InputExample] = []
            texts_in_batch = set()
            scanned = 0
            while len(batch) < self.batch_size and scanned < len(self.examples):
                ex = self.examples[self.pointer]
                self.pointer = (self.pointer + 1) % len(self.examples)
                if self.pointer == 0:
                    self.rng.shuffle(self.examples)
                scanned += 1
                lowered = [t.strip().lower() for t in ex.texts]
                if any(t in texts_in_batch for t in lowered):
                    continue
                texts_in_batch.update(lowered)
                batch.append(ex)
            if len(batch) < self.batch_size:
                # the reference's NoDuplicatesDataLoader keeps scanning until
                # the batch fills (looping forever on degenerate data); we
                # bound the scan but surface the underfill — a small batch
                # quietly weakens the in-batch-negatives loss
                logger.warning(
                    "NoDuplicatesBatcher: only %d/%d unique-text examples "
                    "found in a full scan — duplicate-heavy data weakens "
                    "in-batch negatives", len(batch), self.batch_size)
            yield batch
