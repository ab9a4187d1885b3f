"""File readers producing InputExamples (ST `readers/` surface: NLI/STS/Triplet).

The port's own copy of `sgpt_tpu/data/readers.py`, with the same behaviour: the
port imports nothing of the JAX package.
"""
from __future__ import annotations

import csv
import gzip
import os
from typing import List, Optional

from .batching import InputExample

NLI_LABELS = {"contradiction": 0, "entailment": 1, "neutral": 2}


def _open(path: str):
    return gzip.open(path, "rt") if path.endswith(".gz") else open(path)


class STSDataReader:
    """score-labeled sentence pairs, score normalized to [0, 1] (STSbenchmark)."""

    def __init__(self, dataset_folder: str = "", s1_col: str = "sentence1",
                 s2_col: str = "sentence2", score_col: str = "score",
                 min_score: float = 0.0, max_score: float = 5.0):
        self.folder = dataset_folder
        self.cols = (s1_col, s2_col, score_col)
        self.min_score, self.max_score = min_score, max_score

    def get_examples(self, filename: str, max_examples: int = 0,
                     split: Optional[str] = None) -> List[InputExample]:
        out = []
        with _open(os.path.join(self.folder, filename)) as f:
            for row in csv.DictReader(f, delimiter="\t", quoting=csv.QUOTE_NONE):
                if split and row.get("split") != split:
                    continue
                score = ((float(row[self.cols[2]]) - self.min_score)
                         / (self.max_score - self.min_score))
                out.append(InputExample(
                    texts=(row[self.cols[0]], row[self.cols[1]]), label=score))
                if max_examples and len(out) >= max_examples:
                    break
        return out


class NLIDataReader:
    """(premise, hypothesis) pairs with integer NLI labels."""

    def __init__(self, dataset_folder: str = ""):
        self.folder = dataset_folder

    def get_examples(self, filename: str, max_examples: int = 0,
                     split: Optional[str] = None) -> List[InputExample]:
        out = []
        with _open(os.path.join(self.folder, filename)) as f:
            for row in csv.DictReader(f, delimiter="\t", quoting=csv.QUOTE_NONE):
                if split and row.get("split") != split:
                    continue
                if row["label"] not in NLI_LABELS:
                    continue
                out.append(InputExample(
                    texts=(row["sentence1"], row["sentence2"]),
                    label=NLI_LABELS[row["label"]]))
                if max_examples and len(out) >= max_examples:
                    break
        return out


class TripletReader:
    """(anchor, positive, negative) columns, no labels."""

    def __init__(self, dataset_folder: str = "", delimiter: str = "\t",
                 has_header: bool = False):
        self.folder = dataset_folder
        self.delimiter = delimiter
        self.has_header = has_header

    def get_examples(self, filename: str, max_examples: int = 0) -> List[InputExample]:
        out = []
        with _open(os.path.join(self.folder, filename)) as f:
            reader = csv.reader(f, delimiter=self.delimiter)
            if self.has_header:
                next(reader, None)
            for row in reader:
                if len(row) < 3:
                    continue
                out.append(InputExample(texts=(row[0], row[1], row[2])))
                if max_examples and len(out) >= max_examples:
                    break
        return out
