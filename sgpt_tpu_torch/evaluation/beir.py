"""BEIR dataset IO + retrieval evaluation harness.

The port's own copy of `sgpt_tpu/evaluation/beir.py`, with the same behaviour: the
port imports nothing of the JAX package.

Replaces the external `beir` package the reference drives
(`GenericDataLoader(data_path).load(split)`, `EvaluateRetrieval(model, k_values)`
— biencoder/beir/beir_dense_retriever.py:390,440-446). Same on-disk format:
corpus.jsonl ({"_id","title","text"}), queries.jsonl ({"_id","text"}),
qrels/<split>.tsv (query-id\tcorpus-id\tscore with header).
"""
from __future__ import annotations

import csv
import json
import logging
import os
from typing import Dict, Iterable, Tuple

from .metrics import evaluate_retrieval, mrr_at_k, accuracy_at_k

logger = logging.getLogger(__name__)


def load_beir_dataset(data_path: str, split: str = "test"
                      ) -> Tuple[Dict, Dict, Dict]:
    """Returns (corpus, queries, qrels) in BEIR shapes; queries/corpus filtered
    to the split's qrels like the reference's cleaning step
    (beir_dense_retriever.py:392-401 drops empty docs/queries)."""
    # native one-pass field extraction when built (native/jsonl_fields.cpp,
    # ~5x the json.loads loop at BEIR corpus scale); None → python fallback
    from ..data.jsonl_native import extract_fields

    corpus: Dict[str, Dict[str, str]] = {}
    rows = extract_fields(os.path.join(data_path, "corpus.jsonl"),
                          ("_id", "title", "text"))
    if rows is not None:
        for doc_id, title, text in rows:
            if doc_id is None:  # same failure the json.loads path raises
                raise KeyError("_id")
            corpus[str(doc_id)] = {"title": title or "", "text": text or ""}
    else:
        with open(os.path.join(data_path, "corpus.jsonl")) as f:
            for line in f:
                row = json.loads(line)
                corpus[str(row["_id"])] = {"title": row.get("title", "") or "",
                                           "text": row.get("text", "") or ""}

    queries: Dict[str, str] = {}
    qrows = extract_fields(os.path.join(data_path, "queries.jsonl"),
                           ("_id", "text"))
    if qrows is not None:
        for qid, text in qrows:
            if qid is None:
                raise KeyError("_id")
            queries[str(qid)] = text or ""
    else:
        with open(os.path.join(data_path, "queries.jsonl")) as f:
            for line in f:
                row = json.loads(line)
                queries[str(row["_id"])] = row.get("text", "") or ""

    qrels: Dict[str, Dict[str, int]] = {}
    with open(os.path.join(data_path, "qrels", f"{split}.tsv")) as f:
        reader = csv.reader(f, delimiter="\t")
        header = next(reader)
        for row in reader:
            qid, did, score = str(row[0]), str(row[1]), int(row[2])
            qrels.setdefault(qid, {})[did] = score

    # keep only split queries; drop empties (reference cleaning)
    queries = {q: t for q, t in queries.items() if q in qrels and t.strip()}
    corpus = {d: v for d, v in corpus.items() if (v["title"] + v["text"]).strip()}
    logger.info("Loaded %d docs, %d queries, %d qrels from %s",
                len(corpus), len(queries), len(qrels), data_path)
    return corpus, queries, qrels


class EvaluateRetrieval:
    """API-compatible with beir.retrieval.evaluation.EvaluateRetrieval."""

    def __init__(self, retriever=None, k_values: Iterable[int] = (1, 3, 5, 10, 100, 1000)):
        self.retriever = retriever
        self.k_values = tuple(k_values)
        self.top_k = max(self.k_values)

    def retrieve(self, corpus, queries, **kw):
        return self.retriever.search(corpus, queries, top_k=self.top_k, **kw)

    @staticmethod
    def evaluate(qrels, results, k_values=(1, 3, 5, 10, 100, 1000)):
        # C++ engine when built (native/trec_eval.cpp); python math otherwise
        from .native import available, evaluate_retrieval_native
        if available():
            return evaluate_retrieval_native(qrels, results, k_values)
        return evaluate_retrieval(qrels, results, k_values)

    @staticmethod
    def evaluate_custom(qrels, results, k_values, metric: str):
        if metric.lower().startswith("mrr"):
            return {f"MRR@{k}": round(mrr_at_k(qrels, results, k), 5) for k in k_values}
        if metric.lower().startswith("acc") or metric.lower().startswith("hit"):
            return {f"Accuracy@{k}": round(accuracy_at_k(qrels, results, k), 5)
                    for k in k_values}
        raise ValueError(f"unknown custom metric {metric!r}")
