"""Retrieval & similarity metrics (clean-room implementations, TREC semantics).

The port's own copy of `sgpt_tpu/evaluation/metrics.py`, with the same behaviour: the
port imports nothing of the JAX package.

Replaces the external `pytrec_eval`/`beir.EvaluateRetrieval.evaluate` the
reference leans on (SURVEY.md §2a): nDCG@k, MAP@k, Recall@k, Precision@k with
trec_eval conventions (binary-or-graded qrels, log2 discount, ideal-DCG
normalization, per-query average over queries that have relevant docs), plus
MRR@k, accuracy@k (hit rate) and the STS Spearman/Pearson evaluators
(sentence_transformers/evaluation/EmbeddingSimilarityEvaluator.py:66-98).
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, List, Mapping, Sequence, Tuple

Qrels = Mapping[str, Mapping[str, int]]
Results = Mapping[str, Mapping[str, float]]


def _ranked_docs(scores: Mapping[str, float], k: int) -> List[str]:
    # trec_eval/pytrec_eval order equal scores by DESCENDING doc id; two-pass
    # stable sort (id desc, then score desc) since strings don't negate
    by_id_desc = sorted(scores.items(), key=lambda x: x[0], reverse=True)
    return [d for d, _ in sorted(by_id_desc, key=lambda x: -x[1])[:k]]


def dcg(gains: Sequence[float]) -> float:
    return sum(g / math.log2(i + 2) for i, g in enumerate(gains))


def ndcg_at_k(qrels: Qrels, results: Results, k: int) -> float:
    """trec_eval ndcg_cut.k: graded gains (negative judgments clamp to 0 gain,
    keeping parity with the native engine), log2 discount from rank 1."""
    vals = []
    for qid, rel in qrels.items():
        pos = {d: g for d, g in rel.items() if g > 0}
        if not pos:
            continue
        ranked = _ranked_docs(results.get(qid, {}), k)
        got = dcg([max(rel.get(d, 0), 0) for d in ranked])
        ideal = dcg(sorted(pos.values(), reverse=True)[:k])
        vals.append(got / ideal if ideal > 0 else 0.0)
    return sum(vals) / max(len(vals), 1)


def map_at_k(qrels: Qrels, results: Results, k: int, *,
             divide_by: str = "num_rel") -> float:
    """Mean average precision at cutoff k (binary relevance: grade > 0).

    divide_by='num_rel' — trec_eval map_cut semantics: the precision sum over
    the top-k is divided by the TOTAL number of relevant docs (BEIR/trec path).
    divide_by='min_k_rel' — ST's InformationRetrievalEvaluator semantics
    (divide by min(k, n_rel), InformationRetrievalEvaluator.py:204-218)."""
    vals = []
    for qid, rel in qrels.items():
        pos = {d for d, g in rel.items() if g > 0}
        if not pos:
            continue
        ranked = _ranked_docs(results.get(qid, {}), k)
        hits, ap = 0, 0.0
        for i, d in enumerate(ranked):
            if d in pos:
                hits += 1
                ap += hits / (i + 1)
        denom = min(k, len(pos)) if divide_by == "min_k_rel" else len(pos)
        vals.append(ap / denom)
    return sum(vals) / max(len(vals), 1)


def recall_at_k(qrels: Qrels, results: Results, k: int) -> float:
    vals = []
    for qid, rel in qrels.items():
        pos = {d for d, g in rel.items() if g > 0}
        if not pos:
            continue
        ranked = set(_ranked_docs(results.get(qid, {}), k))
        vals.append(len(ranked & pos) / len(pos))
    return sum(vals) / max(len(vals), 1)


def precision_at_k(qrels: Qrels, results: Results, k: int) -> float:
    vals = []
    for qid, rel in qrels.items():
        pos = {d for d, g in rel.items() if g > 0}
        if not pos:
            continue
        ranked = _ranked_docs(results.get(qid, {}), k)
        vals.append(len(set(ranked) & pos) / k)
    return sum(vals) / max(len(vals), 1)


def mrr_at_k(qrels: Qrels, results: Results, k: int) -> float:
    vals = []
    for qid, rel in qrels.items():
        pos = {d for d, g in rel.items() if g > 0}
        if not pos:
            continue
        ranked = _ranked_docs(results.get(qid, {}), k)
        rr = 0.0
        for i, d in enumerate(ranked):
            if d in pos:
                rr = 1.0 / (i + 1)
                break
        vals.append(rr)
    return sum(vals) / max(len(vals), 1)


def accuracy_at_k(qrels: Qrels, results: Results, k: int) -> float:
    """Hit rate: 1 if any relevant doc in top-k."""
    vals = []
    for qid, rel in qrels.items():
        pos = {d for d, g in rel.items() if g > 0}
        if not pos:
            continue
        ranked = _ranked_docs(results.get(qid, {}), k)
        vals.append(1.0 if set(ranked) & pos else 0.0)
    return sum(vals) / max(len(vals), 1)


def evaluate_retrieval(qrels: Qrels, results: Results,
                       k_values: Iterable[int] = (1, 3, 5, 10, 100, 1000)
                       ) -> Tuple[Dict, Dict, Dict, Dict]:
    """BEIR-shaped output: (ndcg, map, recall, precision) dicts keyed 'NDCG@k' etc."""
    ndcg = {f"NDCG@{k}": round(ndcg_at_k(qrels, results, k), 5) for k in k_values}
    _map = {f"MAP@{k}": round(map_at_k(qrels, results, k), 5) for k in k_values}
    recall = {f"Recall@{k}": round(recall_at_k(qrels, results, k), 5) for k in k_values}
    precision = {f"P@{k}": round(precision_at_k(qrels, results, k), 5) for k in k_values}
    return ndcg, _map, recall, precision


# ---------------------------------------------------------------------------
# Correlation metrics for STS (EmbeddingSimilarityEvaluator parity)
# ---------------------------------------------------------------------------

def pearson(x: Sequence[float], y: Sequence[float]) -> float:
    n = len(x)
    mx = sum(x) / n
    my = sum(y) / n
    num = sum((a - mx) * (b - my) for a, b in zip(x, y))
    den = math.sqrt(sum((a - mx) ** 2 for a in x) * sum((b - my) ** 2 for b in y))
    return num / den if den else 0.0


def _ranks(x: Sequence[float]) -> List[float]:
    order = sorted(range(len(x)), key=lambda i: x[i])
    ranks = [0.0] * len(x)
    i = 0
    while i < len(order):
        j = i
        while j + 1 < len(order) and x[order[j + 1]] == x[order[i]]:
            j += 1
        avg = (i + j) / 2 + 1
        for t in range(i, j + 1):
            ranks[order[t]] = avg
        i = j + 1
    return ranks


def spearman(x: Sequence[float], y: Sequence[float]) -> float:
    return pearson(_ranks(x), _ranks(y))
