"""InformationRetrievalEvaluator — IR dev-set eval during training.

The port's own copy of `sgpt_tpu/evaluation/ir.py`, with the same behaviour: the
port imports nothing of the JAX package.

Parity target: sentence_transformers/evaluation/InformationRetrievalEvaluator.py:23-231
(accuracy@k, precision/recall@k, MRR@k, nDCG@k, MAP@k over a chunked corpus;
the MSMARCO training entry evaluates dev retrieval with it,
examples/training/ms_marco/train_bi-encoder_mnrl.py:520-527).
"""
from __future__ import annotations

import logging
from typing import Dict, Sequence

import numpy as np

from .metrics import (accuracy_at_k, map_at_k, mrr_at_k, ndcg_at_k,
                      precision_at_k, recall_at_k)

logger = logging.getLogger(__name__)


class InformationRetrievalEvaluator:
    def __init__(self, queries: Dict[str, str], corpus: Dict[str, str],
                 relevant_docs: Dict[str, set], *,
                 mrr_at: Sequence[int] = (10,), ndcg_at: Sequence[int] = (10,),
                 accuracy_at: Sequence[int] = (1, 3, 5, 10),
                 precision_recall_at: Sequence[int] = (1, 3, 5, 10),
                 map_at: Sequence[int] = (100,),
                 main_metric: str = "map@100", name: str = "",
                 corpus_chunk_size: int = 50000):
        self.qids = [q for q in queries if q in relevant_docs and relevant_docs[q]]
        self.queries = queries
        self.corpus = corpus
        self.relevant = relevant_docs
        self.mrr_at, self.ndcg_at = mrr_at, ndcg_at
        self.accuracy_at, self.pr_at, self.map_at = accuracy_at, precision_recall_at, map_at
        self.main_metric = main_metric
        self.name = name
        self.corpus_chunk_size = corpus_chunk_size
        produced = ({f"accuracy@{k}" for k in accuracy_at}
                    | {f"precision@{k}" for k in precision_recall_at}
                    | {f"recall@{k}" for k in precision_recall_at}
                    | {f"mrr@{k}" for k in mrr_at}
                    | {f"ndcg@{k}" for k in ndcg_at}
                    | {f"map@{k}" for k in map_at})
        if main_metric not in produced:
            # fail BEFORE the expensive encode, not at the final logging line
            raise ValueError(f"main_metric {main_metric!r} is not produced by "
                             f"the configured k values ({sorted(produced)})")

    def compute(self, encode_query_fn, encode_corpus_fn=None) -> dict:
        encode_corpus_fn = encode_corpus_fn or encode_query_fn
        doc_ids = list(self.corpus)
        q_emb = np.asarray(encode_query_fn([self.queries[q] for q in self.qids]))
        qn = q_emb / np.clip(np.linalg.norm(q_emb, axis=1, keepdims=True), 1e-12, None)

        max_k = max([*self.mrr_at, *self.ndcg_at, *self.accuracy_at,
                     *self.pr_at, *self.map_at])
        Q = len(self.qids)
        # Chunked corpus pass with a running top-k per query, like the parity
        # target (InformationRetrievalEvaluator.py corpus_chunk_size=50000):
        # the full (Q, D) score matrix for an MSMARCO-scale dev corpus is
        # ~14 GB and was materialized whole (review finding). argpartition
        # bounds per-chunk sort cost to O(C + k log k) per query.
        results = {qid: {} for qid in self.qids}
        for start in range(0, len(doc_ids), self.corpus_chunk_size):
            chunk_ids = doc_ids[start : start + self.corpus_chunk_size]
            d_emb = np.asarray(encode_corpus_fn(
                [self.corpus[d] for d in chunk_ids]))
            dn = d_emb / np.clip(np.linalg.norm(d_emb, axis=1, keepdims=True),
                                 1e-12, None)
            scores = qn @ dn.T                      # (Q, C)
            kk = min(max_k, scores.shape[1])
            # candidate selection and pruning both use the trec tie-break
            # (score desc, doc id desc) so results — and therefore every
            # metric — are independent of corpus_chunk_size even when scores
            # tie at the top-k boundary (argpartition picked ties arbitrarily)
            order_desc = np.argsort(np.asarray(chunk_ids))[::-1]
            id_rank = np.empty(len(chunk_ids), np.int64)
            id_rank[order_desc] = np.arange(len(chunk_ids))
            for i, qid in enumerate(self.qids):
                r = results[qid]
                sel = np.lexsort((id_rank, -scores[i]))[:kk]
                for j in sel:
                    r[chunk_ids[j]] = float(scores[i, j])
                if len(r) > max_k:
                    by_id = sorted(r.items(), key=lambda x: x[0], reverse=True)
                    keep = sorted(by_id, key=lambda x: -x[1])[:max_k]
                    results[qid] = dict(keep)
        qrels = {q: {d: 1 for d in self.relevant[q]} for q in self.qids}

        out = {}
        for k in self.accuracy_at:
            out[f"accuracy@{k}"] = accuracy_at_k(qrels, results, k)
        for k in self.pr_at:
            out[f"precision@{k}"] = precision_at_k(qrels, results, k)
            out[f"recall@{k}"] = recall_at_k(qrels, results, k)
        for k in self.mrr_at:
            out[f"mrr@{k}"] = mrr_at_k(qrels, results, k)
        for k in self.ndcg_at:
            out[f"ndcg@{k}"] = ndcg_at_k(qrels, results, k)
        for k in self.map_at:
            # ST parity: InformationRetrievalEvaluator divides AP by
            # min(k, n_rel), not trec_eval's total-relevant count
            out[f"map@{k}"] = map_at_k(qrels, results, k, divide_by="min_k_rel")
        logger.info("IR%s: %s=%.4f", f"[{self.name}]" if self.name else "",
                    self.main_metric, out[self.main_metric])
        return out

    def __call__(self, encode_query_fn, encode_corpus_fn=None) -> float:
        return self.compute(encode_query_fn, encode_corpus_fn)[self.main_metric]
