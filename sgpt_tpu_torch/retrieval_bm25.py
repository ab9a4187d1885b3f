"""Self-contained BM25 lexical retrieval (first-stage candidates).

The port's own copy of `sgpt_tpu/retrieval_bm25.py`, with the same behaviour:
the port imports nothing of the JAX package.

The reference gets BM25 results from Elasticsearch notebooks
(crossencoder/beir/crossencoder_beir_bm25.ipynb) and feeds them to the
cross-encoder reranker. This module removes the external-service dependency:
an in-memory inverted index with Okapi BM25 scoring (Lucene-default k1=1.2,
b=0.75, same shape of analyzer: lowercase alphanumeric terms), producing the
same `{qid: {docid: score}}` results dict the reranker consumes.
"""
from __future__ import annotations

import heapq
import math
import re
from collections import Counter, defaultdict
from typing import Dict, Iterable, List

_TOKEN = re.compile(r"[a-z0-9]+")


def tokenize(text: str) -> List[str]:
    return _TOKEN.findall(text.lower())


class BM25Index:
    def __init__(self, k1: float = 1.2, b: float = 0.75):
        self.k1 = k1
        self.b = b
        self.postings: Dict[str, List] = defaultdict(list)  # term -> [(doc_i, tf)]
        self.doc_ids: List[str] = []
        self.doc_len: List[int] = []
        self.avgdl = 0.0

    @classmethod
    def build(cls, corpus: Dict[str, Dict[str, str]], **kw) -> "BM25Index":
        """corpus: BEIR-shaped {docid: {title, text}}."""
        idx = cls(**kw)
        for did, doc in corpus.items():
            text = ((doc.get("title", "") + " " + doc.get("text", "")).strip()
                    if isinstance(doc, dict) else doc)
            terms = tokenize(text)
            i = len(idx.doc_ids)
            idx.doc_ids.append(did)
            idx.doc_len.append(len(terms))
            for term, tf in Counter(terms).items():
                idx.postings[term].append((i, tf))
        n = max(len(idx.doc_ids), 1)
        idx.avgdl = sum(idx.doc_len) / n
        return idx

    def _idf(self, term: str) -> float:
        df = len(self.postings.get(term, ()))
        if df == 0:
            return 0.0
        n = len(self.doc_ids)
        return math.log(1.0 + (n - df + 0.5) / (df + 0.5))  # Lucene BM25 idf

    def search_one(self, query: str, top_k: int = 100) -> Dict[str, float]:
        scores: Dict[int, float] = defaultdict(float)
        for term, qtf in Counter(tokenize(query)).items():
            idf = self._idf(term)
            if idf == 0.0:
                continue
            for doc_i, tf in self.postings[term]:
                dl = self.doc_len[doc_i]
                denom = tf + self.k1 * (1 - self.b + self.b * dl / self.avgdl)
                scores[doc_i] += idf * tf * (self.k1 + 1) / denom
        best = heapq.nlargest(top_k, scores.items(), key=lambda x: x[1])
        return {self.doc_ids[i]: s for i, s in best}

    def search(self, queries: Dict[str, str], top_k: int = 100
               ) -> Dict[str, Dict[str, float]]:
        return {qid: self.search_one(q, top_k) for qid, q in queries.items()}


class BM25Retriever:
    """EvaluateRetrieval-compatible wrapper: search(corpus, queries, top_k)."""

    def __init__(self, k1: float = 1.2, b: float = 0.75):
        self.k1, self.b = k1, b
        self._index: BM25Index | None = None

    def search(self, corpus, queries, top_k: int, **kw):
        self._index = BM25Index.build(corpus, k1=self.k1, b=self.b)
        return self._index.search(queries, top_k)
