"""OpenAI embeddings baseline retriever.

Re-build of the reference's API comparison path
(biencoder/beir/beir_openai_embeddings_batched_parallel.py:71-391): embed a BEIR
corpus through an embeddings API with batching, thread-parallel fan-out, retry
and per-chunk caching, then run the same exact search as the local models.

Zero-egress friendly: the API client is INJECTED as `embed_fn(list[str],
is_query) -> list[vector]` — pass a real OpenAI client wrapper in production,
a fake in tests. The openai package itself is never imported here.

The port's own copy of `sgpt_tpu/baselines/openai_embeddings.py`, on the
port's `utils.parallelizer`, with the same behaviour: the port imports
nothing of the JAX package.
"""
from __future__ import annotations

import logging
import os
import pickle
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from ..utils.parallelizer import DataFrameParallelizer, retry

logger = logging.getLogger(__name__)


class OpenAIRetriever:
    """encode_queries/encode_corpus driven by an external embeddings API."""

    def __init__(self, embed_fn: Callable[[Sequence[str], bool], Sequence],
                 *, batch_size: int = 128, parallel_workers: int = 4,
                 cache_dir: Optional[str] = None, retries: int = 3,
                 max_chars: int = 10000):
        self.embed_fn = retry(tries=retries)(embed_fn)
        self.batch_size = batch_size
        self.workers = parallel_workers
        self.cache_dir = cache_dir
        self.max_chars = max_chars

    def _embed_all(self, texts: List[str], is_query: bool, tag: str) -> np.ndarray:
        cache = (os.path.join(self.cache_dir, f"{tag}_{len(texts)}.pkl")
                 if self.cache_dir else None)
        if cache and os.path.exists(cache):
            with open(cache, "rb") as f:
                return pickle.load(f)

        # API hygiene from the reference: strip newlines, truncate, never empty
        clean = [(t.replace("\n", " ")[: self.max_chars] or " ") for t in texts]
        rows = [{"i": i, "text": t} for i, t in enumerate(clean)]

        def call(batch):
            return self.embed_fn([r["text"] for r in batch], is_query)

        runner = DataFrameParallelizer(call, batch_support=True,
                                       batch_size=self.batch_size,
                                       parallel_workers=self.workers,
                                       output_column_prefix="emb")
        out_rows = runner.run(rows)
        out_rows.sort(key=lambda r: r["i"])
        failed = [r["i"] for r in out_rows if r["emb_response"] is None]
        if failed:
            raise RuntimeError(f"{len(failed)} embedding rows failed: {failed[:5]}")
        emb = np.asarray([r["emb_response"] for r in out_rows], np.float32)

        if cache:
            os.makedirs(self.cache_dir, exist_ok=True)
            with open(cache, "wb") as f:
                pickle.dump(emb, f)
        return emb

    def encode_queries(self, queries: Sequence[str], **kw) -> np.ndarray:
        return self._embed_all(list(queries), True, "queries")

    def encode_corpus(self, corpus, **kw) -> np.ndarray:
        texts = [
            (d.get("title", "") + " " + d["text"]).strip() if isinstance(d, dict) else d
            for d in corpus
        ]
        return self._embed_all(texts, False, "corpus")
