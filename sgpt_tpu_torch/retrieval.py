"""DenseRetriever — exact dense search over a BEIR corpus (counterpart of `sgpt_tpu/retrieval.py`).

Encode the queries once, stream the corpus longest documents first in
chunks, score each chunk on the device with `blockmax_topk` (padded to
`device_chunk` so its slab scan tiles), and merge each chunk's top-k into a
running (Q, k) buffer on the host with a stable sort. k is top_k + 1, and a
query's own document (same id) is dropped, as in the reference.
"""
from __future__ import annotations

import logging
from typing import Dict

import numpy as np
import torch

from .ops.pooling import normalize
from .ops.topk import blockmax_topk

logger = logging.getLogger(__name__)


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _normalize_host(x: np.ndarray) -> np.ndarray:
    return normalize(torch.from_numpy(np.ascontiguousarray(x, np.float32))).numpy()


class DenseRetriever:
    """search(corpus, queries, top_k) → {qid: {docid: score}} (BEIR results shape)."""

    def __init__(self, model, *, score_function: str = "cos_sim",
                 corpus_chunk_size: int = 50000, device_chunk: int = 8192):
        """model: anything with encode_queries(list[str]) and
        encode_corpus(list[dict]). corpus_chunk_size: docs encoded per host
        round. device_chunk: max docs scored per matmul (rounded to a
        multiple of 128). Chunks are scored on the model's device
        (`model.device`; the CPU for a model without one)."""
        if score_function not in ("cos_sim", "dot"):
            raise ValueError("score_function must be 'cos_sim' or 'dot'")
        self.model = model
        self.score_function = score_function
        self.corpus_chunk_size = corpus_chunk_size
        self.device_chunk = _round_up(max(128, device_chunk), 128)
        self.device = torch.device(getattr(model, "device", "cpu"))

    def search(self, corpus: Dict[str, Dict[str, str]], queries: Dict[str, str],
               top_k: int, **kw) -> Dict[str, Dict[str, float]]:
        qids = list(queries.keys())
        q_emb = np.asarray(self.model.encode_queries([queries[q] for q in qids]), np.float32)
        if self.score_function == "cos_sim":
            q_emb = _normalize_host(q_emb)
        q_dev = torch.from_numpy(q_emb).to(self.device)

        # longest documents first: the worst padding batches together
        doc_ids = sorted(
            corpus, key=lambda d: len(corpus[d].get("title", "") + corpus[d].get("text", "")),
            reverse=True)

        Q = len(qids)
        k = min(top_k + 1, len(doc_ids))  # +1: a query's own document is dropped below
        run_vals = np.full((Q, k), -np.inf, np.float32)
        run_idx = np.zeros((Q, k), np.int64)

        for start in range(0, len(doc_ids), self.corpus_chunk_size):
            chunk_ids = doc_ids[start: start + self.corpus_chunk_size]
            logger.info("Encoding corpus chunk %d..%d / %d", start,
                        start + len(chunk_ids), len(doc_ids))
            c_emb = np.asarray(self.model.encode_corpus([corpus[d] for d in chunk_ids]),
                               np.float32)
            if self.score_function == "cos_sim":
                c_emb = _normalize_host(c_emb)

            n = c_emb.shape[0]
            # pad to a device_chunk multiple so the slab scan tiles
            n_pad = _round_up(n, min(self.device_chunk, _round_up(n, 128)))
            pad = np.zeros((n_pad, c_emb.shape[1]), np.float32)
            pad[:n] = c_emb
            vals, idx = blockmax_topk(q_dev, torch.from_numpy(pad).to(self.device), n,
                                      k=min(k, n_pad), block_size=128,
                                      slab_size=self.device_chunk)
            vals = vals.cpu().numpy()
            idx = idx.cpu().numpy().astype(np.int64) + start
            if vals.shape[1] < k:  # corpus chunk smaller than k
                fill = np.full((Q, k - vals.shape[1]), -np.inf, np.float32)
                vals = np.concatenate([vals, fill], axis=1)
                idx = np.concatenate([idx, np.zeros_like(idx[:, : k - idx.shape[1]])], axis=1)
            allv = np.concatenate([run_vals, vals], axis=1)
            alli = np.concatenate([run_idx, idx], axis=1)
            sel = np.argsort(-allv, axis=1, kind="stable")[:, :k]
            run_vals = np.take_along_axis(allv, sel, axis=1)
            run_idx = np.take_along_axis(alli, sel, axis=1)

        results: Dict[str, Dict[str, float]] = {}
        for qi, qid in enumerate(qids):
            hits = {}
            for v, di in zip(run_vals[qi], run_idx[qi]):
                if not np.isfinite(v):
                    continue
                doc_id = doc_ids[int(di)]
                if doc_id == qid:  # drop self-retrieval
                    continue
                hits[doc_id] = float(v)
            results[qid] = dict(list(hits.items())[:top_k])
        return results
