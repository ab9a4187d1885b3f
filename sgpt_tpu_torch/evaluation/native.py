"""ctypes bridge to the native metrics engine (native/trec_eval.cpp).

The port's own copy of `sgpt_tpu/evaluation/native.py`, with the same behaviour: the
port imports nothing of the JAX package.

Compiles on first use (g++ via native/Makefile, into the port's own build
directory: native_build.py) and falls back to the pure-Python metrics if
unavailable. `evaluate_retrieval_native` mirrors metrics.evaluate_retrieval's
output; `available()` gates usage.

Scores cross the C ABI as float64 (round-2 fix of the r1 float32 tie-break
caveat): the native ranking is bit-identical to the Python path's, including
sub-float32 score differences.
"""
from __future__ import annotations

import ctypes
import logging
from typing import Dict, Iterable, Optional, Tuple

import numpy as np

from ..native_build import build

logger = logging.getLogger(__name__)

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    try:
        # keyed by a hash of the sources: a stale .so is worse than none, as
        # an ABI change (e.g. the r2 float32→float64 scores) would silently
        # misread every buffer
        lib = ctypes.CDLL(build("libtrec_eval.so"))
        lib.evaluate_queries.argtypes = [
            ctypes.c_int32,
            np.ctypeslib.ndpointer(np.int64), np.ctypeslib.ndpointer(np.float64),
            np.ctypeslib.ndpointer(np.int32), np.ctypeslib.ndpointer(np.int32),
            np.ctypeslib.ndpointer(np.int64), np.ctypeslib.ndpointer(np.int32),
            np.ctypeslib.ndpointer(np.int32), ctypes.c_int32,
            np.ctypeslib.ndpointer(np.float64),
        ]
        lib.evaluate_queries.restype = None
        _LIB = lib
    except Exception as e:  # no toolchain / compile failure → python fallback
        logger.warning("native metrics unavailable (%s); using python fallback", e)
        _LIB = None
    return _LIB


def available() -> bool:
    return _load() is not None


def evaluate_retrieval_native(qrels, results,
                              k_values: Iterable[int] = (1, 3, 5, 10, 100, 1000)
                              ) -> Tuple[Dict, Dict, Dict, Dict]:
    """Drop-in for metrics.evaluate_retrieval via the C++ engine."""
    lib = _load()
    if lib is None:
        from .metrics import evaluate_retrieval
        return evaluate_retrieval(qrels, results, k_values)

    ks = np.asarray(sorted(k_values), np.int32)
    qids = [q for q, rel in qrels.items() if any(g > 0 for g in rel.values())]

    offsets = [0]
    ideal_offsets = [0]
    scores_l, grades_l, ideal_l, nrel_l = [], [], [], []
    for q in qids:
        rel = qrels[q]
        run = results.get(q, {})
        # doc-id-DESCENDING pre-sort + the engine's stable score sort gives
        # trec_eval's tie-break (equal scores order by descending doc id)
        docs = sorted(run, reverse=True)
        scores_l.extend(run[d] for d in docs)
        grades_l.extend(rel.get(d, 0) for d in docs)
        offsets.append(offsets[-1] + len(docs))
        pos = sorted((g for g in rel.values() if g > 0), reverse=True)
        ideal_l.extend(pos)
        ideal_offsets.append(ideal_offsets[-1] + len(pos))
        nrel_l.append(len(pos))

    out = np.zeros((len(qids), len(ks), 6), np.float64)
    if qids:
        lib.evaluate_queries(
            np.int32(len(qids)),
            np.asarray(offsets, np.int64),
            np.asarray(scores_l, np.float64),
            np.asarray(grades_l, np.int32),
            np.asarray(nrel_l, np.int32),
            np.asarray(ideal_offsets, np.int64),
            np.asarray(ideal_l, np.int32),
            ks, np.int32(len(ks)),
            out.reshape(-1),
        )

    mean = out.mean(axis=0) if len(qids) else np.zeros((len(ks), 6))
    ndcg = {f"NDCG@{k}": round(float(mean[i, 0]), 5) for i, k in enumerate(ks)}
    _map = {f"MAP@{k}": round(float(mean[i, 1]), 5) for i, k in enumerate(ks)}
    recall = {f"Recall@{k}": round(float(mean[i, 2]), 5) for i, k in enumerate(ks)}
    precision = {f"P@{k}": round(float(mean[i, 3]), 5) for i, k in enumerate(ks)}
    return ndcg, _map, recall, precision
