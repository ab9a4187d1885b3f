"""Bridge to the native jsonl field extractor (native/jsonl_core.h).

The port's own copy of `sgpt_tpu/data/jsonl_native.py`, with the same behaviour: the
port imports nothing of the JAX package.

The data-loader hot path: BEIR corpora reach 10M+ rows and a generic
`json.loads` per row materializes every key only to keep two or three. The
C++ engine scans each row once, unescapes only the requested fields, and
structurally skips the rest (measured vs the json.loads loop in
tools/bench_jsonl.py; numbers in docs/PERF.md).

Two backends, picked automatically:
  1. `_jsonl_native` CPython extension (native/jsonl_pymod.cpp) — the fast
     path: result strings are materialized in C and the GIL is released
     during IO + parse.
  2. ctypes over libjsonl_fields.so (native/jsonl_fields.cpp) — fallback
     when the Python headers weren't available to build the extension;
     Python-side slicing makes it slower but still correct.

Fail-safe by construction: ANY malformed row makes the native parse report
an error, and `extract_fields` returns None — callers fall back to the
json.loads loop, so the native path can never produce silently-different
contents (the same never-silently-wrong rule as tokenization/base.py).
Compiles on first use (g++ via native/Makefile, into the port's own build
directory: native_build.py), same lifecycle as evaluation/native.py.
"""
from __future__ import annotations

import ctypes
import importlib.util
import logging
import os
from typing import List, Optional, Sequence, Tuple

from ..native_build import build

logger = logging.getLogger(__name__)

_BACKEND = None          # "pymod" | "ctypes" | None
_PYMOD = None
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


class _JResult(ctypes.Structure):
    _fields_ = [
        ("nrows", ctypes.c_int64),
        ("nfields", ctypes.c_int32),
        ("bytes", ctypes.POINTER(ctypes.c_char)),
        ("nbytes", ctypes.c_int64),
        ("offs", ctypes.POINTER(ctypes.c_int64)),
        ("lens", ctypes.POINTER(ctypes.c_int64)),
        ("err_line", ctypes.c_int64),
    ]


def _load():
    global _BACKEND, _PYMOD, _LIB, _TRIED
    if _TRIED:
        return _BACKEND
    _TRIED = True
    try:  # preferred: the CPython extension
        so = build("_jsonl_native.so")
        spec = importlib.util.spec_from_file_location("_jsonl_native", so)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _PYMOD = mod
        _BACKEND = "pymod"
        return _BACKEND
    except Exception as e:
        logger.info("jsonl CPython extension unavailable (%s); trying ctypes", e)
    try:  # fallback: ctypes over the C ABI
        _ensure_ctypes()
        _BACKEND = "ctypes"
    except Exception as e:  # no toolchain → json.loads fallback
        logger.warning("native jsonl extractor unavailable (%s); "
                       "using json.loads fallback", e)
        _BACKEND = None
    return _BACKEND


def _ensure_ctypes() -> ctypes.CDLL:
    """Load (building if needed) the C-ABI library; also used directly by
    tests so BOTH backends stay covered even where the pymod wins."""
    global _LIB
    if _LIB is not None:
        return _LIB
    so = build("libjsonl_fields.so")
    lib = ctypes.CDLL(so)
    lib.jsonl_extract.argtypes = [ctypes.c_char_p,
                                  ctypes.POINTER(ctypes.c_char_p),
                                  ctypes.c_int32]
    lib.jsonl_extract.restype = ctypes.POINTER(_JResult)
    lib.jsonl_result_free.argtypes = [ctypes.POINTER(_JResult)]
    lib.jsonl_result_free.restype = None
    _LIB = lib
    return lib


def available() -> bool:
    return _load() is not None


def backend() -> Optional[str]:
    """'pymod' | 'ctypes' | None (for tests/diagnostics)."""
    return _load()


def extract_fields(path: str, fields: Sequence[str]
                   ) -> Optional[List[Tuple[Optional[str], ...]]]:
    """Per-row tuples of the requested top-level fields (None = missing).

    Strings come back unescaped; numbers/bools as their raw token text
    (matching str(json.loads(...)) for the id-as-number case); JSON null and
    structured values as None. Returns None when the native engine is
    unavailable OR the file fails strict parsing — the caller must fall back
    to the json.loads loop.
    """
    which = _load()
    if which is None:
        return None
    if which == "pymod":
        out = _PYMOD.extract_fields(os.fspath(path), tuple(fields))
        if out is None and os.path.exists(path):
            logger.warning("native jsonl parse of %s failed; falling back "
                           "to json.loads", path)
        return out
    return _extract_ctypes(path, fields)


def _extract_ctypes(path: str, fields: Sequence[str]
                    ) -> Optional[List[Tuple[Optional[str], ...]]]:
    lib = _ensure_ctypes()
    n = len(fields)
    c_fields = (ctypes.c_char_p * n)(*[f.encode() for f in fields])
    res = lib.jsonl_extract(os.fspath(path).encode(), c_fields, n)
    try:
        r = res.contents
        if r.err_line != 0:
            if r.err_line > 0:
                logger.warning(
                    "native jsonl parse of %s failed at line %d; falling back "
                    "to json.loads", path, r.err_line)
            return None
        buf = ctypes.string_at(r.bytes, r.nbytes)  # one copy of the arena
        import numpy as np
        spans = np.ctypeslib.as_array(r.offs, shape=(r.nrows * n,)).tolist()
        lens = np.ctypeslib.as_array(r.lens, shape=(r.nrows * n,)).tolist()
        out: List[Tuple[Optional[str], ...]] = []
        for i in range(r.nrows):
            base = i * n
            out.append(tuple(
                buf[spans[base + j]:spans[base + j] + lens[base + j]].decode()
                if lens[base + j] >= 0 else None
                for j in range(n)))
        return out
    finally:
        _LIB.jsonl_result_free(res)
