"""SPECB bracket-token batch encoding.

The port's own copy of `sgpt_tpu/tokenization/specb.py`, with the same behaviour: the
port imports nothing of the JAX package.

SGPT's asymmetric-search recipe marks queries with `[`…`]` and documents with
`{`…`}` at the *token id* level — brackets are inserted AFTER truncation, attended
to (mask 1), and 2 tokens of budget are reserved for them
(ref: biencoder/beir/beir_dense_retriever.py:100-104 consts, :134-136 budget,
:186-191 insertion; README.md:353-381 recipe).

Output arrays are padded to a static bucket length so every distinct shape jit-
compiles once (the TPU replacement for the reference's pad-to-longest,
beir_dense_retriever.py:201).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .base import Tokenizer


@dataclasses.dataclass
class BatchEncoding:
    input_ids: np.ndarray       # (B, T) int32
    attention_mask: np.ndarray  # (B, T) int32
    lengths: np.ndarray         # (B,) true lengths (incl. brackets)
    n_truncated: int = 0        # docs that lost tokens to the budget
    tokens_truncated: int = 0


# Length buckets: powers-of-two-ish ladder keeps compile count low while bounding
# padding waste (replaces the reference's sort-by-length + pad-to-longest).
DEFAULT_BUCKETS = (16, 32, 64, 128, 256, 300, 512, 1024, 2048)


def pick_bucket(max_len: int, buckets: Sequence[int], cap: int) -> int:
    for b in buckets:
        if b >= max_len and b <= cap:
            return b
    return cap


ROW_BUCKETS = (8, 16, 32, 64, 128, 256, 512)


def row_bucket(nmax: int, allow_overshoot: bool = True) -> int:
    """Static row-count bucket for token-budget batching (rows per dispatch
    scale inversely with the length bucket, keeping B·T ≈ constant).

    B is a pure function of the length bucket T (via nmax = budget // T), so
    the jit-compile count stays bounded by the number of T buckets; final
    partial batches pad rows and reuse the same compile. Rounds UP to the
    next bucket when that overshoots the budget by <= 25% (bounded memory),
    otherwise down. Callers pass allow_overshoot=False at the CAP length
    bucket: there a round-up would dispatch more activation memory than any
    batch the configured (batch_size, max_seq_len) ever implied — an OOM
    hazard for configs tuned near the HBM ceiling.

    In this package the encoder engine and the cross-encoder's packed path
    (`pack_t`) take it; the cross-encoder's unpacked rows no longer do: they
    run eagerly, with no compile count to bound, and their dispatches are
    planned around the rows (`crossencoder.plan_dispatches`)."""
    lo = None
    for b in ROW_BUCKETS:
        if b >= nmax:
            if b == nmax or (allow_overshoot and b <= nmax * 1.25):
                return b
            return lo or max(1, nmax)
        lo = b
    return ROW_BUCKETS[-1]


@dataclasses.dataclass
class SpecbCodec:
    """Tokenize + (optionally) bracket + pad a batch of texts."""

    tokenizer: Tokenizer
    max_seq_len: int = 2048
    specb: bool = False
    buckets: Sequence[int] = DEFAULT_BUCKETS
    # The reference applies newline→space cleanup only in its BEIR embed path
    # (beir_dense_retriever.py:170); training paths tokenize raw text —
    # trainers construct the codec with clean_newlines=False for parity
    clean_newlines: bool = True

    def __post_init__(self):
        if self.specb:
            self.bos_q = self.tokenizer.bracket_ids("[")
            self.eos_q = self.tokenizer.bracket_ids("]")
            self.bos_d = self.tokenizer.bracket_ids("{")
            self.eos_d = self.tokenizer.bracket_ids("}")

    @property
    def budget(self) -> int:
        """Worst-case body budget (the reference reserves a fixed 2,
        beir_dense_retriever.py:134-136 — correct only for single-token
        brackets; bracket_ids() may return multi-token brackets)."""
        if not self.specb:
            return self.max_seq_len
        worst = max(len(self.bos_q) + len(self.eos_q),
                    len(self.bos_d) + len(self.eos_d))
        return self.max_seq_len - worst

    def _budget_for(self, is_query: bool) -> int:
        if not self.specb:
            return self.max_seq_len
        bos, eos = (self.bos_q, self.eos_q) if is_query else                    (self.bos_d, self.eos_d)
        return self.max_seq_len - len(bos) - len(eos)

    def encode_rows(self, texts: Sequence[str], is_query: bool = False
                    ) -> Tuple[List[List[int]], int, int]:
        """Tokenize + bracket WITHOUT padding: (rows, n_trunc, toks_trunc).

        Split out so callers can batch pretokenized rows by token budget
        (encoder.py) without tokenizing twice."""
        budget = self._budget_for(is_query)
        # OpenAI-docs cleanup the reference applies in its embed path
        # (beir_dense_retriever.py:170): newlines become spaces
        if self.clean_newlines:
            texts = [t.replace("\n", " ") for t in texts]
        # one batched tokenizer call when available (HF fast tokenizers
        # parallelize across host cores in Rust; ids match per-text encode)
        enc_batch = getattr(self.tokenizer, "encode_batch", None)
        id_rows = (enc_batch(texts) if enc_batch is not None
                   else [self.tokenizer.encode(t) for t in texts])
        rows: List[List[int]] = []
        n_trunc = toks_trunc = 0
        for ids in id_rows:
            if len(ids) > budget:
                n_trunc += 1
                toks_trunc += len(ids) - budget
                ids = ids[:budget]
            if self.specb:
                if is_query:
                    ids = self.bos_q + ids + self.eos_q
                else:
                    ids = self.bos_d + ids + self.eos_d
            rows.append(ids)
        return rows, n_trunc, toks_trunc

    def encode(self, texts: Sequence[str], is_query: bool = False,
               pad_to: Optional[int] = None) -> BatchEncoding:
        rows, n_trunc, toks_trunc = self.encode_rows(texts, is_query)
        return self.pad_rows(rows, pad_to, n_trunc, toks_trunc)

    def pad_rows(self, rows: Sequence[List[int]], pad_to: Optional[int] = None,
                 n_trunc: int = 0, toks_trunc: int = 0) -> BatchEncoding:
        lengths = np.array([len(r) for r in rows], dtype=np.int32)
        max_len = max(1, int(lengths.max()) if len(lengths) else 1)
        T = pad_to if pad_to is not None else pick_bucket(max_len, self.buckets,
                                                          self.max_seq_len)
        T = max(T, max_len) if pad_to is None else T
        pad_id = self.tokenizer.pad_id

        input_ids = np.full((len(rows), T), pad_id, dtype=np.int32)
        mask = np.zeros((len(rows), T), dtype=np.int32)
        for i, r in enumerate(rows):
            if len(r) > T:
                # preserve the SPECB closing bracket under truncation: the
                # trailing ']' / '}' is the pooled EOS marker the recipe
                # depends on — cutting r[:T] blindly dropped it
                tail = []
                if self.specb:
                    for eos in (self.eos_q, self.eos_d):
                        if r[-len(eos):] == eos:
                            tail = eos
                            break
                r = r[: T - len(tail)] + tail
            input_ids[i, : len(r)] = r
            mask[i, : len(r)] = 1
        return BatchEncoding(input_ids, mask, np.minimum(lengths, T),
                             n_trunc, toks_trunc)


def encode_batch(tokenizer: Tokenizer, texts: Sequence[str], *, is_query: bool = False,
                 specb: bool = False, max_seq_len: int = 2048,
                 pad_to: Optional[int] = None) -> BatchEncoding:
    return SpecbCodec(tokenizer, max_seq_len, specb).encode(texts, is_query, pad_to)
