"""EmbeddingEngine — batched bulk encode (counterpart of `sgpt_tpu/encoder.py`).

Tokenize once (SPECB brackets), sort by token length, cut the sorted rows
into token-budget batches over static length buckets, run decoder forward +
pooling + optional L2 normalisation per batch, and un-sort into an (N, D)
float32 array in input order. Embeddings can be cached on disk under a key
that fingerprints the weights and the encode settings.

Not ported yet (ROADMAP Queue 1 item 5): dispatch chaining, the depth-2
fetch pipeline, meshes, quantisation, dense heads, learned pooling weights,
layer selection and the all-layer (stack) poolers. Passing any of them
raises `NotImplementedError`.
"""
from __future__ import annotations

import hashlib
import logging
import os
from typing import Optional, Sequence

import numpy as np
import torch

from .models.config import DecoderConfig
from .models.decoder import Decoder
from .ops.pooling import POOLERS, normalize
from .tokenization.base import Tokenizer
from .tokenization.specb import SpecbCodec, pick_bucket, row_bucket

logger = logging.getLogger(__name__)

_LATER = ("layeridx", "learned_weights", "dense_heads", "mesh", "sp_mesh",
          "fused_attention", "quantize", "text_prefix", "dispatch_chain")


class EmbeddingEngine:
    """Batched sentence embedding over the port's decoder (GPT-Neo, GPT-J, BLOOM)."""

    def __init__(self, model: Decoder, cfg: DecoderConfig, tokenizer: Tokenizer, *,
                 device="cuda", method: str = "weightedmean", specb: bool = False,
                 max_seq_len: Optional[int] = None, batch_size: int = 32,
                 normalize_embeddings: bool = False,
                 cache_dir: Optional[str] = None, **later):
        """device: where the model runs, the card by default; "cuda"
        without a card raises, and CPU use passes device="cpu".
        Every other argument has the JAX engine's meaning."""
        unknown = set(later) - set(_LATER)
        if unknown:
            raise TypeError(f"EmbeddingEngine: unexpected arguments {sorted(unknown)}")
        if later:
            raise NotImplementedError(
                f"EmbeddingEngine: {sorted(later)} not ported yet (ROADMAP Queue 1 item 5)")
        if method not in POOLERS:
            raise NotImplementedError(
                f"pooling method {method!r} not ported yet; ported: {sorted(POOLERS)} "
                "(ROADMAP Queue 1 item 4)")
        if model.cfg != cfg:
            raise ValueError("EmbeddingEngine: cfg differs from the model's config")
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("EmbeddingEngine: device 'cuda' requested but "
                               "torch.cuda.is_available() is False")
        self.device = device
        self.model = model.to(device).eval()
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.method = method
        self.batch_size = batch_size
        self.normalize = normalize_embeddings
        self.cache_dir = cache_dir
        self.out_dim = cfg.hidden_size
        max_seq_len = max_seq_len or cfg.max_position_embeddings
        self.codec = SpecbCodec(tokenizer, max_seq_len=max_seq_len, specb=specb)

    # ------------------------------------------------------------------
    def _embed(self, ids: np.ndarray, mask: np.ndarray) -> np.ndarray:
        """One batch: forward + pool + normalise on the device → (B, D) fp32 host array."""
        if ids.size and (ids.min() < 0 or ids.max() >= self.cfg.vocab_size):
            # on the card an out-of-range embedding index is a device assert
            # that poisons the context, not an error: refuse it on the host
            raise ValueError(
                f"token ids outside [0, {self.cfg.vocab_size}): min {ids.min()}, "
                f"max {ids.max()} — tokenizer and model vocab disagree")
        ids_t = torch.from_numpy(ids).to(self.device)
        mask_t = torch.from_numpy(mask).to(self.device)
        with torch.inference_mode():
            hidden = self.model(ids_t, mask_t)
            emb = POOLERS[self.method](hidden, mask_t)
            if self.normalize:
                emb = normalize(emb)
            return emb.float().cpu().numpy()

    def _rows_for_bucket(self, T: int) -> int:
        """Rows per batch for length bucket T (token-budget batching):
        budget = batch_size × max_seq_len tokens."""
        return row_bucket(max(1, (self.batch_size * self.codec.max_seq_len) // T),
                          allow_overshoot=T < self.codec.max_seq_len)

    def warmup(self, lengths: Optional[Sequence[int]] = None):
        """Run each (rows, bucket) shape once before traffic: builds the
        kernels and warms the matmul libraries' plans."""
        lengths = lengths or [b for b in self.codec.buckets
                              if b <= self.codec.max_seq_len]
        for T in lengths:
            B = self._rows_for_bucket(T)
            self._embed(np.zeros((B, T), np.int32), np.ones((B, T), np.int32))
        return self

    def encode(self, texts: Sequence[str], *, is_query: bool = False) -> np.ndarray:
        """Embed a list of texts → (N, D) float32 numpy array (input order)."""
        if len(texts) == 0:
            return np.zeros((0, self.out_dim), np.float32)
        cached = self._cache_load(texts, is_query)
        if cached is not None:
            return cached

        rows, n_trunc, toks_trunc = self.codec.encode_rows(texts, is_query=is_query)
        if n_trunc:
            logger.warning("Truncated %d/%d docs by %d tokens",
                           n_trunc, len(texts), toks_trunc)
        order = np.argsort([-len(r) for r in rows], kind="stable")
        out = np.zeros((len(texts), self.out_dim), np.float32)
        s = 0
        while s < len(order):
            T = pick_bucket(max(1, len(rows[order[s]])), self.codec.buckets,
                            self.codec.max_seq_len)
            T = max(T, len(rows[order[s]]))
            B = self._rows_for_bucket(T)
            sel = order[s: s + B]
            s += len(sel)
            enc = self.codec.pad_rows([rows[i] for i in sel], pad_to=T)
            ids, mask = enc.input_ids, enc.attention_mask
            if len(sel) < B:  # pad to the bucket's row count by tiling the last row
                pad = B - len(sel)
                ids = np.concatenate([ids, np.tile(ids[-1:], (pad, 1))])
                mask = np.concatenate([mask, np.tile(mask[-1:], (pad, 1))])
            out[sel] = self._embed(ids, mask)[: len(sel)]
        self._cache_store(texts, is_query, out)
        return out

    # ST-compat aliases (SentenceTransformer.encode / encode_queries / encode_corpus);
    # BEIR's retriever passes batch_size and other keywords, which are ignored
    def encode_queries(self, queries: Sequence[str], **kw) -> np.ndarray:
        return self.encode(list(queries), is_query=True)

    def encode_corpus(self, corpus, **kw) -> np.ndarray:
        texts = [
            (d.get("title", "") + " " + d["text"]).strip() if isinstance(d, dict) else d
            for d in corpus
        ]
        return self.encode(texts, is_query=False)

    # ------------------------------------------------------------------
    def _params_fingerprint(self) -> str:
        """Cheap identity for the weights (stale-cache guard): every leaf's
        name and shape plus its first 16 values."""
        if not hasattr(self, "_fp"):
            h = hashlib.sha1()
            for name, leaf in sorted(self.model.state_dict().items()):
                h.update(f"{name}{tuple(leaf.shape)}".encode())
                h.update(leaf.detach().reshape(-1)[:16].float().cpu().numpy().tobytes())
            self._fp = h.hexdigest()[:12]
        return self._fp

    def _cache_key(self, texts, is_query) -> Optional[str]:
        if not self.cache_dir:
            return None
        h = hashlib.sha1()
        h.update(f"torch|{self.method}|{self.codec.specb}|{is_query}|"
                 f"{self.normalize}|{self.codec.max_seq_len}|flash={self.cfg.use_flash}|"
                 f"{self._params_fingerprint()}|{len(texts)}".encode())
        for t in texts:  # full-text coverage: templated corpora sharing long
            h.update(str(len(t)).encode())  # prefixes must not collide
            h.update(t.encode())
        return os.path.join(self.cache_dir, h.hexdigest() + ".npy")

    def _cache_load(self, texts, is_query):
        key = self._cache_key(texts, is_query)
        if key and os.path.exists(key):
            logger.info("Loaded embeddings from cache %s", key)
            return np.load(key)
        return None

    def _cache_store(self, texts, is_query, emb):
        key = self._cache_key(texts, is_query)
        if key:
            os.makedirs(self.cache_dir, exist_ok=True)
            np.save(key, emb)
