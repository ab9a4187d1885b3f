"""EmbeddingEngine — batched bulk encode (counterpart of `sgpt_tpu/encoder.py`).

Tokenize once (SPECB brackets, an optional text prefix), sort by token
length, cut the sorted rows into token-budget batches over static length
buckets, and run per batch: decoder forward → [pre-pool dense heads] →
pooling → [post-pool dense heads] → optional L2 normalisation; un-sort into
an (N, D) float32 array in input order. The pooling runs over the final
hidden states, over the states of one layer (`layeridx`, the reference's
layer sweeps) or over the stack of all layers (`meanmean`,
`lasttokenmean`); `weightedmean` with `learned_weights` pools with the
trained position weights. Embeddings can be cached on disk under a key that
fingerprints the weights, the heads and the encode settings.

Not ported yet (ROADMAP Queue 1 items 5, 9, 11 and 12): dispatch chaining,
the depth-2 fetch pipeline, meshes and int8 quantisation. Passing any of
them raises `NotImplementedError`.
"""
from __future__ import annotations

import hashlib
import logging
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .models.config import DecoderConfig
from .models.decoder import Decoder
from .models.precision import matmul_precision
from .ops.pooling import POOLERS, STACK_POOLERS, normalize, pool
from .tokenization.base import Tokenizer
from .tokenization.specb import SpecbCodec, pick_bucket, row_bucket

logger = logging.getLogger(__name__)

_LATER = ("mesh", "sp_mesh", "fused_attention", "quantize", "dispatch_chain")

# the dense heads' activations (the JAX engine's `_ACTIVATIONS`: GELU is
# jax.nn.gelu's tanh approximation)
ACTIVATIONS = {
    "identity": lambda x: x,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "tanh": torch.tanh,
}


def apply_heads(x: torch.Tensor, heads: Sequence[dict]) -> torch.Tensor:
    """Linear heads in order: x @ w [+ b] → activation, each in x's dtype.
    A head is {"w": (in, out), ["b": (out,)], "activation": name}: `w` in
    the JAX package's (in, out) layout, not `nn.Linear`'s (out, in)."""
    for h in heads:
        x = x @ h["w"].to(x.dtype)
        if h.get("b") is not None:
            x = x + h["b"].to(x.dtype)
        x = ACTIVATIONS[h.get("activation", "identity")](x)
    return x


def pool_single(hidden: torch.Tensor, mask: torch.Tensor, method: str,
                learned_weights: Optional[torch.Tensor]) -> torch.Tensor:
    """One layer's states → (B, D): the learnt position weights for
    `learned_weightedmean`, and for `weightedmean` when they are given."""
    if method == "learned_weightedmean" or (learned_weights is not None
                                            and method == "weightedmean"):
        return pool("learned_weightedmean", hidden, mask, position_weights=learned_weights)
    return pool(method, hidden, mask)


class EmbeddingEngine:
    """Batched sentence embedding over the port's decoder (GPT-Neo, GPT-J, BLOOM)."""

    def __init__(self, model: Decoder, cfg: DecoderConfig, tokenizer: Tokenizer, *,
                 device="cuda", method: str = "weightedmean", specb: bool = False,
                 layeridx: int = -1, max_seq_len: Optional[int] = None,
                 batch_size: int = 32, normalize_embeddings: bool = False,
                 learned_weights=None, dense_heads: Optional[list] = None,
                 cache_dir: Optional[str] = None, text_prefix: str = "", **later):
        """device: where the model runs, the card by default; "cuda"
        without a card raises, and CPU use passes device="cpu".
        Every other argument has the JAX engine's meaning:

        layeridx: the layer whose states are pooled (-1 or L: the final
        states after ln_f; 0 the embeddings). Any other value, and a stack
        pooler, runs the forward with `output_hidden_states` (every layer
        still runs).
        learned_weights: trained position weights (at least max_seq_len of
        them), used by `learned_weightedmean` and by `weightedmean`.
        dense_heads: list of {"w": (in, out), ["b"], "activation",
        "location": "pre_pool" | "post_pool"}, applied in list order within
        each location: pre-pool heads to every token's state, post-pool
        heads to the sentence embedding.
        text_prefix: prepended to every text before tokenization."""
        unknown = set(later) - set(_LATER)
        if unknown:
            raise TypeError(f"EmbeddingEngine: unexpected arguments {sorted(unknown)}")
        if later:
            raise NotImplementedError(
                f"EmbeddingEngine: {sorted(later)} not ported yet (ROADMAP Queue 1 "
                "items 5, 9, 11, 12)")
        if method not in POOLERS and method not in STACK_POOLERS \
                and method != "learned_weightedmean":
            raise ValueError(f"unknown pooling method {method!r}")
        if method == "learned_weightedmean" and learned_weights is None:
            raise ValueError("learned_weightedmean needs learned_weights")
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
        self.layeridx = layeridx
        self.batch_size = batch_size
        self.normalize = normalize_embeddings
        self.cache_dir = cache_dir
        self.text_prefix = text_prefix
        self.learned_weights = (None if learned_weights is None else
                                torch.as_tensor(learned_weights).to(device))
        self.heads = {"pre_pool": [], "post_pool": []}
        for h in dense_heads or []:
            loc = h.get("location", "post_pool")
            if loc not in self.heads:
                raise ValueError(f"dense head location {loc!r}: expected pre_pool or post_pool")
            act = h.get("activation", "identity")
            if act not in ACTIVATIONS:
                raise ValueError(f"dense head activation {act!r}: one of {sorted(ACTIVATIONS)}")
            self.heads[loc].append({
                "w": torch.as_tensor(h["w"]).to(device), "activation": act,
                "b": None if h.get("b") is None else torch.as_tensor(h["b"]).to(device)})
        if self.heads["pre_pool"] and method in STACK_POOLERS:
            raise ValueError(
                f"pre_pool dense heads are not applied by stack poolers ({method!r} pools "
                "the all-layer stack directly); use a post_pool head or a single-layer "
                "pooling method")
        # the width follows application order (pre heads → pool → post
        # heads), not the list order: the last post-pool head wins
        last = (self.heads["post_pool"] or self.heads["pre_pool"] or [None])[-1]
        self.out_dim = cfg.hidden_size if last is None else last["w"].shape[1]
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
        L = self.cfg.num_layers
        stacked = self.method in STACK_POOLERS or self.layeridx not in (-1, L)
        with torch.inference_mode(), matmul_precision(self.cfg.matmul_precision):
            if stacked:
                stack = self.model(ids_t, mask_t, output_hidden_states=True)
            if self.method in STACK_POOLERS:
                emb = pool(self.method, stack, mask_t)
            else:
                hidden = stack[self.layeridx] if stacked else self.model(ids_t, mask_t)
                hidden = apply_heads(hidden, self.heads["pre_pool"])
                emb = pool_single(hidden, mask_t, self.method, self.learned_weights)
            emb = apply_heads(emb, self.heads["post_pool"])
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
        if self.text_prefix:
            texts = [self.text_prefix + t for t in texts]

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
        name and shape plus its first 16 values, the dense heads' and the
        learnt position weights' included, and the heads' structure
        (activations, locations)."""
        if not hasattr(self, "_fp"):
            h = hashlib.sha1()
            leaves = sorted(self.model.state_dict().items())
            for loc, heads in self.heads.items():
                h.update(f"{loc}{[hd['activation'] for hd in heads]}".encode())
                for i, hd in enumerate(heads):
                    leaves += [(f"{loc}.{i}.{k}", hd[k]) for k in ("w", "b") if hd[k] is not None]
            if self.learned_weights is not None:
                leaves.append(("learned_weights", self.learned_weights))
            for name, leaf in leaves:
                h.update(f"{name}{tuple(leaf.shape)}".encode())
                h.update(leaf.detach().reshape(-1)[:16].float().cpu().numpy().tobytes())
            self._fp = h.hexdigest()[:12]
        return self._fp

    def _cache_key(self, texts, is_query) -> Optional[str]:
        if not self.cache_dir:
            return None
        h = hashlib.sha1()
        h.update(f"torch|{self.method}|{self.layeridx}|{self.codec.specb}|{is_query}|"
                 f"{self.normalize}|{self.codec.max_seq_len}|flash={self.cfg.use_flash}|"
                 f"{self.text_prefix}|{self._params_fingerprint()}|{len(texts)}".encode())
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
