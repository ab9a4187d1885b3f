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

`quantize="int8"` runs the decoder's projections in int8 (`ops/quant.py`)
on a quantized copy of the model.

`mesh=` (a `parallel.Mesh`) encodes data-parallel over its dp axis, and
tensor-parallel over its tp axis (Megatron sharding, `parallel.shard_params`):
each batch's row count is a multiple of dp, dp row i encodes the batch's
i-th contiguous block of rows (a replica for tp=1, the tp forward of
`models.decoder.TPGroup` otherwise: K1 per batch shard, or per head shard),
pools and applies the heads on its own device, and the blocks come back
to the host in row order.

`sp_mesh=` (a `parallel.Mesh`) encodes long documents sequence-parallel:
every bucket's T pads up to a multiple of the mesh's size (pads are
causally invisible) and the decoder shards T over the mesh's dp devices
with ring attention (`models/decoder.py`); the model runs on the mesh's
first device.

The batches are planned from the sorted lengths before any dispatch, and
dispatched without waiting for the device: inputs are copied from pinned
memory without a synchronise, each batch's embeddings start their copy to
pinned host memory right behind its forward (so later batches queued on
the stream do not delay it), and the host waits for that copy only once
`FETCH_PIPELINE_DEPTH` dispatches are pending (2: the host pads and
launches batch i + 1 while the device runs batch i). On a single device,
`dispatch_chain` groups runs of same-shape batches (descending powers of
two, at most the largest power of two ≤ dispatch_chain): a group's
forwards are launched back to back, their (B, D) embeddings stacked on the
device and fetched as one (k, B, D) tensor. Each batch runs the same
forward at the same shape either way, so the embeddings do not depend on
the depth or the chain, bit for bit.
"""
from __future__ import annotations

import hashlib
import logging
import os
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .models.config import DecoderConfig
from .models.decoder import Decoder, check_token_ids
from .models.precision import matmul_precision
from .ops.pooling import POOLERS, STACK_POOLERS, normalize, pool
from .ops.quant import quantized_copy
from .parallel.collectives import copy_rows_to_host, gather_rows, rows_to_device, wait_rows
from .parallel.mesh import placement
from .parallel.sharding import ShardedDecoder, shard_params
from .tokenization.base import Tokenizer
from .tokenization.specb import SpecbCodec, pick_bucket, row_bucket
from .utils.profiling import span

logger = logging.getLogger(__name__)

# dispatched batches (or chain groups) in flight before their device-to-host
# fetch: 2 = the host prepares batch i + 1 while the device runs batch i;
# 1 = fetch each batch before the next is dispatched
FETCH_PIPELINE_DEPTH = 2

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


def _chain_group_sizes(shapes: Sequence[tuple], chain: int) -> list:
    """The dispatch-chain plan of a batch stream of known shapes: sizes[i]
    is the size of the group that starts at batch i (0 for its other
    members). Each maximal run of same-shape batches splits greedily into
    descending powers of two, at most the largest power of two ≤ chain
    (13 batches at chain 8: 8 + 4 + 1)."""
    cap = 1
    while cap * 2 <= max(1, chain):
        cap *= 2
    sizes = [0] * len(shapes)
    i = 0
    while i < len(shapes):
        j = i
        while j < len(shapes) and shapes[j] == shapes[i]:
            j += 1
        n, p, g = j - i, i, cap
        while n:
            while g > n:
                g //= 2
            sizes[p] = g
            p += g
            n -= g
        i = j
    return sizes


def place_model(model, quantize: Optional[str], device, mesh):
    """The model the engine (the ranker) runs: on `device`, int8 with
    quantize="int8" (a copy: the caller's stays float), sharded over a mesh
    (after quantizing: the JAX CLIs' order)."""
    if isinstance(model, ShardedDecoder):
        if quantize is not None:
            raise ValueError("quantize an unsharded model: pass the Decoder with mesh=, or "
                             "quantize_decoder_params before shard_params")
        if mesh is None:
            raise ValueError("a ShardedDecoder needs its mesh= too")
        return shard_params(model, mesh)
    if mesh is not None:
        return shard_params(quantized_copy(model, quantize).eval(), mesh)
    return quantized_copy(model.to(device), quantize).eval()


class EmbeddingEngine:
    """Batched sentence embedding over the port's decoder (GPT-Neo, GPT-J,
    BLOOM, BERT, T5's encoder)."""

    def __init__(self, model: Decoder, cfg: DecoderConfig, tokenizer: Tokenizer, *,
                 device=None, method: str = "weightedmean", specb: bool = False,
                 layeridx: int = -1, max_seq_len: Optional[int] = None,
                 batch_size: int = 32, normalize_embeddings: bool = False,
                 learned_weights=None, dense_heads: Optional[list] = None,
                 cache_dir: Optional[str] = None, text_prefix: str = "",
                 quantize: Optional[str] = None, mesh=None, sp_mesh=None,
                 fused_attention: Optional[bool] = None, dispatch_chain: int = 8):
        """device: where the model runs, the card ("cuda") by default;
        "cuda" without a card raises, and CPU use passes device="cpu". With
        a mesh, the mesh's first device (a device given must be it).
        Every other argument has the JAX engine's meaning:

        mesh: a `parallel.Mesh`: encode over its dp × tp devices (see the
        module docstring). `model` is a `Decoder` (sharded here, after the
        int8 copy with quantize="int8") or a `ShardedDecoder` on this mesh
        (then quantize must be None: quantize before sharding).
        sp_mesh: a `parallel.Mesh`: sequence-parallel encode (ring attention
        over its dp devices; T pads to a multiple of the mesh's size); the
        model runs on its first device. Exclusive with `mesh`.

        quantize: "int8" runs the decoder's projections as int8 weights ×
        per-token int8 activations (`ops/quant.py`) on a quantized copy:
        the caller's model stays float. For a model whose float and int8
        copies do not fit the card together, quantize it first with
        `quantize_decoder_params(model, free_source=True)` and pass that
        with quantize=None (what the CLIs do).
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
        text_prefix: prepended to every text before tokenization.
        fused_attention: None (the JAX default) or True: K1 on the card,
        its plain version on the CPU, as always. False raises: in JAX it
        selects XLA's attention, and the port has no such path on the card.
        dispatch_chain: the largest group of same-shape batches launched
        back to back and fetched as one (see the module docstring; a
        single device only, a mesh or sp_mesh dispatches per batch); 1
        fetches each batch on its own."""
        if mesh is not None and sp_mesh is not None:
            raise ValueError("pass either mesh (dp encode) or sp_mesh "
                             "(sequence-parallel long-context encode), not both")
        if fused_attention is False:
            raise ValueError(
                "fused_attention=False selects XLA's attention in the JAX engine; the port "
                "has no such path on the card: K1 runs there, and its plain version is the "
                "CPU path and the card's reference, never the card's main path")
        if method not in POOLERS and method not in STACK_POOLERS \
                and method != "learned_weightedmean":
            raise ValueError(f"unknown pooling method {method!r}")
        if method == "learned_weightedmean" and learned_weights is None:
            raise ValueError("learned_weightedmean needs learned_weights")
        if model.cfg != cfg:
            raise ValueError("EmbeddingEngine: cfg differs from the model's config")
        self.mesh = mesh
        self.sp_mesh = sp_mesh
        self.device = device = placement(device, mesh or sp_mesh, "EmbeddingEngine")
        self.model = place_model(model, quantize, device, mesh)
        self.quantize = quantize
        if mesh is not None and batch_size % mesh.shape["dp"]:
            dp = mesh.shape["dp"]   # the JAX engine's rounding: rows split over dp
            batch_size = ((batch_size + dp - 1) // dp) * dp
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.method = method
        self.layeridx = layeridx
        self.batch_size = batch_size
        self.dispatch_chain = max(1, int(dispatch_chain))
        self.normalize = normalize_embeddings
        self.cache_dir = cache_dir
        self.text_prefix = text_prefix
        self.learned_weights = (None if learned_weights is None else
                                torch.as_tensor(learned_weights).to(device))
        self._aux_on: dict = {}
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
    def _embed(self, ids: np.ndarray, mask: np.ndarray) -> List[torch.Tensor]:
        """Dispatch one batch: forward + pool + normalise on the device,
        with no fetch and no synchronise. Returns the batch's (B, D)
        embeddings as device tensors in row order: one on a single device;
        on a mesh one per dp row, dp row i taking the batch's i-th block of
        rows."""
        check_token_ids(ids, self.cfg.vocab_size)
        if self.mesh is None:
            return [self._embed_on(self.model, self.device, ids, mask)]
        n = ids.shape[0] // len(self.model.groups)
        return [self._embed_on(g, g.device, ids[i * n:(i + 1) * n], mask[i * n:(i + 1) * n])
                for i, g in enumerate(self.model.groups)]

    @staticmethod
    def _drain(pending: list, out: np.ndarray) -> None:
        """Fetch the oldest pending entry (its sels, the copies of its
        embeddings to the host) and write each batch's rows: out[sel] =
        emb[:len(sel)]."""
        with span("engine.drain"):
            sels, copies = pending.pop(0)
            emb = wait_rows(copies)
            emb = emb.reshape(len(sels), -1, emb.shape[-1])
            for sel, e in zip(sels, emb):
                out[sel] = e[:len(sel)]

    def _aux(self, device: torch.device):
        """The dense heads and learnt position weights on `device` (copied
        there once)."""
        if device not in self._aux_on:
            self._aux_on[device] = (
                {loc: [{k: v.to(device) if torch.is_tensor(v) else v for k, v in h.items()}
                       for h in heads] for loc, heads in self.heads.items()},
                None if self.learned_weights is None else self.learned_weights.to(device))
        return self._aux_on[device]

    def _embed_on(self, model, device, ids: np.ndarray, mask: np.ndarray) -> torch.Tensor:
        """Forward + pool + heads + normalise of rows on `device`, `model`'s."""
        heads, learned_weights = self._aux(device)
        ids_t, mask_t = rows_to_device(device, ids, mask)
        L = self.cfg.num_layers
        stacked = self.method in STACK_POOLERS or self.layeridx not in (-1, L)
        sp = {} if self.sp_mesh is None else {"sp_mesh": self.sp_mesh}
        with torch.inference_mode(), matmul_precision(self.cfg.matmul_precision):
            if stacked:
                stack = model(ids_t, mask_t, output_hidden_states=True, **sp)
            if self.method in STACK_POOLERS:
                emb = pool(self.method, stack, mask_t)
            else:
                hidden = stack[self.layeridx] if stacked else model(ids_t, mask_t, **sp)
                hidden = apply_heads(hidden, heads["pre_pool"])
                emb = pool_single(hidden, mask_t, self.method, learned_weights)
            emb = apply_heads(emb, heads["post_pool"])
            if self.normalize:
                emb = normalize(emb)
            return emb

    def _rows_for_bucket(self, T: int) -> int:
        """Rows per batch for length bucket T (token-budget batching):
        budget = batch_size × max_seq_len tokens; on a mesh, rounded up to a
        multiple of dp."""
        B = row_bucket(max(1, (self.batch_size * self.codec.max_seq_len) // T),
                       allow_overshoot=T < self.codec.max_seq_len)
        if self.mesh is not None:
            dp = self.mesh.shape["dp"]
            B = ((max(B, dp) + dp - 1) // dp) * dp
        return B

    def warmup(self, lengths: Optional[Sequence[int]] = None):
        """Run each (rows, bucket) shape once before traffic: builds the
        kernels and warms the matmul libraries' plans."""
        lengths = lengths or [b for b in self.codec.buckets
                              if b <= self.codec.max_seq_len]
        for T in lengths:
            B = self._rows_for_bucket(T)
            T = self._sp_length(T)
            gather_rows(self._embed(np.zeros((B, T), np.int32), np.ones((B, T), np.int32)))
        return self

    def _sp_length(self, T: int) -> int:
        """T rounded up to a multiple of the sp_mesh's size (the JAX rule)."""
        if self.sp_mesh is None:
            return T
        n = int(np.prod(list(self.sp_mesh.shape.values())))
        return (T + n - 1) // n * n

    def encode(self, texts: Sequence[str], *, is_query: bool = False,
               show_progress: bool = False) -> np.ndarray:
        """Embed a list of texts → (N, D) float32 numpy array (input order).
        show_progress: accepted and unused, as in the JAX engine."""
        if len(texts) == 0:
            return np.zeros((0, self.out_dim), np.float32)
        cached = self._cache_load(texts, is_query)
        if cached is not None:
            return cached
        if self.text_prefix:
            texts = [self.text_prefix + t for t in texts]

        with span("engine.tokenize"):
            rows, n_trunc, toks_trunc = self.codec.encode_rows(texts, is_query=is_query)
        if n_trunc:
            logger.warning("Truncated %d/%d docs by %d tokens",
                           n_trunc, len(texts), toks_trunc)
        with span("engine.plan"):
            order = np.argsort([-len(r) for r in rows], kind="stable")
            out = np.zeros((len(texts), self.out_dim), np.float32)
            batches = []   # (sel, T, B) in stream order: planned before any dispatch
            s = 0
            while s < len(order):
                T = pick_bucket(max(1, len(rows[order[s]])), self.codec.buckets,
                                self.codec.max_seq_len)
                T = max(T, len(rows[order[s]]))
                B = self._rows_for_bucket(T)
                batches.append((order[s: s + B], T, B))
                s += len(batches[-1][0])
            chain = self.dispatch_chain if self.mesh is None and self.sp_mesh is None else 1
            sizes = _chain_group_sizes([(B, T) for _, T, B in batches], chain)
        pending: list = []   # (sels, copies to the host) of dispatches not yet fetched
        group: list = []     # (sel, (B, D) device tensor) of the chain group being filled
        size = 1
        for (sel, T, B), start in zip(batches, sizes):
            size = start or size
            with span("engine.pad"):
                ids, mask = self._pad_batch(rows, sel, T, B)
            with span("engine.dispatch"):
                emb = self._embed(ids, mask)
                if size == 1:
                    pending.append(([sel], copy_rows_to_host(emb)))
                else:
                    group.append((sel, emb[0]))
                    if len(group) < size:
                        continue
                    with torch.inference_mode():   # the group's (k, B, D), fetched as one
                        stacked = torch.stack([g[1] for g in group])
                    pending.append(([g[0] for g in group], copy_rows_to_host([stacked])))
                    group = []
            while len(pending) >= FETCH_PIPELINE_DEPTH:
                self._drain(pending, out)
        while pending:
            self._drain(pending, out)
        self._cache_store(texts, is_query, out)
        return out

    def _pad_batch(self, rows, sel, T: int, B: int) -> tuple:
        """The rows `sel` padded to the (B, T) batch: tokens to T (and on
        an sp_mesh to a multiple of its size: right pads, causally
        invisible), rows to B by tiling the last row."""
        enc = self.codec.pad_rows([rows[i] for i in sel], pad_to=T)
        ids, mask = enc.input_ids, enc.attention_mask
        t_pad = self._sp_length(T) - T
        if t_pad:
            ids = np.pad(ids, ((0, 0), (0, t_pad)), constant_values=self.tokenizer.pad_id)
            mask = np.pad(mask, ((0, 0), (0, t_pad)))
        if len(sel) < B:
            pad = B - len(sel)
            ids = np.concatenate([ids, np.tile(ids[-1:], (pad, 1))])
            mask = np.concatenate([mask, np.tile(mask[-1:], (pad, 1))])
        return ids, mask

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
            # on a mesh: the first shard's leaves and the mesh's shape
            first = self.model if self.mesh is None else self.model.groups[0].shards[0]
            if self.mesh is not None:
                h.update(repr(self.mesh.shape).encode())
            leaves = sorted(first.state_dict().items())
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
