"""SGPTModel — the user-facing embedding pipeline with persistence
(counterpart of `sgpt_tpu/model.py`).

Plays the role of the reference's `SentenceTransformer(modules=[...])`
pipeline (Transformer → [Dense…] → Pooling → [Dense…]) and its save format:
a `manifest.json` describing the pipeline and one checkpoint holding every
trained tensor (the decoder's state dict, the dense heads, the learnt
position weights), written by the port's `training/checkpoint.py`. The
manifest's `format` is "sgpt_tpu_torch.v1", not the JAX package's
"sgpt_tpu.v1", so the two packages' model directories cannot be taken for
each other; `load` refuses any other format.

`AsymModel` is the dual-tower `models.Asym` equivalent: queries and
documents route to different towers, never mixed in one batch.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from .encoder import EmbeddingEngine
from .models.config import DecoderConfig
from .models.decoder import Decoder
from .tokenization.base import SimpleTokenizer, Tokenizer, get_tokenizer
from .training.checkpoint import load_checkpoint, save_checkpoint

MANIFEST = "manifest.json"
FORMAT = "sgpt_tpu_torch.v1"
ASYM_FORMAT = "sgpt_tpu_torch.asym.v1"


@dataclasses.dataclass
class SGPTModel:
    """A decoder and how it embeds. `model` is the port's `Decoder` (not a
    copy: an `SGPTModel` from `ContrastiveTrainer.export_model` shares the
    trainer's live module); `dense_heads` is a list of {"w": (in, out),
    ["b"], "activation", "location"} in application order; `device` is
    where the engine runs, the card by default. `tokenizer_name` is the HF
    tokenizer that `load` reads back: `save` needs it unless `tokenizer` is
    the hash `SimpleTokenizer` (random weights), which the manifest then
    records with its vocab size."""
    model: Decoder
    cfg: DecoderConfig
    tokenizer: Tokenizer
    method: str = "weightedmean"
    specb: bool = False
    layeridx: int = -1
    normalize: bool = False
    max_seq_len: Optional[int] = None
    dense_heads: Optional[List[dict]] = None
    learned_weights: Optional[torch.Tensor] = None
    tokenizer_name: Optional[str] = None
    batch_size: int = 32
    device: Any = "cuda"

    def engine(self, **overrides) -> EmbeddingEngine:
        kw = dict(device=self.device, method=self.method, specb=self.specb,
                  layeridx=self.layeridx, normalize_embeddings=self.normalize,
                  max_seq_len=self.max_seq_len, dense_heads=self.dense_heads,
                  learned_weights=self.learned_weights, batch_size=self.batch_size)
        kw.update(overrides)
        return EmbeddingEngine(self.model, self.cfg, self.tokenizer, **kw)

    def encode(self, texts: Sequence[str], is_query: bool = False, **kw) -> np.ndarray:
        return self.engine().encode(list(texts), is_query=is_query, **kw)

    def encode_queries(self, queries, **kw):
        return self.engine().encode_queries(queries, **kw)

    def encode_corpus(self, corpus, **kw):
        return self.engine().encode_corpus(corpus, **kw)

    # ------------------------------------------------------------------
    def save(self, path: str):
        hashed = isinstance(self.tokenizer, SimpleTokenizer)
        if not hashed and not self.tokenizer_name:
            raise ValueError("SGPTModel.save: name the HF tokenizer (tokenizer_name), so that "
                             "load does not fall back to the hash tokenizer")
        os.makedirs(path, exist_ok=True)
        manifest = {
            "format": FORMAT,
            # the dtype by name, so that a bf16 model reloads as bf16
            "cfg": {**{k: v for k, v in dataclasses.asdict(self.cfg).items() if k != "dtype"},
                    "dtype": str(self.cfg.dtype).removeprefix("torch.")},
            "method": self.method,
            "specb": self.specb,
            "layeridx": self.layeridx,
            "normalize": self.normalize,
            "max_seq_len": self.max_seq_len,
            "tokenizer_name": self.tokenizer_name,
            "hash_tokenizer_vocab": self.tokenizer.vocab_size if hashed else None,
            "batch_size": self.batch_size,
            "dense_heads": [
                {"activation": h.get("activation", "identity"),
                 "location": h.get("location", "post_pool"),
                 "bias": h.get("b") is not None}
                for h in self.dense_heads or []],
            "has_learned_weights": self.learned_weights is not None,
        }
        with open(os.path.join(path, MANIFEST), "w") as f:
            json.dump(manifest, f, indent=2)
        tree = {"decoder": self.model.state_dict()}
        if self.dense_heads:
            tree["heads"] = [{k: torch.as_tensor(h[k]).detach() for k in ("w", "b")
                              if h.get(k) is not None} for h in self.dense_heads]
        if self.learned_weights is not None:
            tree["learned_weights"] = torch.as_tensor(self.learned_weights).detach()
        save_checkpoint(os.path.join(path, "weights"), tree)

    @classmethod
    def load(cls, path: str, tokenizer: Optional[Tokenizer] = None,
             device="cuda") -> "SGPTModel":
        """A model saved by `save`, its decoder built on `device` (the card
        by default; CPU use passes device="cpu"). Without `tokenizer`, the
        one the manifest records: the named HF tokenizer, which must load
        (`get_tokenizer(name, fallback=False)`), or the hash tokenizer of the
        recorded vocab size; a manifest that records neither raises."""
        with open(os.path.join(path, MANIFEST)) as f:
            manifest = json.load(f)
        if manifest.get("format") != FORMAT:
            raise ValueError(f"{path}: model format {manifest.get('format')!r}, expected "
                             f"{FORMAT!r} (a JAX package model directory is 'sgpt_tpu.v1')")
        cfg_dict = dict(manifest["cfg"])
        cfg_dict["dtype"] = getattr(torch, cfg_dict["dtype"])
        cfg = DecoderConfig(**cfg_dict)
        tree = load_checkpoint(os.path.join(path, "weights"))
        model = Decoder(cfg, device=device, weights=tree["decoder"])
        dense_heads = None
        if manifest.get("dense_heads"):
            dense_heads = []
            for meta, weights in zip(manifest["dense_heads"], tree["heads"]):
                h = {"w": weights["w"].to(device), "activation": meta["activation"],
                     "location": meta["location"]}
                if meta["bias"]:
                    h["b"] = weights["b"].to(device)
                dense_heads.append(h)
        lw = tree["learned_weights"].to(device) if manifest.get("has_learned_weights") else None
        name = manifest.get("tokenizer_name")
        if tokenizer is None:
            if name:
                tokenizer = get_tokenizer(name, fallback=False)
            elif manifest.get("hash_tokenizer_vocab"):
                tokenizer = SimpleTokenizer(manifest["hash_tokenizer_vocab"])
            else:
                raise ValueError(f"{path}: the manifest names no tokenizer; pass tokenizer=")
        return cls(model=model, cfg=cfg, tokenizer=tokenizer, method=manifest["method"],
                   specb=manifest["specb"], layeridx=manifest["layeridx"],
                   normalize=manifest["normalize"], max_seq_len=manifest["max_seq_len"],
                   dense_heads=dense_heads, learned_weights=lw, tokenizer_name=name,
                   batch_size=manifest.get("batch_size", 32), device=device)


@dataclasses.dataclass
class AsymModel:
    """Key-routed dual-tower model: separate towers for queries and
    documents (the reference's Asym({'QRY': [...], 'DOCPOS': [...]}))."""
    query_model: SGPTModel
    doc_model: SGPTModel

    def encode(self, texts: Sequence[str], is_query: bool = False, **kw):
        model = self.query_model if is_query else self.doc_model
        return model.encode(texts, is_query=is_query, **kw)

    def encode_queries(self, queries, **kw):
        return self.query_model.encode_queries(queries, **kw)

    def encode_corpus(self, corpus, **kw):
        return self.doc_model.encode_corpus(corpus, **kw)

    def save(self, path: str):
        self.query_model.save(os.path.join(path, "query"))
        self.doc_model.save(os.path.join(path, "doc"))
        with open(os.path.join(path, MANIFEST), "w") as f:
            json.dump({"format": ASYM_FORMAT}, f)

    @classmethod
    def load(cls, path: str, tokenizer: Optional[Tokenizer] = None,
             device="cuda") -> "AsymModel":
        with open(os.path.join(path, MANIFEST)) as f:
            fmt = json.load(f).get("format")
        if fmt != ASYM_FORMAT:
            raise ValueError(f"{path}: model format {fmt!r}, expected {ASYM_FORMAT!r}")
        return cls(SGPTModel.load(os.path.join(path, "query"), tokenizer, device),
                   SGPTModel.load(os.path.join(path, "doc"), tokenizer, device))
