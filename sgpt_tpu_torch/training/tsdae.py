"""TSDAE, denoising auto-encoder pretraining for sentence embeddings
(counterpart of `sgpt_tpu/training/tsdae.py`).

sentence-transformers' DenoisingAutoEncoderLoss with a tied encoder and
decoder, the configuration the TSDAE paper recommends:

  * the encoder embeds the noisy sentence (deletion noise,
    `data.DenoisingBatcher`) and pools it (`POOLERS[pooling]`);
  * a decoder sharing the encoder's weights reconstructs the original
    sentence autoregressively, conditioned on the embedding. Cross-attention
    to one encoder token is a query-independent projection of the embedding,
    so the decoder is the same `Decoder` forward with a per-layer (D, D)
    projection added to each attention output (`cond` / `cond_params`);
  * the loss is the mean token cross-entropy of the shifted original, pads
    excluded, in fp32, over the tied LM head.

Encoder and decoder are one module, so the gradients of both paths meet in
the same parameters. Every sentence pads to `max_seq_len` (75): on the card
each step runs K1 forward and K2 backward at T=75 for the encoder and at
T=74, with an all-ones key mask, for the decoder. With an `sp_mesh`
(long-document TSDAE) both sides ring-attend with T sharded over the mesh's
dp devices; the encoder pads to a multiple of the sp size and the decoder,
which reads one token fewer, to one more than a multiple. JAX's TSDAE takes
no tensor-parallel mesh, and neither does this one.
"""
from __future__ import annotations

from typing import Callable, Iterable, List, Optional, Union

import numpy as np
import torch

from ..models.config import DecoderConfig
from ..models.decoder import Decoder, check_token_ids
from ..models.precision import matmul_precision
from ..ops.pooling import POOLERS
from ..ops.quant import is_quantized_model
from ..tokenization.specb import SpecbCodec
from .bitfit import bitfit_mask
from .trainer import NO_DECAY


def init_tsdae_params(cfg: DecoderConfig, generator: Optional[torch.Generator] = None,
                      device="cpu") -> dict:
    """Per-layer conditioning projections {"w": (L, D, D) 0.02·N(0, 1), "b":
    (L, D) zeros} in fp32, the (degenerate) cross-attention weights trained
    from scratch. Drawn on the host from `generator`, then moved to
    `device`; the JAX `init_tsdae_params` draws from a JAX key, so parity
    checks carry its values over (`models.tsdae_from_jax`)."""
    D, L = cfg.hidden_size, cfg.num_layers
    w = 0.02 * torch.randn((L, D, D), generator=generator)
    return {"w": w.to(device), "b": torch.zeros((L, D), device=device)}


def tsdae_loss(model: Decoder, tsdae_params: dict, src_ids: torch.Tensor,
               src_mask: torch.Tensor, tgt_ids: torch.Tensor, tgt_mask: torch.Tensor,
               pooling: str = "weightedmean", sp_mesh=None) -> torch.Tensor:
    """Encoder(noisy) → rep; the tied decoder reconstructs the original.

    src_*: the noisy sentence (encoder input); tgt_*: the original. The
    decoder reads tgt[:, :-1] with an all-ones mask (the reference passes
    no mask: right pads are causally invisible to real tokens) and is
    scored against tgt[:, 1:]; padded label positions leave the mean.
    sp_mesh: both forwards ring-attend over it (the encoder's T and the
    decoder's T - 1 must divide by its size)."""
    sp = {} if sp_mesh is None else {"sp_mesh": sp_mesh}
    rep = POOLERS[pooling](model(src_ids, src_mask, **sp), src_mask)
    dec_ids = tgt_ids[:, :-1]
    labels = tgt_ids[:, 1:]
    label_mask = tgt_mask[:, 1:].float()
    h = model(dec_ids, torch.ones_like(dec_ids), cond=rep, cond_params=tsdae_params, **sp)
    logp = torch.log_softmax(model.logits(h).float(), dim=-1)
    tok = logp.gather(-1, labels[..., None].long())[..., 0]
    return -(tok * label_mask).sum() / label_mask.sum().clamp_min(1.0)


class TSDAETrainer:
    """Fit loop for TSDAE pretraining: AdamW (constant lr) over the model and
    the conditioning projections, with the JAX trainer's decay mask (no
    decay on biases, LayerNorm scales and position weights) and optional
    BitFit (`freeze_nonbias`: the biases and the projections train, every
    other parameter gets requires_grad=False)."""

    def __init__(self, model: Decoder, cfg: DecoderConfig, tokenizer, *,
                 pooling: str = "weightedmean", max_seq_len: int = 75,
                 lr: float = 3e-5, weight_decay: float = 0.0,
                 freeze_nonbias: bool = False, seed: int = 0, sp_mesh=None):
        """model: the port's `Decoder`, on the device to train on; the other
        arguments have the JAX trainer's meaning. sp_mesh: sequence-parallel
        long-document TSDAE (a `parallel.Mesh`; ring attention over its dp
        axis in the encoder and the tied decoder, which pad separately)."""
        if pooling not in POOLERS:
            raise ValueError(f"unknown pooling {pooling!r}; choose from {sorted(POOLERS)}")
        if model.cfg != cfg:
            raise ValueError("TSDAETrainer: cfg differs from the model's config")
        if is_quantized_model(model):
            raise ValueError("TSDAETrainer: the model has int8 projections; train the "
                             "float model")
        self.model = model
        self.cfg = cfg
        self.pooling = pooling
        self.max_seq_len = max_seq_len
        self.sp_mesh = sp_mesh
        self._src_pad = self._tgt_pad = max_seq_len
        if sp_mesh is not None:
            if "dp" not in sp_mesh.shape:
                raise ValueError("sp_mesh needs a 'dp' axis — ring attention shards the "
                                 "sequence over it")
            n_sp = sp_mesh.shape["dp"]
            up = lambda n: (n + n_sp - 1) // n_sp * n_sp  # noqa: E731
            self._src_pad = up(max_seq_len)            # the encoder reads T
            self._tgt_pad = up(max_seq_len - 1) + 1    # the decoder reads T - 1
        self.codec = SpecbCodec(tokenizer, max_seq_len=max_seq_len, specb=False,
                                clean_newlines=False)  # raw text, as ST trains
        self.device = next(model.parameters()).device
        self.tsdae = init_tsdae_params(cfg, torch.Generator().manual_seed(seed), self.device)
        for t in self.tsdae.values():
            t.requires_grad_(True)
        mask = bitfit_mask(model) if freeze_nonbias else None
        decay, no_decay = [], []
        named = [(n, p) for n, p in model.named_parameters()]
        named += [(f"tsdae.{k}", t) for k, t in self.tsdae.items()]
        for name, p in named:
            if not name.startswith("tsdae."):
                p.requires_grad_(mask is None or mask[name])
            if p.requires_grad:
                (no_decay if NO_DECAY & set(name.split(".")) else decay).append(p)
        groups = [g for g in ({"params": decay, "weight_decay": weight_decay},
                              {"params": no_decay, "weight_decay": 0.0}) if g["params"]]
        self._opt = torch.optim.AdamW(groups, lr=lr, betas=(0.9, 0.999), eps=1e-8)
        model.train()

    @property
    def params(self) -> dict:
        """The model's state dict (the JAX trainer's `params`)."""
        return self.model.state_dict()

    @property
    def tree(self) -> dict:
        """{"model": state dict, "tsdae": {"w", "b"}}, as the JAX trainer's
        `tree`, for `save_checkpoint`."""
        return {"model": self.model.state_dict(),
                "tsdae": {k: t.detach() for k, t in self.tsdae.items()}}

    def _tokenize(self, texts, pad_to: int) -> tuple:
        enc = self.codec.encode(list(texts), is_query=False, pad_to=pad_to)
        ids = np.asarray(enc.input_ids)
        check_token_ids(ids, self.cfg.vocab_size)
        return (torch.from_numpy(ids.astype(np.int64)).to(self.device),
                torch.from_numpy(np.asarray(enc.attention_mask)).to(self.device))

    def prep_batch(self, pairs) -> tuple:
        """pairs: [(noisy, original), ...] or InputExamples with 2 texts →
        (src_ids, src_mask, tgt_ids, tgt_mask) on the model's device."""
        noisy = [p.texts[0] if hasattr(p, "texts") else p[0] for p in pairs]
        orig = [p.texts[1] if hasattr(p, "texts") else p[1] for p in pairs]
        return (*self._tokenize(noisy, self._src_pad), *self._tokenize(orig, self._tgt_pad))

    def step(self, batch: tuple) -> torch.Tensor:
        """One update on a prepared batch; the loss as a device scalar. The
        backward's products run outside `Decoder.forward`, so the whole step
        takes the model's `matmul_precision`."""
        self._opt.zero_grad(set_to_none=True)
        with matmul_precision(self.cfg.matmul_precision):
            loss = tsdae_loss(self.model, self.tsdae, *batch, pooling=self.pooling,
                              sp_mesh=self.sp_mesh)
            loss.backward()
        self._opt.step()
        return loss.detach()

    def train_batch(self, pairs) -> float:
        return float(self.step(self.prep_batch(pairs)))

    def fit(self, batcher: Union[Iterable, Callable[[], Iterable]], epochs: int = 1,
            log_fn: Optional[Callable[[dict], None]] = None) -> List[dict]:
        """batcher: an iterable of batches, or a zero-argument callable that
        returns one. A one-shot iterator with epochs > 1 is materialised
        once, so that every epoch sees the batches."""
        if callable(batcher):
            make = batcher
        else:
            if epochs > 1 and iter(batcher) is batcher:
                batcher = list(batcher)
            make = lambda: batcher  # noqa: E731
        history = []
        step = 0
        for _ in range(epochs):
            for batch in make():
                loss = self.train_batch(batch)
                step += 1
                history.append({"step": step, "loss": loss})
                if log_fn:
                    log_fn(history[-1])
        return history
