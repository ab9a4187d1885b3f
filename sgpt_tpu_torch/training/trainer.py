"""Contrastive trainer (counterpart of `sgpt_tpu/training/trainer.py`).

The SGPT-BE fine-tuning loop, as the JAX `ContrastiveTrainer` runs it on
one device:

  * MNRL over (anchor, positive[, hard negative]) triplets, scale 20; each
    tower is encoded on its own, padded to `max_seq_len`
  * BitFit (`freeze_nonbias`): frozen parameters get `requires_grad=False`,
    so the clip sees only trainable gradients and decay never touches a
    frozen leaf, which is what the JAX optimizer's zeroing amounts to
  * AdamW (`torch.optim.AdamW`, decoupled decay as `optax.adamw`) with no
    decay on bias, LayerNorm scale and position-weight leaves
  * optax's `clip_by_global_norm` rule: scale by max_norm / norm when
    norm ≥ max_norm
  * the schedule at the number of updates already made, over optimizer
    steps; `grad_accum` averages k micro-steps' gradients, as
    `optax.MultiSteps`
  * GradCache (`use_gradcache`, `chunk_size`), evaluation with best-model
    tracking, step checkpoints with retention
  * auxiliary trainable state outside the decoder (`aux`), trainable also
    under BitFit: learnt position weights for `learned_weightedmean`
    (ones of length max_seq_len) and dense heads (`dense_heads`: w (in, out)
    from 0.02·N(0, 1) of a generator seeded with seed + 1, b zeros),
    applied pre-pool heads → pooler → post-pool heads; weight decay on a
    head's w only
  * `export_model()`: the trained pipeline as an `SGPTModel` on the live
    decoder

The model is the port's `Decoder`; it trains on the device its parameters
are on. Every tower pads to `max_seq_len`, so a `use_flash` model at
`max_seq_len % 128 == 0` (long-context training) runs the flash attention
in every layer of every step: K3 forward, K4a/K4b backward on the card
(under GradCache, pass 1 runs K3 alone, without a graph); other lengths
(the NLI default 75, MS MARCO's 300) run K1 forward and K2 backward.
Meshes are not ported yet and raise `NotImplementedError` naming their
ROADMAP item.
"""
from __future__ import annotations

import dataclasses
import inspect
import logging
import os
import time
from typing import Callable, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..encoder import ACTIVATIONS, apply_heads, pool_single
from ..losses import mnrl_loss
from ..models.config import DecoderConfig
from ..models.decoder import Decoder, check_token_ids
from ..models.precision import matmul_precision
from ..ops.pooling import POOLERS
from ..ops.quant import is_quantized_model
from ..tokenization.base import Tokenizer
from ..tokenization.specb import SpecbCodec
from .bitfit import bitfit_mask
from .gradcache import chunk_tree, gradcache_backward
from .schedules import make_schedule

logger = logging.getLogger(__name__)

# leaves that take no weight decay (ST fit, SentenceTransformer.py:729-733)
NO_DECAY = frozenset({"bias", "bi", "bo", "bq", "bk", "bv", "b", "scale", "pos_weights"})


@dataclasses.dataclass
class TrainConfig:
    lr: float = 2e-5                      # ST fit default (SentenceTransformer.py:625)
    weight_decay: float = 0.01
    epochs: int = 1
    batch_size: int = 64
    max_seq_len: int = 75                 # NLI default (training_nli_v2.py:64)
    scheduler: str = "warmuplinear"
    warmup_ratio: float = 0.1             # ST convention: 10% of steps
    max_grad_norm: float = 1.0
    grad_accum: int = 1
    scale: float = 20.0
    similarity: str = "cos_sim"
    pooling: str = "weightedmean"
    specb: bool = False
    freeze_nonbias: bool = False          # BitFit
    train_wte: bool = False
    use_gradcache: bool = False
    chunk_size: int = 8
    eval_steps: int = 0                   # 0 = only at epoch end
    checkpoint_steps: int = 0
    checkpoint_limit: int = 2
    output_dir: Optional[str] = None
    seed: int = 0
    # trainable dense heads (--addxlinear/--linearthenpool/--useact/--outfeats,
    # training_nli_v2.py:93-117): list of dicts with keys
    # in_features/out_features[/bias/activation/location]
    dense_heads: Optional[list] = None
    # optional metrics sink called with {'step', 'loss'|'eval_score', ...}
    log_fn: Optional[Callable[[dict], None]] = None


class ContrastiveTrainer:
    def __init__(self, model: Decoder, cfg: DecoderConfig, tokenizer: Tokenizer,
                 train_config: TrainConfig, mesh=None, sp_mesh=None):
        """model: the port's `Decoder`, on the device to train on. The other
        arguments have the JAX trainer's meaning; `mesh` and `sp_mesh` are
        not ported yet."""
        if mesh is not None or sp_mesh is not None:
            raise NotImplementedError(
                "mesh (dp/tp training) — ROADMAP Queue 1 item 12; sp_mesh "
                "(sequence-parallel training) — ROADMAP Queue 1 item 11")
        if train_config.pooling not in POOLERS \
                and train_config.pooling != "learned_weightedmean":
            raise ValueError(
                f"pooling {train_config.pooling!r} not trainable here; choose one of "
                f"{sorted(POOLERS)} or 'learned_weightedmean'")
        if model.cfg != cfg:
            raise ValueError("ContrastiveTrainer: cfg differs from the model's config")
        if is_quantized_model(model):
            raise ValueError("ContrastiveTrainer: the model has int8 projections; quantized "
                             "models are for inference only, train the float model")
        self.model = model
        self.cfg = cfg
        self.tc = train_config
        self.tokenizer = tokenizer
        # clean_newlines=False: the reference's ST training path tokenizes
        # raw text; the newline->space cleanup is a BEIR-embed-path behavior
        self.codec = SpecbCodec(tokenizer, max_seq_len=train_config.max_seq_len,
                                specb=train_config.specb, clean_newlines=False)
        self.device = next(model.parameters()).device
        # auxiliary trainable tensors outside the decoder, fp32 on its device
        # (trainable under BitFit too, like the reference's pooling and Dense
        # modules, which training_nli_v2.py never freezes)
        self.aux: dict = {}
        self._head_meta: list = []
        if train_config.pooling == "learned_weightedmean":
            # learnt per-position weights, init 1.0 (WeightedMeanPooling.py:19)
            self.aux["pos_weights"] = torch.ones(train_config.max_seq_len, device=self.device)
        if train_config.dense_heads:
            gen = torch.Generator().manual_seed(train_config.seed + 1)
            heads = []
            for spec in train_config.dense_heads:
                if spec.get("activation", "identity") not in ACTIVATIONS:
                    raise ValueError(f"dense head activation {spec['activation']!r}: one of "
                                     f"{sorted(ACTIVATIONS)}")
                if spec.get("location", "post_pool") not in ("pre_pool", "post_pool"):
                    raise ValueError(f"dense head location {spec['location']!r}: "
                                     "expected pre_pool or post_pool")
                w = 0.02 * torch.randn(spec["in_features"], spec["out_features"], generator=gen)
                h = {"w": w.to(self.device)}
                if spec.get("bias", True):
                    h["b"] = torch.zeros(spec["out_features"], device=self.device)
                heads.append(h)
                self._head_meta.append({"activation": spec.get("activation", "identity"),
                                        "location": spec.get("location", "post_pool")})
            self.aux["heads"] = heads
        for leaf in aux_leaves(self.aux).values():
            leaf.requires_grad_(True)
        self.best_score = -1e9
        self.best_params = None
        self.best_aux = None
        self._opt = None
        self._sched = None
        self._micro = 0

    # ------------------------------------------------------------------
    def _build_optimizer(self, total_steps: int):
        """AdamW + LambdaLR over the trainable parameters, which this also
        marks: under BitFit every other parameter gets requires_grad=False."""
        tc = self.tc
        # the schedule advances once per OPTIMIZER step, so the horizon is
        # in optimizer steps, not micro-steps
        opt_steps = max(1, total_steps // max(tc.grad_accum, 1))
        schedule = make_schedule(tc.scheduler, tc.lr, int(tc.warmup_ratio * opt_steps),
                                 opt_steps)
        mask = (bitfit_mask(self.model, train_wte=tc.train_wte)
                if tc.freeze_nonbias else None)
        decay, no_decay = [], []
        for name, p in self.model.named_parameters():
            p.requires_grad_(mask is None or mask[name])
            if p.requires_grad:
                (no_decay if NO_DECAY & set(name.split(".")) else decay).append(p)
        for name, p in aux_leaves(self.aux).items():  # trainable under BitFit too
            (no_decay if NO_DECAY & set(name.split(".")) else decay).append(p)
        groups = [g for g in ({"params": decay, "weight_decay": tc.weight_decay},
                              {"params": no_decay, "weight_decay": 0.0}) if g["params"]]
        # base lr 1: LambdaLR then sets each step's lr to the schedule's value
        opt = torch.optim.AdamW(groups, lr=1.0, betas=(0.9, 0.999), eps=1e-8)
        return opt, torch.optim.lr_scheduler.LambdaLR(opt, schedule)

    def _heads(self, location: str) -> List[dict]:
        """The live dense heads at `location`, in `apply_heads`' form."""
        return [{**h, **meta} for h, meta in zip(self.aux.get("heads", []), self._head_meta)
                if meta["location"] == location]

    def _encode_fn(self):
        """chunk → (B, D): decoder → pre-pool heads → pooler (the learnt
        position weights for learned_weightedmean) → post-pool heads."""
        model, method = self.model, self.tc.pooling
        pre, post = self._heads("pre_pool"), self._heads("post_pool")
        learned = self.aux.get("pos_weights")

        def encode(chunk):
            h = apply_heads(model(chunk["ids"], chunk["mask"]), pre)
            return apply_heads(pool_single(h, chunk["mask"], method, learned), post)

        return encode

    def _loss_fn(self, *reps):
        return mnrl_loss(*reps, scale=self.tc.scale, similarity=self.tc.similarity)

    def _loss_and_grads(self, towers) -> torch.Tensor:
        """Loss of one batch; its gradients accumulate into `.grad`. The
        backward's products run outside `Decoder.forward`, so the whole call
        takes the model's `matmul_precision` (JAX carries the forward's
        precision into the transposed products)."""
        encode = self._encode_fn()
        with matmul_precision(self.model.cfg.matmul_precision):
            if self.tc.use_gradcache:
                return gradcache_backward(encode, self._loss_fn, towers)
            loss = self._loss_fn(*[encode(t) for t in towers])
            loss.backward()
            return loss.detach()

    def _trainable(self) -> List[torch.Tensor]:
        return [p for g in self._opt.param_groups for p in g["params"]]

    def _clip(self, params: Sequence[torch.Tensor]) -> None:
        clip_by_global_norm(params, self.tc.max_grad_norm)

    def _step(self, towers) -> torch.Tensor:
        """One micro-step; every `grad_accum`-th applies the averaged
        gradients, clipped, with the schedule's lr."""
        loss = self._loss_and_grads(towers)
        self._micro += 1
        k = max(self.tc.grad_accum, 1)
        if self._micro % k == 0:
            params = self._trainable()
            if k > 1:
                for p in params:
                    if p.grad is not None:
                        p.grad.div_(k)
            self._clip(params)
            self._opt.step()
            self._sched.step()
            self._opt.zero_grad(set_to_none=True)
        return loss

    # ------------------------------------------------------------------
    def _tokenize_tower(self, texts: Sequence[str], is_query: bool):
        enc = self.codec.encode(list(texts), is_query=is_query, pad_to=self.tc.max_seq_len)
        ids = np.asarray(enc.input_ids)
        check_token_ids(ids, self.cfg.vocab_size)
        return {"ids": ids.astype(np.int64), "mask": np.asarray(enc.attention_mask)}

    def _prep_batch(self, batch: Sequence[Tuple[str, ...]]):
        """batch of (anchor, positive[, negative]) → tower dicts of tensors
        on the model's device (chunked under GradCache).

        Returns None for a ragged tail batch too small to keep: tails are
        trimmed to the chunk granularity (the reference's DataLoader
        drop_last analog)."""
        batch = list(batch)
        granularity = self.tc.chunk_size if self.tc.use_gradcache else 1
        keep = len(batch) - len(batch) % granularity
        if keep != len(batch):
            logger.warning("trimming ragged tail batch %d -> %d (granularity %d)",
                           len(batch), keep, granularity)
            if keep == 0:
                return None
            batch = batch[:keep]
        cols = list(zip(*batch))
        towers = [self._tokenize_tower(cols[0], is_query=True)]
        for c in cols[1:]:
            towers.append(self._tokenize_tower(c, is_query=False))
        if self.tc.use_gradcache:
            towers = [chunk_tree(t, self.tc.chunk_size) for t in towers]
        return [{k: torch.from_numpy(v).to(self.device) for k, v in t.items()}
                for t in towers]

    # ------------------------------------------------------------------
    def fit(self, train_batches: Callable[[], Iterable[Sequence[Tuple[str, ...]]]],
            steps_per_epoch: int, evaluator: Optional[Callable] = None) -> dict:
        """train_batches(): fresh iterator of batches each epoch.

        evaluator(model) -> float; higher is better (ST convention). An
        evaluator taking two positional arguments receives (model, aux).
        Returns {'params', 'aux', 'best_params', 'best_aux', 'best_score',
        'history'}, with state dicts for the params."""
        tc = self.tc
        total = steps_per_epoch * tc.epochs
        self._opt, self._sched = self._build_optimizer(total)
        self._opt.zero_grad(set_to_none=True)
        self._micro = 0
        self.model.train()

        history: List[dict] = []
        gstep = 0
        last_eval_step = -1
        for epoch in range(tc.epochs):
            t0 = time.time()
            for batch in train_batches():
                towers = self._prep_batch(batch)
                if towers is None:  # ragged tail smaller than the granularity
                    continue
                loss = self._step(towers)
                gstep += 1
                if gstep % max(1, steps_per_epoch // 10) == 0:
                    logger.info("epoch %d step %d loss %.4f", epoch, gstep, float(loss))
                # keep the device scalar: float() here would synchronise every
                # step; history is materialised once at the end
                history.append({"step": gstep, "loss": loss})
                if tc.log_fn:
                    tc.log_fn({"step": gstep, "loss": float(loss)})
                if evaluator and tc.eval_steps and gstep % tc.eval_steps == 0:
                    self._evaluate(evaluator, gstep, history)
                    last_eval_step = gstep
                if tc.checkpoint_steps and gstep % tc.checkpoint_steps == 0:
                    self.save_checkpoint(gstep, self._opt)
            if evaluator and gstep != last_eval_step:  # skip back-to-back dup
                self._evaluate(evaluator, gstep, history)
                last_eval_step = gstep
            logger.info("epoch %d done in %.1fs", epoch, time.time() - t0)

        history = [{**h, "loss": float(h["loss"])} if "loss" in h else h for h in history]
        params = self.model.state_dict()
        return {"params": params, "aux": self.aux,
                "best_params": self.best_params or params,
                "best_aux": self.best_aux or self.aux,
                "best_score": self.best_score, "history": history}

    def export_model(self, tokenizer_name: Optional[str] = None):
        """The trained pipeline as an `SGPTModel`: the live decoder module
        (no copy of its weights), the dense heads and the learnt position
        weights as they stand, on the trainer's device. `tokenizer_name`
        names the HF tokenizer for `SGPTModel.save` (not needed with the
        hash tokenizer of random weights)."""
        from ..model import SGPTModel
        dense_heads = None
        if self._head_meta:
            dense_heads = [{**{k: v.detach() for k, v in h.items()}, **meta}
                           for h, meta in zip(self.aux["heads"], self._head_meta)]
        pos = self.aux.get("pos_weights")
        return SGPTModel(
            self.model, self.cfg, self.tokenizer,
            method="learned_weightedmean" if pos is not None else self.tc.pooling,
            specb=self.tc.specb, max_seq_len=self.tc.max_seq_len, dense_heads=dense_heads,
            learned_weights=None if pos is None else pos.detach(),
            tokenizer_name=tokenizer_name, device=self.device)

    def _snapshot(self):
        """A copy of the model as it stands, for best-model tracking: a
        state dict in which every trainable parameter is a clone and every
        frozen one the live tensor (frozen leaves do not change, so under
        BitFit a 6B model's snapshot costs its biases, not a second copy of
        its weights on the card), and a deep copy of `aux`."""
        trainable = {n for n, p in self.model.named_parameters() if p.requires_grad}
        params = {k: v.detach().clone() if k in trainable else v
                  for k, v in self.model.state_dict().items()}
        return params, _clone_aux(self.aux)

    def _evaluate(self, evaluator, step, history):
        try:
            n_args = len([p for p in inspect.signature(evaluator).parameters.values()
                          if p.default is inspect.Parameter.empty
                          and p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)])
        except (TypeError, ValueError):
            n_args = 1
        with torch.no_grad():
            score = float(evaluator(self.model, self.aux) if n_args >= 2
                          else evaluator(self.model))
        self.model.train()
        record = {"step": step, "eval_score": score}
        history.append(record)
        if self.tc.log_fn:
            self.tc.log_fn(record)
        logger.info("eval @%d: %.4f", step, score)
        if score > self.best_score:  # best-model save (ST fit :861-876)
            self.best_score = score
            self.best_params, self.best_aux = self._snapshot()
            if self.tc.output_dir:
                self.save_model(os.path.join(self.tc.output_dir, "best"))

    # ------------------------------------------------------------------
    def save_checkpoint(self, step: int, optimizer=None):
        """Step checkpoint with retention pruning (ST fit :878-891)."""
        if not self.tc.output_dir:
            return
        from .checkpoint import prune_checkpoints, save_checkpoint as _save
        path = os.path.join(self.tc.output_dir, "checkpoints", str(step))
        _save(path, {"model": self.model.state_dict(), "aux": _clone_aux(self.aux)},
              opt_state=None if optimizer is None else optimizer.state_dict(), step=step)
        prune_checkpoints(os.path.join(self.tc.output_dir, "checkpoints"),
                          self.tc.checkpoint_limit)

    def save_model(self, path: str):
        from .checkpoint import save_checkpoint as _save
        _save(path, {"model": self.model.state_dict(), "aux": _clone_aux(self.aux)}, step=None)

    def restore(self, path: str):
        """Resume weights from a step checkpoint or a saved model dir (the
        optimizer state stays in the checkpoint, as in the JAX trainer)."""
        from .checkpoint import load_checkpoint
        tree = load_checkpoint(path)
        self.model.load_state_dict(tree["model"])
        saved = aux_leaves(tree.get("aux", {}))
        live = aux_leaves(self.aux)
        if set(saved) != set(live):
            raise ValueError(f"{path}: aux leaves {sorted(saved)}, the trainer has "
                             f"{sorted(live)}")
        with torch.no_grad():  # in place: the optimizer holds the live tensors
            for name, t in live.items():
                t.copy_(saved[name])
        return self


def clip_by_global_norm(params: Sequence[torch.Tensor], max_norm: float) -> None:
    """optax.clip_by_global_norm on the parameters' `.grad`, in place: keep
    the gradients when their global norm is below max_norm, else scale them
    by max_norm / norm."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm.to(g.dtype) * max_norm))


def aux_leaves(aux: dict) -> dict:
    """{"pos_weights": t, "heads.0.w": t, ...}: the aux tensors by name."""
    out = {}
    if "pos_weights" in aux:
        out["pos_weights"] = aux["pos_weights"]
    for i, h in enumerate(aux.get("heads", [])):
        out.update({f"heads.{i}.{k}": v for k, v in h.items()})
    return out


def _clone_aux(aux: dict) -> dict:
    """A deep copy of `aux` (head lists included), detached."""
    out = {}
    if "pos_weights" in aux:
        out["pos_weights"] = aux["pos_weights"].detach().clone()
    if "heads" in aux:
        out["heads"] = [{k: v.detach().clone() for k, v in h.items()} for h in aux["heads"]]
    return out
