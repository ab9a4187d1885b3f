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

Under a (dp, tp) `mesh` (the JAX trainer's `mesh=`): the decoder is
Megatron-sharded over tp into trainable pieces (`shard_params(...,
trainable=True)`, one `TPGroup` a dp row, K1 forward and K2 backward (or
K3, K4a/K4b) on each shard's H/tp heads), each batch's rows split over dp
(under GradCache each chunk's rows), `aux` copied to every dp row, and the
loss `mnrl_loss_dp` over the rows' representations. After the backward
every logical leaf gets one gradient (`parallel.sum_grads`: a sharded
piece summed over the dp rows, a whole leaf over every shard), the clip
takes the norm of the logical tree (each leaf once), and AdamW updates
every copy alike, so the copies of a leaf stay equal bit for bit. No
meshless copy of the weights is kept: `save_model` and checkpoints write
the unsharded tree (`ShardedDecoder.state_dict`) and `restore` shards it
again; the best-model snapshot holds the trainable leaves only (under
BitFit the biases); the evaluator and `export_model` get the live
`ShardedDecoder`, which an engine runs with `mesh=`.

Under an `sp_mesh` (sequence parallelism, the JAX trainer's `sp_mesh=`)
every forward runs T sharded over the mesh's dp devices with ring
attention (`models/decoder.py`), so no attention kernel runs.
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
from ..losses import mnrl_loss_dp
from ..models.config import DecoderConfig
from ..models.decoder import Decoder, check_token_ids
from ..models.precision import matmul_precision
from ..ops.pooling import POOLERS
from ..ops.quant import is_quantized_model
from ..parallel.collectives import sum_grads
from ..parallel.sharding import shard_params
from ..tokenization.base import Tokenizer
from ..tokenization.specb import SpecbCodec
from .bitfit import bitfit_mask
from .gradcache import chunk_tree, gradcache_backward_rows
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
        """model: the port's `Decoder`, on the device to train on (with a
        mesh, anywhere: the trainer shards a copy over the mesh and trains
        that; the caller's model does not change). The other arguments have
        the JAX trainer's meaning:

        mesh: a `parallel.Mesh` (dp, tp): batches split over dp, parameters
        Megatron-sharded over tp (see the module docstring). Under GradCache
        `chunk_size` must divide by dp.
        sp_mesh: a `parallel.Mesh` whose dp axis shards every sequence (ring
        attention): long-document training. Exclusive with `mesh`;
        `max_seq_len` must divide by the sp axis size."""
        tc = train_config
        if mesh is not None and sp_mesh is not None:
            raise ValueError("pass either mesh (dp/tp training) or sp_mesh "
                             "(sequence-parallel long-context), not both")
        if sp_mesh is not None:
            if "dp" not in sp_mesh.shape:
                raise ValueError("sp_mesh needs a 'dp' axis — ring attention shards the "
                                 "sequence over it")
            n_sp = sp_mesh.shape["dp"]
            if tc.max_seq_len % n_sp:
                raise ValueError(f"max_seq_len={tc.max_seq_len} must divide by the sp axis "
                                 f"size {n_sp} (ring attention shards T)")
        if mesh is not None and tc.use_gradcache and tc.chunk_size % mesh.shape["dp"]:
            raise ValueError(f"gradcache chunk_size={tc.chunk_size} must be divisible by "
                             f"dp={mesh.shape['dp']} (chunks shard over the dp axis)")
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
        self.mesh = mesh
        self.sp_mesh = sp_mesh
        # under a mesh the trainer holds the trainable shards only
        self.model = model if mesh is None else shard_params(model, mesh, trainable=True)
        self.cfg = cfg
        self.tc = train_config
        self.tokenizer = tokenizer
        # clean_newlines=False: the reference's ST training path tokenizes
        # raw text; the newline->space cleanup is a BEIR-embed-path behavior
        self.codec = SpecbCodec(tokenizer, max_seq_len=train_config.max_seq_len,
                                specb=train_config.specb, clean_newlines=False)
        self.device = next(model.parameters()).device if mesh is None else self.model.device
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
        # the aux of each dp row, on its device (row 0's is `aux` itself)
        self._aux_rows = [self.aux]
        if mesh is not None:
            for g in self.model.groups[1:]:
                row = _clone_aux(self.aux, g.device)
                for leaf in aux_leaves(row).values():
                    leaf.requires_grad_(True)
                self._aux_rows.append(row)
        self._groups: List[List[torch.Tensor]] = []
        self.best_score = -1e9
        self.best_params = None
        self.best_aux = None
        self._opt = None
        self._sched = None
        self._micro = 0

    # ------------------------------------------------------------------
    def _shards(self) -> List[List[torch.nn.Module]]:
        """The decoders that hold the parameters, [dp row][tp shard]."""
        if self.mesh is None:
            return [[self.model]]
        return [g.shards for g in self.model.groups]

    def _copy_groups(self) -> List[Tuple[str, List[torch.Tensor]]]:
        """Every trainable logical leaf as (name, its copies): meshless one
        tensor each; on a mesh a sharded leaf gives one entry a tp piece
        (its copies in the dp rows), a whole leaf one entry with its copy in
        every shard; each aux leaf its copy in every dp row. Shard order."""
        shards = self._shards()
        params = [[dict(s.named_parameters()) for s in row] for row in shards]
        out = []
        for name, p in params[0][0].items():
            if not p.requires_grad:
                continue
            if self.mesh is None:
                out.append((name, [p]))
            elif "tp" in self.model.specs[name]:
                out += [(name, [row[j][name] for row in params]) for j in range(len(params[0]))]
            else:
                out.append((name, [row_p[name] for row in params for row_p in row]))
        rows = [aux_leaves(a) for a in self._aux_rows]
        out += [(name, [r[name] for r in rows]) for name in rows[0]]
        return out

    def _build_optimizer(self, total_steps: int):
        """AdamW + LambdaLR over the trainable parameters, which this also
        marks: under BitFit every other parameter gets requires_grad=False
        (on a mesh, in every shard by its leaf names)."""
        tc = self.tc
        # the schedule advances once per OPTIMIZER step, so the horizon is
        # in optimizer steps, not micro-steps
        opt_steps = max(1, total_steps // max(tc.grad_accum, 1))
        schedule = make_schedule(tc.scheduler, tc.lr, int(tc.warmup_ratio * opt_steps),
                                 opt_steps)
        for row in self._shards():
            for shard in row:
                mask = (bitfit_mask(shard, train_wte=tc.train_wte)
                        if tc.freeze_nonbias else None)
                for name, p in shard.named_parameters():
                    p.requires_grad_(mask is None or mask[name])
        copies = self._copy_groups()
        self._groups = [c for _, c in copies]
        decay, no_decay = [], []
        for name, group in copies:  # the aux: trainable under BitFit too
            (no_decay if NO_DECAY & set(name.split(".")) else decay).extend(group)
        groups = [g for g in ({"params": decay, "weight_decay": tc.weight_decay},
                              {"params": no_decay, "weight_decay": 0.0}) if g["params"]]
        # base lr 1: LambdaLR then sets each step's lr to the schedule's value
        opt = torch.optim.AdamW(groups, lr=1.0, betas=(0.9, 0.999), eps=1e-8)
        return opt, torch.optim.lr_scheduler.LambdaLR(opt, schedule)

    def _heads(self, aux: dict, location: str) -> List[dict]:
        """The live dense heads of `aux` at `location`, in `apply_heads`' form."""
        return [{**h, **meta} for h, meta in zip(aux.get("heads", []), self._head_meta)
                if meta["location"] == location]

    def _encode_fn(self, row: int = 0):
        """chunk → (B, D) on dp row `row`: decoder (the row's `TPGroup` on
        a mesh; ring attention under an sp_mesh) → pre-pool heads → pooler
        (the learnt position weights for learned_weightedmean) → post-pool
        heads, with the row's aux."""
        model = self.model if self.mesh is None else self.model.groups[row]
        aux, method = self._aux_rows[row], self.tc.pooling
        pre, post = self._heads(aux, "pre_pool"), self._heads(aux, "post_pool")
        learned = aux.get("pos_weights")
        sp = {} if self.sp_mesh is None else {"sp_mesh": self.sp_mesh}

        def encode(chunk):
            h = apply_heads(model(chunk["ids"], chunk["mask"], **sp), pre)
            return apply_heads(pool_single(h, chunk["mask"], method, learned), post)

        return encode

    def _loss_fn(self, *towers):
        """MNRL over each tower's list of dp rows' representations
        (`mnrl_loss_dp`, row 0's copy; meshless one row, where it is
        `mnrl_loss` bit for bit)."""
        return mnrl_loss_dp(*towers, scale=self.tc.scale, similarity=self.tc.similarity)[0]

    def _loss_and_grads(self, rows) -> torch.Tensor:
        """Loss of one batch (`_prep_batch`'s rows); its gradients
        accumulate into `.grad` of each copy that took part. The backward's
        products run outside `Decoder.forward`, so the whole call takes the
        model's `matmul_precision` (JAX carries the forward's precision into
        the transposed products)."""
        encodes = [self._encode_fn(r) for r in range(len(rows))]
        with matmul_precision(self.cfg.matmul_precision):
            if self.tc.use_gradcache:
                return gradcache_backward_rows(encodes, self._loss_fn, rows)
            reps = [[enc(t) for t in towers] for enc, towers in zip(encodes, rows)]
            loss = self._loss_fn(*[list(t) for t in zip(*reps)])
            loss.backward()
            return loss.detach()

    def _step(self, rows) -> torch.Tensor:
        """One micro-step; every `grad_accum`-th applies the averaged
        gradients (on a mesh first summed over each leaf's copies),
        clipped by the logical tree's norm, with the schedule's lr."""
        loss = self._loss_and_grads(rows)
        self._micro += 1
        k = max(self.tc.grad_accum, 1)
        if self._micro % k == 0:
            for group in self._groups:
                if len(group) > 1:
                    sum_grads(group)
                if k > 1:
                    for p in group:
                        if p.grad is not None:
                            p.grad.div_(k)
            clip_grad_groups(self._groups, self.tc.max_grad_norm)
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
        """batch of (anchor, positive[, negative]) → one list of tower
        dicts of tensors for each dp row, on the row's device (meshless: one
        row; under GradCache chunked, each chunk's rows split over dp).

        Returns None for a ragged tail batch too small to keep: tails are
        trimmed to the chunk (and dp) granularity (the reference's
        DataLoader drop_last analog)."""
        batch = list(batch)
        granularity = self.tc.chunk_size if self.tc.use_gradcache else 1
        if self.mesh is not None:
            granularity = max(granularity, self.mesh.shape["dp"])
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
        if self.mesh is None:
            return [[{k: torch.from_numpy(v).to(self.device) for k, v in t.items()}
                     for t in towers]]
        axis = 1 if self.tc.use_gradcache else 0   # the rows of a chunk, or of the batch
        dp = self.mesh.shape["dp"]
        rows = []
        for i, g in enumerate(self.model.groups):
            rows.append([{k: torch.from_numpy(np.ascontiguousarray(np.split(v, dp, axis)[i]))
                          .to(g.device) for k, v in t.items()} for t in towers])
        return rows

    # ------------------------------------------------------------------
    def fit(self, train_batches: Callable[[], Iterable[Sequence[Tuple[str, ...]]]],
            steps_per_epoch: int, evaluator: Optional[Callable] = None) -> dict:
        """train_batches(): fresh iterator of batches each epoch.

        evaluator(model) -> float; higher is better (ST convention); model
        is the live module, on a mesh the `ShardedDecoder` (an engine runs
        it with `mesh=trainer.mesh`). An evaluator taking two positional arguments
        receives (model, aux). Returns {'params', 'aux', 'best_params',
        'best_aux', 'best_score', 'history'}, with (meshless) state dicts
        for the params: best_params is params with the best evaluation's
        trainable leaves."""
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
                rows = self._prep_batch(batch)
                if rows is None:  # ragged tail smaller than the granularity
                    continue
                loss = self._step(rows)
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
                "best_params": {**params, **self.best_params} if self.best_params else params,
                "best_aux": self.best_aux or self.aux,
                "best_score": self.best_score, "history": history}

    def export_model(self, tokenizer_name: Optional[str] = None):
        """The trained pipeline as an `SGPTModel`: the live decoder module
        (no copy of its weights; on a mesh the `ShardedDecoder` with the
        mesh, which the model's engines run on), the dense heads and the
        learnt position weights as they stand, on the trainer's device. `tokenizer_name` names the HF tokenizer for
        `SGPTModel.save` (not needed with the hash tokenizer of random
        weights)."""
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
            tokenizer_name=tokenizer_name, device=self.device, mesh=self.mesh)

    def _snapshot(self):
        """The model as it stands, for best-model tracking: clones of the
        trainable leaves only (frozen leaves do not change, so under BitFit
        a 6B model's snapshot costs its biases, not a second copy of its
        weights on the card; on a mesh the leaves unsharded on the first
        device), and a deep copy of `aux`."""
        trainable = [n for n, p in self._shards()[0][0].named_parameters() if p.requires_grad]
        if self.mesh is not None:
            return self.model.state_dict(trainable), _clone_aux(self.aux)
        live = self.model.state_dict()
        return {k: live[k].detach().clone() for k in trainable}, _clone_aux(self.aux)

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
        optimizer state stays in the checkpoint, as in the JAX trainer); on
        a mesh the tree is sharded again, in place, aux into every dp row."""
        from .checkpoint import load_checkpoint
        tree = load_checkpoint(path)
        try:
            self.load_weights(tree["model"], tree.get("aux", {}))
        except ValueError as e:
            raise ValueError(f"{path}: {e}") from None
        return self

    def load_weights(self, params: dict, aux: dict) -> None:
        """Set the model's weights from a meshless state dict (on a mesh cut
        into every shard) and the aux leaves (into every dp row's copy), in
        place: the optimizer holds the live tensors."""
        saved, live = aux_leaves(aux), aux_leaves(self.aux)
        if set(saved) != set(live):
            raise ValueError(f"aux leaves {sorted(saved)}, the trainer has {sorted(live)}")
        self.model.load_state_dict(params)
        with torch.no_grad():
            for row in self._aux_rows:
                for name, t in aux_leaves(row).items():
                    t.copy_(saved[name])


def clip_by_global_norm(params: Sequence[torch.Tensor], max_norm: float) -> None:
    """optax.clip_by_global_norm on the parameters' `.grad`, in place: keep
    the gradients when their global norm is below max_norm, else scale them
    by max_norm / norm."""
    clip_grad_groups([[p] for p in params], max_norm)


def clip_grad_groups(groups: Sequence[Sequence[torch.Tensor]], max_norm: float) -> None:
    """`clip_by_global_norm` of a tree whose leaves have copies: each group
    holds the copies of one leaf (equal gradients, `sum_grads`), the norm
    counts each leaf once (its first copy, on the first leaf's device), and
    every copy is scaled by the same factor, so copies stay bit-equal."""
    grads = [g[0].grad for g in groups if g[0].grad is not None]
    if not grads:
        return
    dev = grads[0].device
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g.float()).to(dev) for g in grads]))
    keep = norm < max_norm
    on = {}
    for group in groups:
        for p in group:
            g = p.grad
            if g is None:
                continue
            n, k = on.setdefault(g.device, (norm.to(g.device), keep.to(g.device)))
            g.copy_(torch.where(k, g, g / n.to(g.dtype) * max_norm))


def aux_leaves(aux: dict) -> dict:
    """{"pos_weights": t, "heads.0.w": t, ...}: the aux tensors by name."""
    out = {}
    if "pos_weights" in aux:
        out["pos_weights"] = aux["pos_weights"]
    for i, h in enumerate(aux.get("heads", [])):
        out.update({f"heads.{i}.{k}": v for k, v in h.items()})
    return out


def _clone_aux(aux: dict, device=None) -> dict:
    """A deep copy of `aux` (head lists included), detached, on `device`
    (aux's own by default)."""
    def copy(t):
        return t.detach().clone() if device is None else t.detach().to(device, copy=True)

    out = {}
    if "pos_weights" in aux:
        out["pos_weights"] = copy(aux["pos_weights"])
    if "heads" in aux:
        out["heads"] = [{k: copy(v) for k, v in h.items()} for h in aux["heads"]]
    return out
