"""Megatron tensor parallelism and dp replication of the decoder, and row
sharding of a corpus (counterpart of `sgpt_tpu/parallel/sharding.py`).

`param_specs` is the JAX rule, leaf by leaf, in the port's layout: the port
stores an `F.linear` weight as (out, in), so the JAX kernel's column axis
is the port's row axis.

  * attention q/k/v and the MLP's wi: output axis sharded (column parallel),
    with their biases; int8 scales follow these column shards
  * attention and MLP wo: input axis sharded (row parallel); their biases,
    and the int8 scales of a row-parallel weight, stay whole (the bias is
    added, and the rescale done, after the sum over the shards)
  * wte, wpe: hidden axis sharded; the LM head: vocab axis sharded
  * LayerNorms, the other biases, token types, T5's relative bias, the
    gated MLP's wg: whole on every shard

A spec is a tuple with one entry per axis of the port's tensor: "tp" on the
sharded axis, None elsewhere. `shard_params` cuts a `Decoder` by these
specs over a `Mesh`: dp row i holds a `TPGroup` (`models/decoder.py`) whose
shard j lives on `mesh.devices[i, j]`. For training (`trainable=True`) every
piece is a fresh trainable copy; `unshard_params` (and the sharded model's
`state_dict`) concatenates dp row 0's pieces back into the meshless tree,
bit for bit, and `load_state_dict` cuts a meshless tree into every shard in
place.
"""
from __future__ import annotations

import copy
import itertools
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .collectives import gather_rows
from .mesh import Mesh

Spec = Tuple[Optional[str], ...]

_COLUMN = ("wq", "wk", "wv", "wi")
_BIASES = ("bq", "bk", "bv", "bi")
_KERNELS = ("wq", "wk", "wv", "wo", "wi")


def _spec(name: str, ndim: int) -> Spec:
    keys = name.split(".")
    leaf = keys[-1]
    if leaf in ("q", "s") and len(keys) >= 2 and keys[-2] in _KERNELS:
        # an int8 QuantizedWeight's buffers: q (F, D) takes the float
        # weight's spec; the scales s (F, 1) follow column shards and stay
        # whole for a row-parallel weight
        kind, leaf = leaf, keys[-2]
        if kind == "s":
            return ("tp", None) if leaf in _COLUMN else (None, None)
    if leaf in _COLUMN:                               # (out, D): column parallel
        return ("tp", None)
    if leaf == "wo" and ("attn" in keys or "mlp" in keys):   # (D, in): row parallel
        return (None, "tp")
    if leaf in _BIASES:                               # follow the column shards
        return ("tp",)
    if leaf in ("wte", "wpe") and len(keys) == 1:     # (V|P, D): hidden axis
        return (None, "tp")
    if leaf == "w" and keys[0] == "lm_head":          # (V, D): vocab axis
        return ("tp", None)
    return (None,) * ndim


def param_specs(model: nn.Module) -> Dict[str, Spec]:
    """{state-dict name: spec} of a `Decoder` (int8 buffers included)."""
    return {name: _spec(name, t.dim()) for name, t in model.state_dict().items()}


def data_spec(ndim: int = 2) -> Spec:
    """Batch-sharded activation/data spec: (batch over dp, rest whole)."""
    return ("dp",) + (None,) * (ndim - 1)


def _piece(t: torch.Tensor, spec: Spec, j: int, tp: int, name: str) -> torch.Tensor:
    """Shard j of tp of t by spec."""
    for axis, ax in enumerate(spec):
        if ax == "tp":
            n = t.shape[axis]
            if n % tp:
                raise ValueError(f"shard_params: {name} has {n} along its sharded axis "
                                 f"{axis}, not divisible by tp={tp}")
            return t.narrow(axis, j * (n // tp), n // tp)
    return t


def _shard_module(model: nn.Module, specs: Dict[str, Spec], j: int, tp: int,
                  device: torch.device, trainable: bool = False) -> nn.Module:
    """A copy of `model` whose every parameter and buffer is its shard j of
    tp, on `device`. For inference a piece already on `device` and
    contiguous is not copied (a replica on the model's own device shares
    its storage) and any other piece is copied there; with `trainable`
    every piece is a fresh copy whose parameters require grad."""
    shared = {id(t): t for t in itertools.chain(model.parameters(), model.buffers())}
    shard = copy.deepcopy(model, shared)
    for mod_name, mod in shard.named_modules():
        prefix = mod_name + "." if mod_name else ""
        for store in (mod._parameters, mod._buffers):
            for leaf, t in list(store.items()):
                if t is None:
                    continue
                name = prefix + leaf
                piece = _piece(t.detach(), specs[name], j, tp, name).to(device)
                piece = (piece.clone(memory_format=torch.contiguous_format) if trainable
                         else piece.contiguous())
                store[leaf] = (nn.Parameter(piece, requires_grad=trainable)
                               if store is mod._parameters else piece)
    return shard.train(trainable)


class ShardedDecoder:
    """A `Decoder` sharded over a (dp, tp) mesh: `groups[i]` is dp row i's
    `TPGroup` (its tp shards, shard j on `mesh.devices[i, j]`; with tp=1 a
    replica of the model). The engine and the ranker split a batch's rows
    over the groups themselves; calling this object does the same for one
    batch (rows split contiguously over dp, results gathered on the inputs'
    device in row order). With `trainable` every shard owns fresh trainable
    copies of its pieces (`parallel.shard_params(..., trainable=True)`, the
    trainer's): then the copies of one piece in the dp rows, and of a whole
    leaf in every shard, are separate tensors that training keeps equal."""

    def __init__(self, model: nn.Module, mesh: Mesh, trainable: bool = False):
        from ..models.decoder import TPGroup

        self.cfg = model.cfg
        self.mesh = mesh
        self.specs = param_specs(model)
        dp, tp = mesh.shape["dp"], mesh.shape["tp"]
        self.groups = [TPGroup([_shard_module(model, self.specs, j, tp, mesh.devices[i, j],
                                              trainable)
                                for j in range(tp)]) for i in range(dp)]

    @property
    def device(self) -> torch.device:
        """The first shard's device: where a caller's batch starts and ends."""
        return self.groups[0].device

    def __call__(self, input_ids, attention_mask, **kw):
        return self.forward(input_ids, attention_mask, **kw)

    def forward(self, input_ids, attention_mask, *, output_hidden_states: bool = False,
                **kw) -> torch.Tensor:
        """`Decoder.forward`, rows split over dp (per-row keyword tensors
        with them; (T,) positions go to every row)."""
        lead = input_ids if input_ids is not None else kw["inputs_embeds"]
        B, dev = lead.shape[0], lead.device
        bounds = np.linspace(0, B, len(self.groups) + 1).round().astype(int)
        args = dict(kw, input_ids=input_ids, attention_mask=attention_mask)
        outs = []
        for g, a, b in zip(self.groups, bounds[:-1], bounds[1:]):
            if a == b:
                continue
            rows = {k: None if t is None else
                    (t[a:b] if t.dim() >= 2 and t.shape[0] == B else t).to(g.device)
                    for k, t in args.items()}
            outs.append(g(rows.pop("input_ids"), rows.pop("attention_mask"),
                          output_hidden_states=output_hidden_states, **rows))
        return torch.cat([o.to(dev) for o in outs], dim=1 if output_hidden_states else 0)

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """The LM head of dp row 0's group (on its devices)."""
        return self.groups[0].logits(hidden.to(self.device))

    def train(self, mode: bool = True) -> "ShardedDecoder":
        for g in self.groups:
            for s in g.shards:
                s.train(mode)
        return self

    def state_dict(self, names: Optional[Iterable[str]] = None) -> Dict[str, torch.Tensor]:
        """The meshless state dict on `device`: each leaf's tp pieces of dp
        row 0 concatenated along its sharded axis (a whole leaf copied), in
        fresh tensors: bit for bit the tree that was sharded. `names`: only
        these leaves (a trainer's best-model snapshot of its trainable
        leaves)."""
        sds = [s.state_dict() for s in self.groups[0].shards]
        keep = None if names is None else set(names)
        out = {}
        for name, t in sds[0].items():
            if keep is not None and name not in keep:
                continue
            spec = self.specs[name]
            axis = spec.index("tp") if "tp" in spec else None
            out[name] = (t.detach().to(self.device, copy=True) if axis is None else
                         torch.cat([sd[name].detach().to(self.device) for sd in sds], axis))
        return out

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, torch.Tensor]) -> None:
        """Cut a meshless state dict by the specs into every shard, in place
        (the tensors, and an optimizer's hold on them, stay)."""
        tp = self.mesh.shape["tp"]
        for g in self.groups:
            for j, s in enumerate(g.shards):
                live = s.state_dict(keep_vars=True)
                if set(live) != set(state):
                    raise ValueError(f"load_state_dict: keys differ from the model's: "
                                     f"{sorted(set(live) ^ set(state))[:8]}")
                for name, t in live.items():
                    t.copy_(_piece(state[name], self.specs[name], j, tp, name))


def shard_params(model, mesh: Mesh, trainable: bool = False) -> ShardedDecoder:
    """`model` (a `Decoder`, float or int8) sharded over `mesh` by
    `param_specs`; a `ShardedDecoder` already on `mesh` comes back as it is.
    Quantize before sharding (the JAX CLIs' order): the int8 scales of a
    row-parallel weight span its whole contraction axis. `trainable`: every
    piece a fresh copy that requires grad (see `ShardedDecoder`)."""
    if isinstance(model, ShardedDecoder):
        if model.mesh != mesh:
            raise ValueError(f"shard_params: the model is sharded over {model.mesh}, "
                             f"not {mesh}")
        return model
    return ShardedDecoder(model, mesh, trainable)


def unshard_params(model: ShardedDecoder, device=None):
    """The inverse of `shard_params`: a meshless `Decoder` on `device` (the
    mesh's first by default) holding dp row 0's pieces concatenated leaf by
    leaf along `param_specs`' axes: a round trip gives the weights bit for
    bit (int8 buffers included)."""
    from ..models.decoder import Decoder

    return Decoder(model.cfg, device=model.device if device is None else device,
                   weights=model.state_dict())


class RowShards:
    """A tensor cut into contiguous row blocks over a mesh's dp axis: block i
    on `mesh.devices[i, 0]` (one copy a dp row: the single controller
    reads each row block once, so the tp devices of the row hold none).
    The counterpart of a JAX array placed with `data_spec` (P("dp", ...))."""

    def __init__(self, pieces: List[torch.Tensor]):
        self.pieces = list(pieces)

    @classmethod
    def put(cls, rows, mesh: Mesh, dtype: Optional[torch.dtype] = None) -> "RowShards":
        """Cut (N, ...) rows (a host array or a tensor), N a multiple of dp,
        into dp blocks on their devices, cast to dtype."""
        t = torch.from_numpy(np.ascontiguousarray(rows)) if isinstance(rows, np.ndarray) \
            else rows
        dp = mesh.shape["dp"]
        if t.shape[0] % dp:
            raise ValueError(f"RowShards: {t.shape[0]} rows do not split over dp={dp}")
        n = t.shape[0] // dp
        return cls([t[i * n:(i + 1) * n].to(dtype or t.dtype).to(mesh.devices[i, 0])
                    for i in range(dp)])

    @property
    def shape(self) -> torch.Size:
        return torch.Size((sum(p.shape[0] for p in self.pieces), *self.pieces[0].shape[1:]))

    def element_size(self) -> int:
        return self.pieces[0].element_size()

    def host(self) -> np.ndarray:
        """Every row on the host, in order (float rows as float32)."""
        return gather_rows(self.pieces)
