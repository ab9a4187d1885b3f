"""Parameter state dicts for the port's decoder (counterpart of `sgpt_tpu/models/params.py`).

Layout: one entry per layer (`layers.{i}.…`, no stacked layer axis) and
linear weights in torch's [out, in] order. The JAX tree stacks layers on a
leading axis and stores linear weights [in, out]; `params_from_jax` converts.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .config import DecoderConfig


def param_shapes(cfg: DecoderConfig, lm_head: Tuple[str, ...] = ()) -> Dict[str, Tuple[int, ...]]:
    """Name → shape of every parameter of the decoder, as the JAX
    `param_shapes` lays the tree out: `wpe` only for learned positions,
    `emb_ln` with `embedding_layernorm`, no `ln2` under `parallel_residual`,
    q/k/v biases with `qkv_bias`. lm_head: the leaves of a separate LM head
    ("w", and "b" for a biased one: GPT-J's); () ties the head to `wte`."""
    D, F, L = cfg.hidden_size, cfg.mlp_size, cfg.num_layers
    P = cfg.num_heads * cfg.head_size
    shapes = {"wte": (cfg.vocab_size, D)}
    if cfg.position_embedding == "learned":
        shapes["wpe"] = (cfg.max_position_embeddings, D)
    if cfg.embedding_layernorm:
        shapes["emb_ln.scale"] = (D,)
        shapes["emb_ln.bias"] = (D,)
    shapes["ln_f.scale"] = (D,)
    shapes["ln_f.bias"] = (D,)
    for i in range(L):
        p = f"layers.{i}."
        for ln in ("ln1",) if cfg.parallel_residual else ("ln1", "ln2"):
            shapes[p + ln + ".scale"] = (D,)
            shapes[p + ln + ".bias"] = (D,)
        for w in ("wq", "wk", "wv"):
            shapes[p + "attn." + w] = (P, D)
        shapes[p + "attn.wo"] = (D, P)
        if cfg.qkv_bias:
            for b in ("bq", "bk", "bv"):
                shapes[p + "attn." + b] = (P,)
        if cfg.out_bias:
            shapes[p + "attn.bo"] = (D,)
        shapes[p + "mlp.wi"] = (F, D)
        shapes[p + "mlp.wo"] = (D, F)
        if cfg.mlp_bias:
            shapes[p + "mlp.bi"] = (F,)
            shapes[p + "mlp.bo"] = (D,)
    if set(lm_head) - {"w", "b"} or (lm_head and "w" not in lm_head):
        raise ValueError(f"lm_head leaves {lm_head}: expected (), ('w',) or ('w', 'b')")
    if "w" in lm_head:
        shapes["lm_head.w"] = (cfg.vocab_size, D)
    if "b" in lm_head:
        shapes["lm_head.b"] = (cfg.vocab_size,)
    return shapes


def _kind(name: str) -> str:
    """"ones" (LayerNorm scales), "zeros" (biases) or "normal" (weights)."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "scale":
        return "ones"
    return "zeros" if leaf.startswith("b") else "normal"


def init_params(cfg: DecoderConfig, generator: Optional[torch.Generator] = None,
                lm_head: Tuple[str, ...] = ()) -> Dict[str, torch.Tensor]:
    """Random init with the JAX package's distribution: weights 0.02·N(0, 1),
    LayerNorm scales 1, biases 0, for `param_shapes(cfg, lm_head)`. Drawn in
    float32 on the CPU from `generator`, so one seed gives the same weights
    on every device."""
    out = {}
    for name, shape in param_shapes(cfg, lm_head).items():
        kind = _kind(name)
        if kind == "ones":
            out[name] = torch.ones(shape)
        elif kind == "zeros":
            out[name] = torch.zeros(shape)
        else:
            out[name] = 0.02 * torch.randn(shape, generator=generator)
    return out


@torch.no_grad()
def init_params_(params: Dict[str, torch.Tensor], generator: torch.Generator) -> None:
    """`init_params`' distribution drawn in place into existing tensors, on
    their device and in their dtype, from `generator` (which must lie on that
    device): no host copy. Weights are N(0, 1) drawn in the tensor's dtype
    and scaled by 0.02 there, so they differ from `init_params`' numbers."""
    for name, t in params.items():
        kind = _kind(name)
        if kind == "ones":
            t.fill_(1)
        elif kind == "zeros":
            t.zero_()
        else:
            t.normal_(0.0, 1.0, generator=generator).mul_(0.02)


def _flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    flat = {}
    for k, v in tree.items():
        if isinstance(v, dict) and set(v) == {"q", "s"}:
            raise NotImplementedError(
                f"{prefix}{k}: int8-quantized leaf — ROADMAP Queue 1 item 9")
        if isinstance(v, dict):
            flat.update(_flatten(v, f"{prefix}{k}."))
        else:
            flat[prefix + k] = v
    return flat


def _to_torch(arr) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.kind == "V" or arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)  # numpy's bfloat16 extension type
    return torch.from_numpy(arr.copy())  # a writable, contiguous copy


def params_from_jax(tree: dict, cfg: DecoderConfig) -> Dict[str, torch.Tensor]:
    """JAX parameter tree (nested dicts of numpy-convertible arrays) → state dict.

    Unstacks the leading layer axis of `layers.*` and transposes every linear
    weight from [in, out] to [out, in] (`lm_head.w` included: (D, V) → (V,
    D)). A separate LM head (`lm_head.w`, optionally `lm_head.b`) is kept.
    Raises on a leaf it does not consume (e.g. another family's tensors), so
    nothing is dropped silently, on a missing one, and on an int8 `{"q",
    "s"}` leaf."""
    flat = _flatten(tree)
    head = tuple(leaf for leaf in ("w", "b") if f"lm_head.{leaf}" in flat)
    sd = {}
    for name, shape in param_shapes(cfg, head).items():
        if name.startswith("layers."):
            _, i, rest = name.split(".", 2)
            src = "layers." + rest
            if src not in flat:
                raise KeyError(f"JAX tree has no leaf {src!r}")
            arr = _to_torch(flat[src][int(i)])
        else:
            if name not in flat:
                raise KeyError(f"JAX tree has no leaf {name!r}")
            arr = _to_torch(flat[name])
        if len(shape) == 2 and name not in ("wte", "wpe"):
            arr = arr.T.contiguous()
        if tuple(arr.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(arr.shape)}, expected {shape}")
        sd[name] = arr
    consumed = {n if not n.startswith("layers.") else "layers." + n.split(".", 2)[2]
                for n in sd}
    left = sorted(set(flat) - consumed)
    if left:
        raise ValueError(f"params_from_jax: leaves not consumed: {left}")
    return sd


def aux_from_jax(aux: dict) -> Dict[str, object]:
    """The JAX trainer's auxiliary parameters (`ContrastiveTrainer.aux`:
    `pos_weights` and `heads`, a list of {"w", ["b"]}) → the port trainer's
    `aux` layout, as fp32 CPU tensors. A dense head's `w` keeps the JAX
    (in, out) layout, applied as `h @ w` on both sides (`encoder.apply_heads`),
    not transposed to `nn.Linear`'s (out, in). Raises on an unknown key."""
    left = set(aux) - {"pos_weights", "heads"}
    if left:
        raise ValueError(f"aux_from_jax: unknown aux keys {sorted(left)}")
    out: Dict[str, object] = {}
    if "pos_weights" in aux:
        out["pos_weights"] = _to_torch(aux["pos_weights"]).float()
    if "heads" in aux:
        heads = []
        for i, h in enumerate(aux["heads"]):
            if set(h) - {"w", "b"} or "w" not in h:
                raise ValueError(f"aux_from_jax: head {i} has leaves {sorted(h)}")
            heads.append({k: _to_torch(v).float() for k, v in h.items()})
        out["heads"] = heads
    return out
