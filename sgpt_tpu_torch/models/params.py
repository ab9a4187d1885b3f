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


def param_shapes(cfg: DecoderConfig) -> Dict[str, Tuple[int, ...]]:
    """Name → shape of every parameter of the GPT-Neo-style decoder."""
    D, F, L = cfg.hidden_size, cfg.mlp_size, cfg.num_layers
    P = cfg.num_heads * cfg.head_size
    shapes = {"wte": (cfg.vocab_size, D), "wpe": (cfg.max_position_embeddings, D),
              "ln_f.scale": (D,), "ln_f.bias": (D,)}
    for i in range(L):
        p = f"layers.{i}."
        for ln in ("ln1", "ln2"):
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
    return shapes


def init_params(cfg: DecoderConfig,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
    """Random init with the JAX package's distribution: weights 0.02·N(0, 1),
    LayerNorm scales 1, biases 0. Drawn in float32 on the CPU from
    `generator`, so one seed gives the same weights on every device."""
    out = {}
    for name, shape in param_shapes(cfg).items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "scale":
            out[name] = torch.ones(shape)
        elif leaf.startswith("b"):
            out[name] = torch.zeros(shape)
        else:
            out[name] = 0.02 * torch.randn(shape, generator=generator)
    return out


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
    weight from [in, out] to [out, in]. Raises on a leaf it does not consume
    (e.g. another family's tensors), so nothing is dropped silently, on a
    missing one, and on an int8 `{"q", "s"}` leaf or an `lm_head` (not
    ported yet)."""
    flat = _flatten(tree)
    if any(name.startswith("lm_head.") for name in flat):
        # GPT-Neo ties its head to wte; the families with their own head are not ported
        raise ValueError("params_from_jax: leaf lm_head not consumed: a separate LM head "
                         "(GPT-J, BLOOM) is not ported yet — ROADMAP Queue 1 item 3")
    sd = {}
    for name, shape in param_shapes(cfg).items():
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
