"""Parameter state dicts for the port's decoder (counterpart of `sgpt_tpu/models/params.py`).

Layout: one entry per layer (`layers.{i}.…`, no stacked layer axis) and
linear weights in torch's [out, in] order. The JAX tree stacks layers on a
leading axis and stores linear weights [in, out]; `params_from_jax` converts.
An int8 projection (`ops/quant.py`) is two entries, `<name>.q` (int8, [out,
in]) and `<name>.s` (fp32 scales, (out, 1)). `tsdae_from_jax` and
`head_from_jax` carry the trainers' tensors outside the decoder (TSDAE's
conditioning projections, the trainable cross-encoder's head) in their JAX
layout.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .config import DecoderConfig


def param_shapes(cfg: DecoderConfig, lm_head: Tuple[str, ...] = ()) -> Dict[str, Tuple[int, ...]]:
    """Name → shape of every parameter of the decoder, as the JAX
    `param_shapes` lays the tree out: `wpe` only for learned positions,
    `wtt` with `token_type_vocab`, `rel_bias` (buckets, H) with
    `relative_attention`, `emb_ln` with `embedding_layernorm`, no `ln2`
    under `parallel_residual`, no `ln_f` under `post_layernorm`, a `scale`
    and no `bias` for each RMSNorm (`norm_style="rms"`), q/k/v biases with
    `qkv_bias`, `mlp.wg` for `gated_gelu`, no MLP biases without
    `mlp_bias`. lm_head: the leaves of a separate LM head ("w", and "b" for
    a biased one: GPT-J's); () ties the head to `wte`."""
    D, F, L = cfg.hidden_size, cfg.mlp_size, cfg.num_layers
    P = cfg.num_heads * cfg.head_size
    norm = ("scale",) if cfg.norm_style == "rms" else ("scale", "bias")
    shapes = {"wte": (cfg.vocab_size, D)}
    if cfg.position_embedding == "learned":
        shapes["wpe"] = (cfg.max_position_embeddings, D)
    if cfg.token_type_vocab:
        shapes["wtt"] = (cfg.token_type_vocab, D)
    if cfg.relative_attention:
        shapes["rel_bias"] = (cfg.relative_attention_buckets, cfg.num_heads)
    if cfg.embedding_layernorm:
        shapes["emb_ln.scale"] = (D,)
        shapes["emb_ln.bias"] = (D,)
    if not cfg.post_layernorm:
        for leaf in norm:
            shapes["ln_f." + leaf] = (D,)
    for i in range(L):
        p = f"layers.{i}."
        for ln in ("ln1",) if cfg.parallel_residual else ("ln1", "ln2"):
            for leaf in norm:
                shapes[p + ln + "." + leaf] = (D,)
        for w in ("wq", "wk", "wv"):
            shapes[p + "attn." + w] = (P, D)
        shapes[p + "attn.wo"] = (D, P)
        if cfg.qkv_bias:
            for b in ("bq", "bk", "bv"):
                shapes[p + "attn." + b] = (P,)
        if cfg.out_bias:
            shapes[p + "attn.bo"] = (D,)
        shapes[p + "mlp.wi"] = (F, D)
        if cfg.mlp_activation == "gated_gelu":
            shapes[p + "mlp.wg"] = (F, D)
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


# 2-D leaves that are tables, not linear weights: the same layout on both sides
TABLES = ("wte", "wpe", "wtt", "rel_bias")


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
    """Leaf name → array; an int8 {"q", "s"} leaf gives `<name>.q` and `<name>.s`."""
    flat = {}
    for k, v in tree.items():
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
    D)); the tables (`wte`, `wpe`, `wtt`, `rel_bias`) keep their layout. A separate LM head (`lm_head.w`, optionally `lm_head.b`) is kept.
    A projection quantized by the JAX `quantize_decoder_params` ({"q": (L,
    D, F) int8, "s": (L, 1, F)}) gives `<name>.q` (F, D) and `<name>.s` (F,
    1) for each layer, which `Decoder(weights=...)` takes as int8. Raises on
    a leaf it does not consume (e.g. another family's tensors), so nothing
    is dropped silently, and on a missing one."""
    flat = _flatten(tree)
    head = tuple(leaf for leaf in ("w", "b") if f"lm_head.{leaf}" in flat)
    sd = {}
    for name, shape in param_shapes(cfg, head).items():
        if name.startswith("layers."):
            _, i, rest = name.split(".", 2)
            src = "layers." + rest
            if src + ".q" in flat and src + ".s" in flat:
                q = _to_torch(flat[src + ".q"][int(i)])
                if q.dim() != 2 or tuple(q.shape[::-1]) != shape:
                    raise ValueError(f"{name}: int8 leaf of shape {tuple(q.shape)}, "
                                     f"expected {shape[::-1]}")
                sd[name + ".q"] = q.T.contiguous()
                sd[name + ".s"] = _to_torch(flat[src + ".s"][int(i)]).float().T.contiguous()
                continue
            if src not in flat:
                raise KeyError(f"JAX tree has no leaf {src!r}")
            arr = _to_torch(flat[src][int(i)])
        else:
            if name not in flat:
                raise KeyError(f"JAX tree has no leaf {name!r}")
            arr = _to_torch(flat[name])
        if len(shape) == 2 and name not in TABLES:
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


def tsdae_from_jax(tsdae: dict) -> Dict[str, torch.Tensor]:
    """The JAX `TSDAETrainer`'s conditioning projections (`tree["tsdae"]`:
    {"w": (L, D, D), "b": (L, D)}) → fp32 CPU tensors in the same layout:
    both sides apply them as cond @ w[l] + b[l], so nothing is transposed.
    Raises on another key set."""
    if set(tsdae) != {"w", "b"}:
        raise ValueError(f"tsdae_from_jax: expected leaves w and b, got {sorted(tsdae)}")
    w, b = _to_torch(tsdae["w"]).float(), _to_torch(tsdae["b"]).float()
    if w.dim() != 3 or w.shape[1] != w.shape[2] or tuple(b.shape) != tuple(w.shape[:2]):
        raise ValueError(f"tsdae_from_jax: w {tuple(w.shape)}, b {tuple(b.shape)}; "
                         "expected (L, D, D) and (L, D)")
    return {"w": w, "b": b}


def head_from_jax(head_w, head_b) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX `CrossEncoderTrainable`'s classification head (w (D,
    num_labels), b (num_labels,)) → fp32 CPU tensors in the same (in, out)
    layout, applied as rep @ w + b on both sides."""
    w, b = _to_torch(head_w).float(), _to_torch(head_b).float()
    if w.dim() != 2 or tuple(b.shape) != (w.shape[1],):
        raise ValueError(f"head_from_jax: w {tuple(w.shape)}, b {tuple(b.shape)}; "
                         "expected (D, num_labels) and (num_labels,)")
    return w, b
