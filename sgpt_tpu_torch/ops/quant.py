"""Int8 inference: per-output-channel int8 weights × dynamic per-token int8
activations (counterpart of `sgpt_tpu/ops/quant.py`).

The JAX scheme, operation for operation:

  * weights: one scale per output channel, s_w = max(max|w| / 127, 1e-8)
    over the contraction axis, q = round(w / s_w) as int8; quantized once,
    at load time;
  * activations: the same per row (token), computed at each call;
  * the int8 × int8 product accumulates in int32; the result is
    (y · s_x) · s_w in fp32, cast back to the input's dtype.

`torch.round` rounds half to even, as `jnp.round` does, and every step keeps
the JAX order of operations, so the int8 values and the scales equal the
JAX package's bit for bit. The JAX package runs these functions compiled
(`quantize_decoder_params` under `jax.jit`, `int8_project` inside the jitted
forward), where XLA turns the division by the constant 127 into a product
with its fp32 reciprocal: the port multiplies by that reciprocal too.

Layout: a quantized weight keeps torch's [out, in] layout, q (F, D) int8 and
s (F, 1) fp32: the JAX leaf {"q": (D, F), "s": (1, F)} transposed. In a
`Decoder` it is a `QuantizedWeight` module (two buffers) in place of the
float parameter. Embeddings, LayerNorms, biases and the LM head stay float.

The int32 product: on a CUDA tensor `torch._int_mm` (cuBLASLt's int8 GEMM;
the JAX package computes it with XLA's `dot_general`, outside any Pallas
kernel), which wants more than 16 rows and inner and outer sizes that are
multiples of 8: a short micro-batch is padded with zero rows, and any other
shape raises. On a CPU tensor it is the plain version, the same product
computed exactly in fp64 (|sum| ≤ 127² · D < 2^53), which is also the
card's oracle. Quantized models are for inference only.
"""
from __future__ import annotations

import copy
import itertools
from typing import Mapping, Optional

import numpy as np
import torch
from torch import nn

_EPS = 1e-8
_INV127 = float(np.float32(1.0) / np.float32(127.0))  # XLA's folded 1 / 127 in fp32
_ATTN_KERNELS = ("wq", "wk", "wv", "wo")
_MLP_KERNELS = ("wi", "wo")
_INT_MM_MIN_ROWS = 17   # torch._int_mm on CUDA: more than 16 rows
_INT_MM_ALIGN = 8       # ... and inner and outer sizes that are multiples of 8
_SLAB_ROWS = 1024       # output channels quantized at a time: bounds the fp32 copy

# `torch._int_mm` launches of `int8_matmul` (CUDA tensors only)
launches = 0


class QuantizedWeight(nn.Module):
    """An int8 projection weight in torch's [out, in] layout: buffers q (F,
    D) int8 and s (F, 1) fp32 scales. `w["q"]` and `w["s"]` read them by the
    JAX leaf's keys."""

    def __init__(self, q: torch.Tensor, s: torch.Tensor):
        super().__init__()
        self.register_buffer("q", q)
        self.register_buffer("s", s)

    def __getitem__(self, key: str) -> torch.Tensor:
        if key not in ("q", "s"):
            raise KeyError(key)
        return getattr(self, key)


def is_quantized(w) -> bool:
    return isinstance(w, QuantizedWeight) or (
        isinstance(w, Mapping) and "q" in w and "s" in w)


@torch.no_grad()
def quantize_weight(w: torch.Tensor, contract_axis: int = -1) -> dict:
    """Symmetric per-output-channel int8 quantization: {"q": int8 of w's
    shape, "s": fp32 scales with the contraction axis kept at size 1},
    s = max(max|w| · (1/127), 1e-8) and q = round(w / s).

    contract_axis: the axis the product contracts over (the scales span every
    other axis); -1 for the port's [out, in] weights, 0 for a JAX (D, F)
    weight, 1 for a stacked JAX (L, D, F) kernel. The fp32 copy is made a
    slab at a time (1,024 output channels of a 2-D weight, one layer of a
    stacked one), never for the whole weight."""
    wt = w.detach().movedim(contract_axis, -1)
    qt = torch.empty(wt.shape, dtype=torch.int8, device=w.device)
    st = torch.empty((*wt.shape[:-1], 1), dtype=torch.float32, device=w.device)
    step = _SLAB_ROWS if wt.dim() == 2 else 1
    for i in range(0, wt.shape[0], step):
        w32 = wt[i:i + step].to(torch.float32, copy=True)
        s = torch.clamp_min(w32.abs().amax(dim=-1, keepdim=True) * _INV127, _EPS)
        qt[i:i + step] = w32.div_(s).round_()   # in place; |w| / s ≤ 127 by construction
        st[i:i + step] = s
        del w32
    return {"q": qt.movedim(-1, contract_axis).contiguous(),
            "s": st.movedim(-1, contract_axis).contiguous()}


def _absmax(x: torch.Tensor) -> torch.Tensor:
    """max|x| of each row, in x's dtype (exact), (M, 1)."""
    return torch.linalg.vector_norm(x, ord=float("inf"), dim=-1, keepdim=True)


def _quantize_rows(x: torch.Tensor, absmax: torch.Tensor):
    sx = torch.clamp_min(absmax.float() * _INV127, _EPS)
    return torch.div(x, sx).round_().to(torch.int8), sx


def quantize_activations(x: torch.Tensor):
    """Per-row dynamic quantization of (M, D) activations: (int8 rows,
    fp32 (M, 1) scales), the JAX arithmetic. max|x| is taken in x's dtype
    (exact) and x / s_x promotes x to fp32 exactly, so no fp32 copy of x is
    made before the division."""
    return _quantize_rows(x, _absmax(x))


def int8_matmul_reference(a: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """The plain version: a (M, D) int8 times q (F, D) int8 transposed, exact
    in fp64, as (M, F) int32."""
    return (a.double() @ q.double().T).to(torch.int32)


def int8_matmul(a: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """a (M, D) int8 @ q (F, D)ᵀ int8 → (M, F) int32. On a CUDA tensor
    `torch._int_mm`, short batches padded to its 17-row minimum; on a CPU
    tensor the plain version."""
    global launches
    if a.device.type != "cuda":
        return int8_matmul_reference(a, q)
    M, D = a.shape
    F = q.shape[0]
    if D % _INT_MM_ALIGN or F % _INT_MM_ALIGN:
        raise ValueError(f"int8_matmul: torch._int_mm needs inner and outer sizes that are "
                         f"multiples of {_INT_MM_ALIGN}; got D={D}, F={F}")
    if M < _INT_MM_MIN_ROWS:
        a = torch.cat([a, a.new_zeros((_INT_MM_MIN_ROWS - M, D))])
    out = torch._int_mm(a.contiguous(), q.t())
    launches += 1
    return out[:M]


def int8_project(x: torch.Tensor, qw) -> torch.Tensor:
    """x @ Wᵀ for a quantized W ({"q": (F, D) int8, "s": (F, 1) fp32}, or a
    `QuantizedWeight`): x (..., D) float → (..., F) in x's dtype. The
    activations are quantized per row (token) at each call."""
    lead, D = x.shape[:-1], x.shape[-1]
    qx, sx = quantize_activations(x.reshape(-1, D))
    acc = int8_matmul(qx, qw["q"])
    y = torch.mul(acc, sx).mul_(qw["s"].reshape(1, -1))   # (y · s_x) · s_w in fp32
    return y.to(x.dtype).reshape(*lead, -1)


def int8_project_row_parallel(xs, qws) -> list:
    """`int8_project` of a row-parallel (contraction-sharded) weight over tp
    shards: xs[j] (..., D/tp) and qws[j] shard j's columns of q (F, D/tp)
    with the whole scales s (F, 1), one pair a shard, each on its device.

    The JAX product of a sharded quantized leaf, as XLA partitions it: each
    token's scale comes from its whole row (the maximum over the shards of
    their maxima, exact), each shard quantizes its columns with it, the
    shards' int32 products are summed (exactly), then rescaled by s_x · s.
    So the result equals the unsharded `int8_project`. Returns one
    (..., F) tensor in x's dtype a shard, on its device."""
    from ..parallel.collectives import all_reduce_max, all_reduce_sum

    lead = xs[0].shape[:-1]
    flat = [x.reshape(-1, x.shape[-1]) for x in xs]
    amax = all_reduce_max([_absmax(x) for x in flat])
    quant = [_quantize_rows(x, a) for x, a in zip(flat, amax)]
    acc = all_reduce_sum([int8_matmul(qx, qw["q"]) for (qx, _), qw in zip(quant, qws)])
    return [torch.mul(a, sx).mul_(qw["s"].reshape(1, -1)).to(x.dtype).reshape(*lead, -1)
            for a, (_, sx), qw, x in zip(acc, quant, qws, xs)]


def quantize_decoder_params(model: nn.Module, *, free_source: bool = False) -> nn.Module:
    """Quantize the per-layer projections (the attention's wq wk wv wo, the
    MLP's wi wo) of a `Decoder`: each becomes a `QuantizedWeight`.

    free_source=False (the default): returns a new module and leaves the
    caller's untouched; the two share every tensor that stays float. Peak
    device memory: the float total, the int8 total and one slab.
    free_source=True: quantizes the module given, in place, freeing each
    float weight as soon as its int8 copy exists, one weight after another,
    so memory only goes down (peak: the float total plus one slab). The
    source is destroyed; pass only a model you own (a freshly loaded one, as
    the CLIs do)."""
    if not free_source:
        shared = {id(t): t for t in itertools.chain(model.parameters(), model.buffers())}
        model = copy.deepcopy(model, shared)
    for layer in model.layers:
        for sub, names in ((layer.attn, _ATTN_KERNELS), (layer.mlp, _MLP_KERNELS)):
            for name in names:
                w = getattr(sub, name)
                if w is None or is_quantized(w):
                    continue
                qw = quantize_weight(w)
                delattr(sub, name)   # with free_source, the last reference but `w`
                del w
                setattr(sub, name, QuantizedWeight(qw["q"], qw["s"]))
    return model


def quantized_copy(model: nn.Module, quantize: Optional[str]) -> nn.Module:
    """The engine's and the ranker's `quantize=` argument: the model itself
    for None, an int8 copy for "int8"; any other mode raises ValueError."""
    if quantize not in (None, "int8"):
        raise ValueError(f"unknown quantize mode {quantize!r}; supported: 'int8'")
    return model if quantize is None else quantize_decoder_params(model)


def is_quantized_model(model: nn.Module) -> bool:
    return any(isinstance(m, QuantizedWeight) for m in model.modules())


def dequantize_weight(qw) -> np.ndarray:
    """The float weight q · s (for tests and error analysis)."""
    return qw["q"].cpu().numpy().astype(np.float32) * qw["s"].cpu().numpy().astype(np.float32)
