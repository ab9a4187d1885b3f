"""Transformer forward of every family (counterpart of `sgpt_tpu/models/decoder.py`).

Plain PyTorch: the layers are an `nn.ModuleList` walked by a Python loop.
One forward serves, by config flags, as the JAX `_forward_impl` does:

  * the GPT families: GPT-Neo (learned positions, unscaled scores, global
    and local (windowed) layers alternating), GPT-J (GPT-J's interleaved
    rotary on the leading `rotary_dim` of each head, 1/sqrt(Dh) scores, the
    parallel residual x + attn(ln1(x)) + mlp(ln1(x)), a separate biased LM
    head) and BLOOM (ALiBi with BLOOM's slopes, a LayerNorm on the
    embeddings, q/k/v biases); pre-LN blocks, tanh-GELU MLP, `ln_f`;
  * the encoder families: BERT (`bidirectional`, token-type embeddings
    `wtt` with `token_type_ids` defaulting to zeros, `post_layernorm`
    blocks x = ln1(x + attn(x)), x = ln2(x + mlp(x)) and no `ln_f`, erf
    GELU) and T5's encoder (`norm_style="rms"`: RMSNorm with fp32
    statistics and a scale only; `relative_attention`: T5's bucketed
    relative position bias from the one (buckets, H) table `rel_bias`,
    shared by every layer; unscaled scores; a ReLU or, for v1.1,
    `gated_gelu` MLP, tanh-GELU(wi·x)·(wg·x), with no biases);
  * CLIP's towers (`models/clip.py`): `quick_gelu` MLPs, h·sigmoid(1.702h);
    the vision tower passes `inputs_embeds` (no `input_ids`).

LayerNorm and RMSNorm keep fp32 statistics for any activation dtype.
`output_hidden_states` has HF semantics: the embeddings, the block outputs,
and last ln_f(last block output), or the last block's output itself for a
post-LN stack. The LM head is `Decoder.logits` (`lm_head` when the weights
have one, else tied to `wte`). A projection whose weight is int8
(`ops.quant.QuantizedWeight`) goes through `int8_project`, as the JAX
`_project` dispatches on a quantized leaf.

Attention routes by config and shape, as the JAX decoder does.
Bidirectional and relative-bias configs (BERT, T5, CLIP's vision tower)
take `plain_attention`, a copy of the JAX XLA `attention`: no Pallas kernel
computes them, so none of the port's kernels does either. Every causal
config without a relative bias takes, with `cfg.use_flash`, T % 128 == 0
and no packed rows (`segment_ids`), `ops.flash_attention` (K3 on a CUDA
tensor, and K4a/K4b for the backward when a gradient is needed), and
otherwise `ops.short_attention` (K1, and K2 for the backward); on a CPU
tensor both take their plain versions. Both wrappers refuse a call that is
not causal. ALiBi reaches both kernels as the slopes (K1 and K3 add
slope·key position to the scaled score); packed rows pass their
per-segment positions as K1's ALiBi key positions, unpacked rows use the
key index, which equals the JAX XLA path's cumsum(mask) − 1 on every valid
key of a right-padded row. TSDAE's decoder conditioning (`cond`,
`cond_params`) adds a per-layer projection of the sentence embedding to
each attention output, as the JAX forward does.

Under an `sp_mesh` (sequence parallelism, the JAX forward's `sp_mesh=`) T
is sharded over the mesh's dp devices: each holds its T/n positions through
every layer (LayerNorms, projections, MLP, with the weights copied there,
differentiably, where they do not live), and attention crosses the shards
as ring attention (`ops/ring_attention.py`); positions (learned, rotary,
ALiBi) stay global. No flash and no K1 run under sp, as in JAX.
"""
from __future__ import annotations

import functools
import math
import operator
from typing import Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.flash_attention import flash_attention
from ..ops.quant import QuantizedWeight, int8_project, int8_project_row_parallel, is_quantized
from ..ops.ring_attention import ring_attention_shards
from ..parallel.collectives import all_gather, all_reduce_sum, gather_to, reduce_sum_to
from ..ops.short_attention import short_attention
from .config import DecoderConfig
from .params import init_params, init_params_, param_shapes
from .precision import matmul_precision

NEG_INF = -1e9  # the JAX decoder's mask constant


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm with fp32 statistics regardless of activation dtype: for a
    bf16 input, PyTorch's kernel keeps the mean, the biased variance and the
    affine in fp32 and casts the result back, as the JAX `layer_norm` does."""
    return F.layer_norm(x, (x.shape[-1],), scale, bias, eps)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """T5's RMSNorm, written out in fp32 as the JAX `rms_norm` is: no mean
    subtraction, no bias, x·rsqrt(mean(x²) + eps)·scale, cast back."""
    x32 = x.float()
    var = x32.square().mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def rope_sincos(positions: torch.Tensor, rotary_dim: int):
    """GPT-J style sin/cos tables, repeat-interleaved by 2, in fp32.
    positions: (T,) shared across the batch, or (B, T) per-row (sequence
    packing restarts positions at each segment boundary)."""
    inv_freq = 1.0 / (10000.0 ** (torch.arange(0, rotary_dim, 2, dtype=torch.float32,
                                               device=positions.device) / rotary_dim))
    freqs = positions.float()[..., None] * inv_freq                        # (..., T, rd/2)
    return (torch.repeat_interleave(torch.sin(freqs), 2, dim=-1),          # (..., T, rd)
            torch.repeat_interleave(torch.cos(freqs), 2, dim=-1))


def _rotate_every_two(x: torch.Tensor) -> torch.Tensor:
    return torch.stack([-x[..., 1::2], x[..., ::2]], dim=-1).reshape(x.shape)


def apply_rotary(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor,
                 rotary_dim: int) -> torch.Tensor:
    """x: (B, T, H, Dh); rotary applied to the leading `rotary_dim` of Dh, in
    x's dtype (sin and cos cast to it, as the JAX `apply_rotary` casts them).
    sin/cos: (T, rd) batch-shared or (B, T, rd) per-row."""
    rot, rest = x[..., :rotary_dim], x[..., rotary_dim:]
    if sin.dim() == 2:
        sin, cos = sin[None], cos[None]
    sin = sin[:, :, None, :].to(rot.dtype)
    cos = cos[:, :, None, :].to(rot.dtype)
    rot = rot * cos + _rotate_every_two(rot) * sin
    return torch.cat([rot, rest], dim=-1)


def alibi_slopes(num_heads: int, device=None) -> torch.Tensor:
    """BLOOM's per-head ALiBi slopes (closest-power-of-two interpolation), fp32 (H,)."""
    cp2 = 2 ** math.floor(math.log2(num_heads))
    base = 2.0 ** (-(2.0 ** -(math.log2(cp2) - 3)))
    slopes = [base ** (i + 1) for i in range(cp2)]
    if cp2 != num_heads:
        extra_base = 2.0 ** (-(2.0 ** -(math.log2(2 * cp2) - 3)))
        slopes += [extra_base ** (i + 1) for i in range(0, 2 * (num_heads - cp2), 2)]
    return torch.tensor(slopes, dtype=torch.float32, device=device)


def check_token_ids(ids, vocab_size: int, name: str = "") -> None:
    """Refuse host token ids (a numpy array) outside [0, vocab_size): on the
    card an out-of-range embedding or gather index is a device assert that
    poisons the context, not an error."""
    if ids.size and (ids.min() < 0 or ids.max() >= vocab_size):
        raise ValueError(f"{name + ' ' if name else ''}token ids outside [0, {vocab_size}): "
                         f"min {ids.min()}, max {ids.max()} — tokenizer and model vocab "
                         "disagree")


_CHOICES = {
    "position_embedding": ("learned", "rotary", "alibi", "none"),
    "attention_layout": ("global", "alternating"),
    "norm_style": ("layer", "rms"),
    "mlp_activation": (None, "relu", "gated_gelu", "quick_gelu"),
}


def check_config(cfg: DecoderConfig) -> None:
    """Refuse a config flag value that the forward has no meaning for (the
    JAX forward would quietly take the default branch for it), and ALiBi or
    local layers on a config that takes the plain attention: no family has
    them, and the plain path implements neither."""
    for field, allowed in _CHOICES.items():
        if getattr(cfg, field) not in allowed:
            raise ValueError(f"DecoderConfig.{field}={getattr(cfg, field)!r}: "
                             f"expected one of {allowed}")
    if (cfg.bidirectional or cfg.relative_attention) and (
            cfg.position_embedding == "alibi" or any(cfg.local_flags())):
        raise ValueError("bidirectional or relative-bias attention with ALiBi or local "
                         "layers: no family has it, and the plain attention implements "
                         "neither")


def relative_buckets(T: int, num_buckets: int, max_distance: int,
                     bidirectional: bool) -> torch.Tensor:
    """(T, T) int64 bucket of each (query, key) pair, HF
    `T5Attention._relative_position_bucket` as the JAX `t5_relative_bias`
    computes it: half the buckets (bidirectional) split by the sign of
    key − query; within each half the first max_exact distances get their
    own bucket and larger ones a logarithmic bucket up to max_distance,
    from an fp32 log truncated to an integer. Computed on the CPU, so the
    table is the same whatever the device of the model."""
    ctx = torch.arange(T)
    rel = ctx[None, :] - ctx[:, None]                       # key - query
    nb = num_buckets
    bucket = torch.zeros((T, T), dtype=torch.int32)
    if bidirectional:
        nb = nb // 2
        bucket = bucket + (rel > 0).to(torch.int32) * nb
        rel_abs = rel.abs()
    else:
        rel_abs = torch.clamp(-rel, min=0)
    max_exact = nb // 2
    is_small = rel_abs < max_exact
    large = max_exact + (
        torch.log(torch.clamp(rel_abs, min=1).to(torch.float32) / max_exact)
        / math.log(max_distance / max_exact) * (nb - max_exact)
    ).to(torch.int32)
    large = torch.clamp(large, max=nb - 1)
    return (bucket + torch.where(is_small, rel_abs.to(torch.int32), large)).long()


@functools.lru_cache(maxsize=32)
def _bucket_index(T: int, num_buckets: int, max_distance: int, bidirectional: bool,
                  device: torch.device) -> torch.Tensor:
    """`relative_buckets` moved to `device` once per length (not once per
    forward: the copy of a host tensor waits for the device's queue); made
    outside inference mode, so that a training step may index with it."""
    with torch.inference_mode(False):
        return relative_buckets(T, num_buckets, max_distance, bidirectional).to(device)


def t5_relative_bias(rel_table: torch.Tensor, T: int, num_buckets: int,
                     max_distance: int, bidirectional: bool) -> torch.Tensor:
    """(1, H, T, T) fp32 additive bias from the (num_buckets, H) table; every
    T5 layer shares it."""
    idx = _bucket_index(T, num_buckets, max_distance, bidirectional, rel_table.device)
    return rel_table.float()[idx].permute(2, 0, 1)[None]


def mask_bias(attention_mask: torch.Tensor, T: int, *, causal: bool,
              segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, 1, T or 1, T) fp32 additive bias, 0 where a query may attend a
    key, -1e9 elsewhere (the JAX `_mask_bias`'s global bias): padding keys
    always, later keys when causal, other segments' keys with
    `segment_ids`."""
    dev = attention_mask.device
    ok = (attention_mask > 0)[:, None, None, :]                # (B, 1, 1, T)
    if causal:
        i = torch.arange(T, device=dev)
        ok = ok & (i[None, :] <= i[:, None])[None, None]
    if segment_ids is not None:
        ok = ok & (segment_ids[:, :, None] == segment_ids[:, None, :])[:, None]
    zero = torch.zeros((), device=dev)
    return torch.where(ok, zero, torch.full((), NEG_INF, device=dev))


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
                    H: int, scale_attn: bool) -> torch.Tensor:
    """The JAX XLA `attention` on (B, T, H·Dh) projections: fp32 scores,
    ÷ sqrt(Dh) when `scale_attn` (T5 is unscaled), + `bias` (the mask's,
    T5's relative bias folded in), fp32 softmax, probabilities cast to the
    activations' dtype before P·V."""
    B, T, HD = q.shape
    Dh = HD // H
    qh, kh, vh = (t.view(B, T, H, Dh).transpose(1, 2) for t in (q, k, v))
    scores = torch.matmul(qh.float(), kh.float().transpose(-1, -2))
    if scale_attn:
        scores = scores / math.sqrt(Dh)
    probs = torch.softmax(scores + bias, dim=-1).to(q.dtype)
    return torch.matmul(probs, vh).transpose(1, 2).reshape(B, T, HD)


def _empty(shape, factory: dict) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, **factory))


class LayerNorm(nn.Module):
    def __init__(self, D: int, eps: float, factory: dict):
        super().__init__()
        self.scale = _empty(D, factory)
        self.bias = _empty(D, factory)
        self.eps = eps

    def forward(self, x):
        return layer_norm(x, self.scale, self.bias, self.eps)


class RMSNorm(nn.Module):
    def __init__(self, D: int, eps: float, factory: dict):
        super().__init__()
        self.scale = _empty(D, factory)
        self.eps = eps

    def forward(self, x):
        return rms_norm(x, self.scale, self.eps)


def _norm(cfg: DecoderConfig, factory: dict) -> nn.Module:
    cls = RMSNorm if cfg.norm_style == "rms" else LayerNorm
    return cls(cfg.hidden_size, cfg.layer_norm_eps, factory)


def project(x: torch.Tensor, w, b: Optional[torch.Tensor]) -> torch.Tensor:
    """x @ wᵀ + b: `F.linear` for a float weight; for an int8 one
    `int8_project`, then the bias in x's dtype (the JAX `_project`)."""
    if is_quantized(w):
        y = int8_project(x, w)
        return y if b is None else y + b.to(x.dtype)
    return F.linear(x, w, b)


def _params(module: nn.Module, names, shapes: dict, prefix: str, factory: dict):
    for n in names:
        if prefix + n in shapes:
            setattr(module, n, _empty(shapes[prefix + n], factory))
        else:
            setattr(module, n, None)


class Attention(nn.Module):
    """Multi-head attention: projections in (B, T, H·Dh), rotary (GPT-J) on
    q and k, then by config `plain_attention` (bidirectional or
    relative-bias configs: `plain` set), or the flash attention
    (`use_flash`, T % 128 == 0, rows not packed), or the fused short-T
    attention, with BLOOM's ALiBi slopes where the config has them, then
    the output projection. The head count is the projections' width over
    Dh, so a tensor-parallel shard holding H/tp heads' columns runs its
    heads with the same code (`attend`)."""

    def __init__(self, cfg: DecoderConfig, shapes: dict, prefix: str, factory: dict):
        super().__init__()
        _params(self, ("wq", "wk", "wv", "wo", "bq", "bk", "bv", "bo"), shapes,
                prefix + "attn.", factory)
        self.Dh = cfg.head_size
        self.rotary_dim = cfg.rotary_dim
        self.scale_attn = cfg.scale_attn
        self.scale = 1.0 / math.sqrt(cfg.head_size) if cfg.scale_attn else 1.0
        self.use_flash = cfg.use_flash
        self.causal = not cfg.bidirectional
        self.plain = cfg.bidirectional or cfg.relative_attention

    def qkv(self, x):
        """The q, k and v projections (with their biases), (B, T, H·Dh) each."""
        return (project(x, self.wq, self.bq), project(x, self.wk, self.bk),
                project(x, self.wv, self.bv))

    def rotate(self, q, k, rope):
        """GPT-J's rotary on q and k, (B, T, H·Dh) each; without `rope`
        they come back as they are."""
        if rope is None:
            return q, k
        B, T, HD = q.shape
        return tuple(apply_rotary(t.view(B, T, HD // self.Dh, self.Dh), *rope,
                                  self.rotary_dim).reshape(B, T, HD) for t in (q, k))

    def out(self, o):
        """The output projection of the heads' output o, (B, T, H·Dh)."""
        return project(o, self.wo, self.bo)

    def attend(self, q, k, v, key_mask, window: int, segment_ids, rope, slopes, kpos,
               bias=None):
        """Rotary, then attention over the q.shape[-1] // Dh heads of q, k
        and v (slopes and bias: those heads' own) → (B, T, H·Dh), before
        the output projection."""
        B, T, HD = q.shape
        H = HD // self.Dh
        q, k = self.rotate(q, k, rope)
        if self.plain:
            return plain_attention(q, k, v, bias, H, self.scale_attn)
        if self.use_flash and T % 128 == 0 and segment_ids is None:
            # (B, H, T, Dh) views of the projections: the kernel reads them
            # through their strides and writes the output in the same
            # (B, T, H·Dh) layout, so neither side copies on the card
            qh, kh, vh = (t.view(B, T, H, self.Dh).transpose(1, 2) for t in (q, k, v))
            out = flash_attention(qh, kh, vh, key_mask, slopes, scale=self.scale,
                                  window=window, block_kv=256 if T % 256 == 0 else 128,
                                  causal=self.causal)
            return out.transpose(1, 2).reshape(B, T, HD)
        return short_attention(q, k, v, key_mask, slopes, self.scale, window, H,
                               slopes is not None, segments=segment_ids, positions=kpos,
                               causal=self.causal)

    def forward(self, x, key_mask, window: int, segment_ids, rope, slopes, kpos, bias=None):
        return self.out(self.attend(*self.qkv(x), key_mask, window, segment_ids, rope,
                                    slopes, kpos, bias))


_ACTIVATIONS = {
    "relu": F.relu,
    "quick_gelu": lambda h: h * torch.sigmoid(1.702 * h),
}


class MLP(nn.Module):
    """wo(act(wi·x + bi)) + bo: tanh-GELU (the GPT families), erf GELU
    (`gelu_exact`: BERT), ReLU (T5 v1.0), quick-GELU (CLIP), or for
    `gated_gelu` (T5 v1.1) tanh-GELU(wi·x)·(wg·x)."""

    def __init__(self, cfg: DecoderConfig, shapes: dict, prefix: str, factory: dict):
        super().__init__()
        _params(self, ("wi", "wg", "bi", "wo", "bo"), shapes, prefix + "mlp.", factory)
        self.act = cfg.mlp_activation
        self.approximate = "none" if cfg.gelu_exact else "tanh"

    def hidden(self, x, wg=None):
        """act(wi·x + bi) (gated: · (wg·x)), before the output projection;
        wg: the gate's weight when it is not the module's (a tp shard's
        columns of the replicated gate)."""
        h = project(x, self.wi, self.bi)
        if self.act == "gated_gelu":
            return F.gelu(h, approximate="tanh") * project(x, self.wg if wg is None else wg,
                                                           None)
        if self.act is None:
            return F.gelu(h, approximate=self.approximate)
        return _ACTIVATIONS[self.act](h)

    def forward(self, x):
        return project(self.hidden(x), self.wo, self.bo)


class Block(nn.Module):
    """Pre-LN block: x + attn(ln1(x)), then + mlp(ln2(·)); under the parallel
    residual (GPT-J) x + attn(ln1(x)) + mlp(ln1(x)); under `post_layernorm`
    (BERT) ln1(x + attn(x)), then ln2(· + mlp(·))."""

    def __init__(self, cfg: DecoderConfig, shapes: dict, i: int, local: bool, factory: dict):
        super().__init__()
        prefix = f"layers.{i}."
        self.ln1 = _norm(cfg, factory)
        self.attn = Attention(cfg, shapes, prefix, factory)
        self.ln2 = None if cfg.parallel_residual else _norm(cfg, factory)
        self.mlp = MLP(cfg, shapes, prefix, factory)
        self.window = cfg.local_window if local else 0
        self.post_ln = cfg.post_layernorm

    def forward(self, x, key_mask, segment_ids, rope, slopes, kpos, cond=None, bias=None):
        h1 = self.pre(x)
        return self.finish(x, h1, self.attn(h1, key_mask, self.window, segment_ids, rope,
                                            slopes, kpos, bias), cond)

    def pre(self, x):
        """The attention's input: ln1(x), or x itself in a post-LN block."""
        return x if self.post_ln else self.ln1(x)

    def finish(self, x, h1, a, cond=None):
        """The block's output from its input x, `pre(x)` and the attention
        output a (after its output projection): the residuals and the MLP,
        with TSDAE's `cond` (B, 1, D), the sentence embedding's projection,
        added to a (not in a post-LN block)."""
        if self.post_ln:
            x = self.ln1(x + a)
            return self.ln2(x + self.mlp(x))
        if cond is not None:
            a = a + cond
        if self.ln2 is None:
            return x + a + self.mlp(h1)
        x = x + a
        return x + self.mlp(self.ln2(x))


class Head(nn.Module):
    """A separate LM head (GPT-J; BLOOM and GPT-Neo tie theirs to `wte`):
    w (V, D) and, for a biased head, b (V,)."""

    def __init__(self, shapes: dict, factory: dict):
        super().__init__()
        _params(self, ("w", "b"), shapes, "lm_head.", factory)


class Decoder(nn.Module):
    """The transformer stack of every family (GPT-Neo, GPT-J, BLOOM, BERT,
    T5's encoder, CLIP's towers), with parameters in `cfg.dtype` on
    `device` (the card by default; "cuda" without one raises, and CPU use
    passes device="cpu"). Where the weights come from:

      * `weights` (a state dict: `params_from_jax`, `hf_loader.load_pretrained`):
        those values, cast to `cfg.dtype`; a separate LM head when it holds
        `lm_head.*`; a projection given as `<name>.q` (int8, [out, in]) and
        `<name>.s` (fp32 (out, 1)) becomes a `QuantizedWeight`. No random
        draw.
      * else random, 0.02·N(0, 1) weights, LayerNorm scales 1, biases 0, with
        a separate LM head of the leaves `lm_head` names (("w",), ("w", "b"))
        or none (tied to `wte`):
          - `generator` on the CPU, or none: `init_params(cfg, generator)`,
            drawn in fp32 on the host and cast, so one seed gives the same
            weights on every device (the tests' and parity checks' path);
          - `generator` on `device` (e.g. `torch.Generator("cuda")`): each
            tensor drawn in place on the device in `cfg.dtype`
            (`init_params_`), with no host copy: the path of the
            full-width 6B presets. Other numbers than the host path's.
    """

    def __init__(self, cfg: DecoderConfig, *, device="cuda",
                 generator: Optional[torch.Generator] = None,
                 weights: Optional[Mapping[str, torch.Tensor]] = None,
                 lm_head: Tuple[str, ...] = ()):
        super().__init__()
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Decoder: device 'cuda' requested but "
                               "torch.cuda.is_available() is False; pass device=\"cpu\"")
        check_config(cfg)
        if weights is not None:
            lm_head = tuple(leaf for leaf in ("w", "b") if f"lm_head.{leaf}" in weights)
        self.cfg = cfg
        factory = dict(device=device, dtype=cfg.dtype)
        shapes = param_shapes(cfg, lm_head)
        self.wte = _empty(shapes["wte"], factory)
        self.wpe = _empty(shapes["wpe"], factory) if "wpe" in shapes else None
        self.wtt = _empty(shapes["wtt"], factory) if "wtt" in shapes else None
        self.rel_bias = _empty(shapes["rel_bias"], factory) if "rel_bias" in shapes else None
        self.emb_ln = (LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, factory)
                       if cfg.embedding_layernorm else None)
        self.layers = nn.ModuleList(
            Block(cfg, shapes, i, local, factory) for i, local in enumerate(cfg.local_flags()))
        self.ln_f = None if cfg.post_layernorm else _norm(cfg, factory)
        self.lm_head = Head(shapes, factory) if lm_head else None
        if weights is not None:
            for name in [n[:-2] for n in weights if n.endswith(".q")]:
                path, leaf = name.rsplit(".", 1)
                owner = self.get_submodule(path)
                delattr(owner, leaf)
                setattr(owner, leaf, QuantizedWeight(
                    torch.empty(shapes[name], dtype=torch.int8, device=device),
                    torch.empty((shapes[name][0], 1), dtype=torch.float32, device=device)))
            self.load_state_dict(weights)
        elif generator is not None and generator.device.type != "cpu":
            if generator.device.type != device.type:
                raise ValueError(f"Decoder: generator on {generator.device}, "
                                 f"parameters on {device}")
            init_params_(dict(self.named_parameters()), generator)
        else:
            self.load_state_dict(init_params(cfg, generator, lm_head))

    def forward(self, input_ids: Optional[torch.Tensor], attention_mask: torch.Tensor, *,
                output_hidden_states: bool = False,
                position_ids: Optional[torch.Tensor] = None,
                segment_ids: Optional[torch.Tensor] = None,
                sp_mesh=None, tp_mesh=None, token_type_ids=None,
                inputs_embeds=None, cond=None, cond_params=None) -> torch.Tensor:
        """Final hidden states (B, T, D) after ln_f (a post-LN stack: the
        last block's output), or with output_hidden_states a stacked (L+1,
        B, T, D) tensor: entry 0 the embedding output, entries 1..L-1 the
        block outputs, entry L the final states.

        input_ids (B, T), or None with inputs_embeds (B, T, D): embeddings
        computed by the caller (CLIP's patches), to which the learned
        positions, token types and embedding LayerNorm still apply.
        token_type_ids: optional (B, T), zeros by default; read only when
        the config has token types (BERT).
        position_ids: optional (T,) or (B, T); segment_ids: optional (B, T)
        for packed rows (block-diagonal attention), which needs position_ids
        that restart at each segment. The whole forward runs under
        `matmul_precision(cfg.matmul_precision)`, as the JAX decoder does.

        cond (B, D) with cond_params {"w": (L, D, D), "b": (L, D)}: TSDAE's
        decoder conditioning. Cross-attention to one encoder token is a
        query-independent projection of the sentence embedding (the softmax
        of a single logit is 1), so each layer l adds cond @ w[l] + b[l], in
        the activations' dtype, to its attention output before the residual
        add (pre-LN and parallel-residual blocks alike; a post-LN block
        takes none, as in the JAX forward).

        tp_mesh: a `parallel.Mesh`: the forward runs over it, rows split over
        dp and the weights Megatron-sharded over tp (`TPGroup`), sharded by
        `parallel.shard_params` for this call (for repeated calls, shard once
        and call the `ShardedDecoder`); results on the inputs' device.
        sp_mesh: a `parallel.Mesh` whose dp axis (`devices[:, 0]`) shards T,
        which must divide by its size: ring attention (see the module
        docstring); results gathered on the inputs' device. Causal configs
        only: bidirectional models, packed rows and T5's relative bias raise
        `NotImplementedError`, as in JAX."""
        if sp_mesh is not None:
            self._check_sp(segment_ids, tp_mesh)
        self._check_inputs(input_ids, position_ids, segment_ids, inputs_embeds, cond,
                           cond_params)
        if sp_mesh is not None:
            return self._sp_forward(input_ids, attention_mask, sp_mesh, output_hidden_states,
                                    position_ids, token_type_ids, inputs_embeds, cond,
                                    cond_params)
        if tp_mesh is not None:
            if cond is not None:
                raise NotImplementedError("TSDAE conditioning under tp_mesh: JAX's TSDAE "
                                          "takes sp_mesh only, never a tensor-parallel mesh")
            from ..parallel.sharding import shard_params
            return shard_params(self, tp_mesh)(
                input_ids, attention_mask, output_hidden_states=output_hidden_states,
                position_ids=position_ids, segment_ids=segment_ids,
                token_type_ids=token_type_ids, inputs_embeds=inputs_embeds)
        cfg = self.cfg
        if inputs_embeds is not None:
            B, T = inputs_embeds.shape[:2]
            dev = inputs_embeds.device
        else:
            B, T = input_ids.shape
            dev = input_ids.device
        positions = torch.arange(T, device=dev) if position_ids is None else position_ids
        with matmul_precision(cfg.matmul_precision):
            x = self._embed(input_ids, inputs_embeds, positions, token_type_ids)
            key_mask, rope, slopes, kpos, segment_ids, bias = self._side_inputs(
                attention_mask, positions, segment_ids, B, T)

            hidden = [x]
            for i, layer in enumerate(self.layers):
                x = layer(x, key_mask, segment_ids, rope, slopes, kpos,
                          _cond_proj(cond, cond_params, i, cfg.dtype), bias)
                hidden.append(x)
            final = x if self.ln_f is None else self.ln_f(x)
            if output_hidden_states:
                return torch.stack(hidden[:-1] + [final])
            return final

    def _check_sp(self, segment_ids, tp_mesh) -> None:
        """The JAX forward's refusals under sp_mesh."""
        cfg = self.cfg
        if tp_mesh is not None:
            raise ValueError("pass either tp_mesh or sp_mesh, not both")
        if cfg.bidirectional:
            raise NotImplementedError(
                "ring attention is causal-only; BERT sp encode is unsupported")
        if segment_ids is not None:
            raise NotImplementedError(
                "sequence packing (segment_ids) is unsupported under sp_mesh: "
                "ring attention encodes only the causal+padding structure")
        if cfg.relative_attention:
            raise NotImplementedError(
                "relative position bias (T5) is unsupported under sp_mesh")

    def _sp_forward(self, input_ids, attention_mask, sp_mesh, output_hidden_states,
                    position_ids, token_type_ids, inputs_embeds, cond, cond_params):
        """`forward` with T sharded over sp_mesh's dp devices (ring attention)."""
        cfg = self.cfg
        devices = list(sp_mesh.devices[:, 0])
        lead = inputs_embeds if inputs_embeds is not None else input_ids
        B, T = lead.shape[:2]
        dev, n = lead.device, len(devices)
        if T % n:
            raise ValueError(f"sp_mesh: T={T} must divide by the sp axis size {n} "
                             "(ring attention shards T); pad the rows")
        t = T // n
        positions = torch.arange(T, device=dev) if position_ids is None else position_ids

        def cut(x, dim=1):  # shard r's positions of x, on its device
            return [x.narrow(dim, r * t, t).to(d, non_blocking=True)
                    for r, d in enumerate(devices)]

        with matmul_precision(cfg.matmul_precision):
            xs = cut(self._embed(input_ids, inputs_embeds, positions, token_type_ids))
            masks = cut(attention_mask.to(torch.int32))
            ropes = [None] * n
            if cfg.position_embedding == "rotary":
                sin, cos = (r.to(cfg.dtype) for r in rope_sincos(positions, cfg.rotary_dim))
                ropes = list(zip(cut(sin, sin.dim() - 2), cut(cos, cos.dim() - 2)))
            slopes = (alibi_slopes(cfg.num_heads, dev)
                      if cfg.position_embedding == "alibi" else None)
            hidden = [xs]
            for i, layer in enumerate(self.layers):
                xs = _sp_block(layer, xs, masks, ropes, slopes, devices,
                               _cond_proj(cond, cond_params, i, cfg.dtype))
                hidden.append(xs)
            final = xs if self.ln_f is None else [_run(self.ln_f, _on_device(self.ln_f, d),
                                                       "forward", x)
                                                  for x, d in zip(xs, devices)]
            hidden[-1] = final

            def gather(parts):
                return torch.cat([p.to(dev) for p in parts], dim=1)

            if output_hidden_states:
                return torch.stack([gather(h) for h in hidden])
            return gather(final)

    @staticmethod
    def _check_inputs(input_ids, position_ids, segment_ids, inputs_embeds, cond=None,
                      cond_params=None):
        if cond is not None and cond_params is None:
            raise ValueError("cond without cond_params: TSDAE conditioning needs the "
                             "per-layer projections {'w': (L, D, D), 'b': (L, D)}")
        if segment_ids is not None and position_ids is None:
            raise ValueError(
                "segment_ids without position_ids: packed rows must carry (B, T) "
                "positions that restart at each segment boundary")
        if input_ids is None and inputs_embeds is None:
            raise ValueError("Decoder: pass input_ids or inputs_embeds")

    def _embed(self, input_ids, inputs_embeds, positions, token_type_ids):
        """The embedding output: the token embeddings (or the caller's
        `inputs_embeds`), the learned positions, then `_embed_rest`."""
        dtype = self.cfg.dtype
        x = (inputs_embeds.to(dtype) if inputs_embeds is not None
             else self.wte[input_ids].to(dtype))
        if self.wpe is not None:
            x = x + self.wpe[positions].to(dtype)
        return self._embed_rest(x, token_type_ids)

    def _embed_rest(self, x, token_type_ids):
        """The token types (BERT; zeros by default) and the embedding
        LayerNorm (BLOOM, BERT) on the token and position embeddings x."""
        dtype = self.cfg.dtype
        if self.wtt is not None:
            if token_type_ids is None:
                x = x + self.wtt[0].to(dtype)
            else:
                x = x + self.wtt[token_type_ids].to(dtype)
        if self.emb_ln is not None:
            x = self.emb_ln(x)
        return x

    def _side_inputs(self, attention_mask, positions, segment_ids, B: int, T: int):
        """What every layer reads besides the hidden states, on the mask's
        device: the int32 key mask, GPT-J's rotary tables in the config's
        dtype, BLOOM's slopes (all H heads) and, for packed rows, its key
        positions, the int32 segment ids, and the plain attention's bias."""
        cfg = self.cfg
        key_mask = attention_mask.to(torch.int32).contiguous()
        rope = slopes = kpos = None
        if cfg.position_embedding == "rotary":
            rope = tuple(t.to(cfg.dtype) for t in rope_sincos(positions, cfg.rotary_dim))
        bias = self._plain_bias(attention_mask, T, segment_ids)
        if cfg.position_embedding == "alibi":
            slopes = alibi_slopes(cfg.num_heads, attention_mask.device)
            if segment_ids is not None:  # key positions restart in each segment
                kpos = positions.to(torch.int32).expand(B, T).contiguous()
        if segment_ids is not None:
            segment_ids = segment_ids.to(torch.int32).contiguous()
        return key_mask, rope, slopes, kpos, segment_ids, bias

    def _plain_bias(self, attention_mask, T: int, segment_ids) -> Optional[torch.Tensor]:
        """For configs that take `plain_attention` (bidirectional or
        relative-bias): the additive fp32 mask bias, with T5's relative
        bias folded in as the JAX forward folds it; None for the others."""
        cfg = self.cfg
        if not (cfg.bidirectional or cfg.relative_attention):
            return None
        bias = mask_bias(attention_mask, T, causal=not cfg.bidirectional,
                         segment_ids=segment_ids)
        if cfg.relative_attention:
            bias = bias + t5_relative_bias(
                self.rel_bias, T, cfg.relative_attention_buckets,
                cfg.relative_attention_max_distance, cfg.bidirectional)
        return bias

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """LM head (the JAX `logits`): (..., D) → (..., V) in hidden's dtype,
        under the config's matmul precision, from `lm_head` (weight and
        bias) when the weights hold one, else tied to `wte` (GPT-Neo,
        BLOOM); the caller casts to fp32."""
        with matmul_precision(self.cfg.matmul_precision):
            if self.lm_head is not None:
                b = self.lm_head.b
                return F.linear(hidden, self.lm_head.w.to(hidden.dtype),
                                None if b is None else b.to(hidden.dtype))
            return F.linear(hidden, self.wte.to(hidden.dtype))


def _cond_proj(cond, cond_params, i: int, dtype):
    """TSDAE's conditioning of layer i, (cond @ w[i] + b[i]) as (B, 1, D)
    in `dtype`; None without `cond`."""
    if cond is None:
        return None
    return (cond.to(dtype) @ cond_params["w"][i].to(dtype)
            + cond_params["b"][i].to(dtype))[:, None, :]


class _Method(nn.Module):
    """`module.<path>(*args)` as a forward, so that
    `torch.func.functional_call` can run a method other than `forward`."""

    def __init__(self, module: nn.Module, path: str):
        super().__init__()
        self.m = module
        self.path = path

    def forward(self, *args):
        return operator.attrgetter(self.path)(self.m)(*args)


def _on_device(module: nn.Module, device) -> Optional[dict]:
    """`module`'s parameters and buffers on `device`, by name: None where
    they all live there, else differentiable copies (the gradients reach
    the module's own)."""
    state = dict(module.named_parameters())
    state.update(module.named_buffers())
    if all(t.device == device for t in state.values()):
        return None
    return {k: t.to(device) for k, t in state.items()}


def _run(module: nn.Module, state: Optional[dict], path: str, *args):
    """module.<path>(*args): the module's own code, on `state` (from
    `_on_device`) where that is not None."""
    if state is None:
        return operator.attrgetter(path)(module)(*args)
    return torch.func.functional_call(_Method(module, path),
                                      {"m." + k: t for k, t in state.items()}, args)


def _sp_block(layer: Block, xs, masks, ropes, slopes, devices, cond):
    """One causal block over sequence shards, through the block's own
    methods: per shard `pre`, q/k/v and rotary, then ring attention across
    the shards, then per shard the output projection and `finish` (TSDAE's
    `cond`, the residuals, the MLP); on a shard's device through copies of
    the block's weights where they live elsewhere."""
    states = [_on_device(layer, d) for d in devices]
    h1s, qs, ks, vs = [], [], [], []
    for x, rope, state in zip(xs, ropes, states):
        h1 = _run(layer, state, "pre", x)
        q, k, v = _run(layer, state, "attn.qkv", h1)
        q, k = layer.attn.rotate(q, k, rope)
        B, t, _ = q.shape
        for acc, u in zip((qs, ks, vs), (q, k, v)):   # (B, H, t, Dh)
            acc.append(u.view(B, t, -1, layer.attn.Dh).transpose(1, 2))
        h1s.append(h1)
    outs = ring_attention_shards(qs, ks, vs, masks, slopes, scale=layer.attn.scale,
                                 window=layer.window)
    new = []
    for x, h1, o, state, d in zip(xs, h1s, outs, states, devices):
        B, H, t, Dh = o.shape
        a = _run(layer, state, "attn.out", o.transpose(1, 2).reshape(B, t, H * Dh))
        new.append(_run(layer, state, "finish", x, h1, a,
                        None if cond is None else cond.to(d)))
    return new


class TPGroup:
    """The tp shards of one dp row of a sharded decoder
    (`parallel.shard_params`), run in lockstep from this process: the
    counterpart of the JAX forward under a dp×tp mesh with Megatron-sharded
    parameters (`forward(..., tp_mesh=)`, whose collectives XLA inserts).

    Shard j is a `Decoder` on its device holding shard j's slices: q/k/v
    and the MLP's wi column-parallel with their biases, the attention's and
    the MLP's wo row-parallel, wte and wpe on the hidden axis, the LM head
    on the vocab axis, everything else whole. Each layer runs, on every
    shard, its q/k/v columns, then attention on its H/tp heads (K1, or K3
    where the config routes to flash, with the shard's own ALiBi slopes),
    then its rows of wo; the partial products are summed over the shards
    (`all_reduce_sum`, shard 0 first) and the bias added once, after the
    sum; the MLP the same. The residual stream, the LayerNorms and the
    embeddings after their gather are replicated: computed once on each
    distinct device. Where H % tp != 0, q, k and v are gathered and the
    attention runs unsharded on the first shard's device, as the JAX
    decoder falls back (the projections stay sharded). An int8 row-parallel
    projection takes each token's scale from its whole row (the maximum of
    the shards' maxima) and sums the shards' int32 products exactly
    (`int8_project_row_parallel`), so it gives the unsharded product.

    Called like a `Decoder`: inputs and results on `device` (the first
    shard's), `logits` the LM head (the vocab shards gathered there), so
    the engine, the ranker and `ops/logprobs.py` take either."""

    def __init__(self, shards):
        self.shards = list(shards)
        self.cfg = self.shards[0].cfg
        self.devices = [s.wte.device for s in self.shards]
        # replicated work runs once on each distinct device, with the first
        # shard there (its replicated leaves equal every other shard's)
        self._first = {}
        for s, d in zip(self.shards, self.devices):
            self._first.setdefault(d, s)

    @property
    def device(self) -> torch.device:
        return self.devices[0]

    def __call__(self, input_ids, attention_mask, **kw):
        return self.forward(input_ids, attention_mask, **kw)

    def _on(self, t) -> dict:
        return {d: None if t is None else t.to(d, non_blocking=True) for d in self._first}

    def _by_device(self, parts) -> dict:
        """One entry per distinct device from a per-shard list (entries on
        one device are equal)."""
        out = {}
        for p, d in zip(parts, self.devices):
            out.setdefault(d, p)
        return out

    def forward(self, input_ids, attention_mask, *, output_hidden_states: bool = False,
                position_ids=None, segment_ids=None, token_type_ids=None,
                inputs_embeds=None) -> torch.Tensor:
        """`Decoder.forward` over the tp shards (see the class docstring)."""
        if len(self.shards) == 1:
            return self.shards[0](input_ids, attention_mask,
                                  output_hidden_states=output_hidden_states,
                                  position_ids=position_ids, segment_ids=segment_ids,
                                  token_type_ids=token_type_ids, inputs_embeds=inputs_embeds)
        Decoder._check_inputs(input_ids, position_ids, segment_ids, inputs_embeds)
        cfg = self.cfg
        s0, dev0 = self.shards[0], self.device
        B, T = (inputs_embeds if inputs_embeds is not None else input_ids).shape[:2]
        positions = torch.arange(T, device=dev0) if position_ids is None else position_ids
        ids, pos, mask, seg, tt = (self._on(t) for t in (
            input_ids, positions, attention_mask, segment_ids, token_type_ids))
        with matmul_precision(cfg.matmul_precision):
            # embeddings: each shard looks up its hidden columns, then the gather
            if inputs_embeds is None:
                x = self._by_device(all_gather(
                    [s.wte[ids[d]].to(cfg.dtype) for s, d in zip(self.shards, self.devices)]))
            else:
                x = self._on(inputs_embeds.to(cfg.dtype))
            if s0.wpe is not None:
                wpe = self._by_device(all_gather(
                    [s.wpe[pos[d]].to(cfg.dtype) for s, d in zip(self.shards, self.devices)]))
                x = {d: x[d] + wpe[d] for d in x}
            x = {d: s._embed_rest(x[d], tt[d]) for d, s in self._first.items()}
            side = {d: s._side_inputs(mask[d], pos[d], seg[d], B, T)
                    for d, s in self._first.items()}

            hidden = [x[dev0]]
            for li in range(cfg.num_layers):
                blocks = [s.layers[li] for s in self.shards]
                rep = {d: s.layers[li] for d, s in self._first.items()}
                if blocks[0].post_ln:
                    a = self._attention(blocks, x, side)
                    x = {d: rep[d].ln1(x[d] + a[d]) for d in x}
                    m = self._mlp(blocks, x)
                    x = {d: rep[d].ln2(x[d] + m[d]) for d in x}
                else:
                    h1 = {d: rep[d].ln1(x[d]) for d in x}
                    a = self._attention(blocks, h1, side)
                    if blocks[0].ln2 is None:
                        m = self._mlp(blocks, h1)
                        x = {d: x[d] + a[d] + m[d] for d in x}
                    else:
                        x = {d: x[d] + a[d] for d in x}
                        m = self._mlp(blocks, {d: rep[d].ln2(x[d]) for d in x})
                        x = {d: x[d] + m[d] for d in x}
                hidden.append(x[dev0])
            final = hidden[-1] if s0.ln_f is None else s0.ln_f(hidden[-1])
            if output_hidden_states:
                return torch.stack(hidden[:-1] + [final])
            return final

    def _attention(self, blocks, h: dict, side: dict) -> dict:
        tp = len(blocks)
        qkv = [b.attn.qkv(h[d]) for b, d in zip(blocks, self.devices)]
        H = self.cfg.num_heads
        if H % tp == 0:
            Hs = H // tp
            outs = []
            for j, (b, d, (q, k, v)) in enumerate(zip(blocks, self.devices, qkv)):
                key_mask, rope, slopes, kpos, seg, bias = side[d]
                if slopes is not None:   # this shard's heads' slopes
                    slopes = slopes[j * Hs:(j + 1) * Hs]
                if bias is not None and bias.shape[1] == H:   # T5's per-head bias
                    bias = bias[:, j * Hs:(j + 1) * Hs]
                outs.append(b.attn.attend(q, k, v, key_mask, b.window, seg, rope, slopes,
                                          kpos, bias))
        else:
            # the JAX decoder's fallback: attention over all H heads, unsharded
            dev0 = self.device
            q, k, v = (torch.cat([t[i].to(dev0) for t in qkv], dim=-1) for i in range(3))
            key_mask, rope, slopes, kpos, seg, bias = side[dev0]
            out = blocks[0].attn.attend(q, k, v, key_mask, blocks[0].window, seg, rope, slopes,
                                        kpos, bias)
            w = out.shape[-1] // tp
            outs = [out[..., j * w:(j + 1) * w].to(d, non_blocking=True)
                    for j, d in enumerate(self.devices)]
        return self._row_parallel(outs, [b.attn.wo for b in blocks],
                                  [b.attn.bo for b in blocks])

    def _mlp(self, blocks, h: dict) -> dict:
        tp = len(blocks)
        outs = []
        for j, (b, d) in enumerate(zip(blocks, self.devices)):
            wg = b.mlp.wg
            if wg is not None:   # the gate is whole on every shard: its columns of it
                step = wg.shape[0] // tp
                wg = wg[j * step:(j + 1) * step]
            outs.append(b.mlp.hidden(h[d], wg))
        return self._row_parallel(outs, [b.mlp.wo for b in blocks], [b.mlp.bo for b in blocks])

    def _row_parallel(self, xs, ws, bs) -> dict:
        """Σ_j xs[j] @ ws[j]ᵀ over the shards, then the bias once: on each device."""
        if is_quantized(ws[0]):
            ys = int8_project_row_parallel(xs, ws)
        else:
            ys = all_reduce_sum([F.linear(x, w) for x, w in zip(xs, ws)])
        ys, bs = self._by_device(ys), self._by_device(bs)
        return {d: y if bs[d] is None else y + bs[d].to(y.dtype) for d, y in ys.items()}

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """The LM head on `device`: a separate head's vocab shards gathered
        (then its bias, whole), or for a head tied to the hidden-sharded
        `wte` the shards' partial products summed."""
        if len(self.shards) == 1:
            return self.shards[0].logits(hidden)
        s0, dev0, tp = self.shards[0], self.device, len(self.shards)
        with matmul_precision(self.cfg.matmul_precision):
            if s0.lm_head is not None:
                out = gather_to([F.linear(hidden.to(d), s.lm_head.w.to(hidden.dtype))
                                 for s, d in zip(self.shards, self.devices)], dev0, dim=-1)
                b = s0.lm_head.b
                return out if b is None else out + b.to(hidden.dtype)
            w = hidden.shape[-1] // tp
            return reduce_sum_to([F.linear(hidden[..., j * w:(j + 1) * w].to(d),
                                           s.wte.to(hidden.dtype))
                                  for j, (s, d) in enumerate(zip(self.shards, self.devices))],
                                 dev0)
