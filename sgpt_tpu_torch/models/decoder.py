"""Causal decoder forward of the GPT families (counterpart of `sgpt_tpu/models/decoder.py`).

Plain PyTorch: the layers are an `nn.ModuleList` walked by a Python loop.
What the port implements is the causal path of the JAX `_forward_impl` for
its three GPT families: GPT-Neo (learned positions, unscaled scores, global
and local (windowed) layers alternating), GPT-J (GPT-J's interleaved rotary
on the leading `rotary_dim` of each head, 1/sqrt(Dh) scores, the parallel
residual x + attn(ln1(x)) + mlp(ln1(x)), a separate biased LM head) and
BLOOM (ALiBi with BLOOM's slopes, a LayerNorm on the embeddings, q/k/v
biases); pre-LN blocks (LayerNorm with fp32 statistics), tanh-GELU MLP,
`ln_f`, `output_hidden_states` with HF semantics, and the LM head
(`Decoder.logits`: `lm_head` when the weights have one, else tied to
`wte`). A projection whose weight is int8 (`ops.quant.QuantizedWeight`,
from `quantize_decoder_params` or int8 `weights`) goes through
`int8_project`, as the JAX `_project` dispatches on a quantized leaf.
Attention routes as the JAX decoder does: with `cfg.use_flash`,
T % 128 == 0 and no packed rows (`segment_ids`), through
`ops.flash_attention` (K3 on a CUDA tensor, and K4a/K4b for the backward
when a gradient is needed); every other call through `ops.short_attention`
(K1, and K2 for the backward when a gradient is needed). On a CPU tensor
both take their plain versions. ALiBi reaches both kernels as the slopes
(K1 and K3 add slope·key position to the scaled score); packed rows pass
their per-segment positions as K1's ALiBi key positions, unpacked rows use
the key index, which equals the JAX XLA path's cumsum(mask) − 1 on every
valid key of a right-padded row. TSDAE's decoder conditioning (`cond`,
`cond_params`) adds a per-layer projection of the sentence embedding to
each attention output, as the JAX forward does. The flags of the encoder families (BERT,
T5, CLIP) raise `NotImplementedError`.
"""
from __future__ import annotations

import math
from typing import Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.flash_attention import flash_attention
from ..ops.quant import QuantizedWeight, int8_project, is_quantized
from ..ops.short_attention import short_attention
from .config import DecoderConfig
from .params import init_params, init_params_, param_shapes
from .precision import matmul_precision


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm with fp32 statistics regardless of activation dtype: for a
    bf16 input, PyTorch's kernel keeps the mean, the biased variance and the
    affine in fp32 and casts the result back, as the JAX `layer_norm` does."""
    return F.layer_norm(x, (x.shape[-1],), scale, bias, eps)


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


def _unsupported(cfg: DecoderConfig) -> list:
    """(flag, ROADMAP item) for each config flag this port does not implement."""
    later = []
    if cfg.position_embedding not in ("learned", "rotary", "alibi"):
        later.append((f"position_embedding={cfg.position_embedding!r} (T5)",
                      "Queue 1 item 14"))
    if cfg.bidirectional:
        later.append(("bidirectional (BERT, T5)", "Queue 1 item 14"))
    if cfg.post_layernorm:
        later.append(("post_layernorm (BERT)", "Queue 1 item 14"))
    if cfg.token_type_vocab:
        later.append(("token_type_vocab (BERT)", "Queue 1 item 14"))
    if cfg.gelu_exact or cfg.mlp_activation is not None:
        later.append(("gelu_exact / mlp_activation (BERT, T5, CLIP)", "Queue 1 item 14"))
    if cfg.norm_style != "layer":
        later.append((f"norm_style={cfg.norm_style!r} (T5 RMSNorm)", "Queue 1 item 14"))
    if cfg.relative_attention:
        later.append(("relative_attention (T5)", "Queue 1 item 14"))
    return later


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
    """Causal multi-head attention: projections in (B, T, H·Dh), rotary
    (GPT-J) on q and k, then the flash attention (`use_flash`, T % 128 == 0,
    rows not packed) or the fused short-T attention, with BLOOM's ALiBi
    slopes where the config has them, then the output projection."""

    def __init__(self, cfg: DecoderConfig, shapes: dict, prefix: str, factory: dict):
        super().__init__()
        _params(self, ("wq", "wk", "wv", "wo", "bq", "bk", "bv", "bo"), shapes,
                prefix + "attn.", factory)
        self.H = cfg.num_heads
        self.rotary_dim = cfg.rotary_dim
        self.scale = 1.0 / math.sqrt(cfg.head_size) if cfg.scale_attn else 1.0
        self.use_flash = cfg.use_flash

    def forward(self, x, key_mask, window: int, segment_ids, rope, slopes, kpos):
        q = project(x, self.wq, self.bq)
        k = project(x, self.wk, self.bk)
        v = project(x, self.wv, self.bv)
        B, T, HD = q.shape
        if rope is not None:
            q, k = (apply_rotary(t.view(B, T, self.H, HD // self.H), *rope,
                                 self.rotary_dim).reshape(B, T, HD) for t in (q, k))
        alibi = slopes is not None
        if self.use_flash and T % 128 == 0 and segment_ids is None:
            # (B, H, T, Dh) views of the projections: the kernel reads them
            # through their strides and writes the output in the same
            # (B, T, H·Dh) layout, so neither side copies on the card
            qh, kh, vh = (t.view(B, T, self.H, HD // self.H).transpose(1, 2)
                          for t in (q, k, v))
            out = flash_attention(qh, kh, vh, key_mask, slopes, scale=self.scale,
                                  window=window, block_kv=256 if T % 256 == 0 else 128)
            out = out.transpose(1, 2).reshape(B, T, HD)
        else:
            out = short_attention(q, k, v, key_mask, slopes, self.scale, window, self.H,
                                  alibi, segments=segment_ids, positions=kpos)
        return project(out, self.wo, self.bo)


class MLP(nn.Module):
    def __init__(self, shapes: dict, prefix: str, factory: dict):
        super().__init__()
        _params(self, ("wi", "bi", "wo", "bo"), shapes, prefix + "mlp.", factory)

    def forward(self, x):
        h = F.gelu(project(x, self.wi, self.bi), approximate="tanh")
        return project(h, self.wo, self.bo)


class Block(nn.Module):
    """Pre-LN block: x + attn(ln1(x)), then + mlp(ln2(·)); under the parallel
    residual (GPT-J) x + attn(ln1(x)) + mlp(ln1(x))."""

    def __init__(self, cfg: DecoderConfig, shapes: dict, i: int, local: bool, factory: dict):
        super().__init__()
        prefix = f"layers.{i}."
        self.ln1 = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, factory)
        self.attn = Attention(cfg, shapes, prefix, factory)
        self.ln2 = (None if cfg.parallel_residual
                    else LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, factory))
        self.mlp = MLP(shapes, prefix, factory)
        self.window = cfg.local_window if local else 0

    def forward(self, x, key_mask, segment_ids, rope, slopes, kpos, cond=None):
        h1 = self.ln1(x)
        a = self.attn(h1, key_mask, self.window, segment_ids, rope, slopes, kpos)
        if cond is not None:  # TSDAE: the sentence embedding's projection, (B, 1, D)
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
    """Causal decoder of the GPT families, with parameters in `cfg.dtype` on
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
        later = _unsupported(cfg)
        if later:
            raise NotImplementedError(
                "not ported yet: " + "; ".join(f"{f} — ROADMAP {r}" for f, r in later))
        if weights is not None:
            lm_head = tuple(leaf for leaf in ("w", "b") if f"lm_head.{leaf}" in weights)
        self.cfg = cfg
        factory = dict(device=device, dtype=cfg.dtype)
        shapes = param_shapes(cfg, lm_head)
        self.wte = _empty(shapes["wte"], factory)
        self.wpe = _empty(shapes["wpe"], factory) if "wpe" in shapes else None
        self.emb_ln = (LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, factory)
                       if cfg.embedding_layernorm else None)
        self.layers = nn.ModuleList(
            Block(cfg, shapes, i, local, factory) for i, local in enumerate(cfg.local_flags()))
        self.ln_f = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, factory)
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

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor, *,
                output_hidden_states: bool = False,
                position_ids: Optional[torch.Tensor] = None,
                segment_ids: Optional[torch.Tensor] = None,
                sp_mesh=None, tp_mesh=None, token_type_ids=None,
                inputs_embeds=None, cond=None, cond_params=None) -> torch.Tensor:
        """Final hidden states (B, T, D) after ln_f, or with
        output_hidden_states a stacked (L+1, B, T, D) tensor: entry 0 the
        embedding output, entries 1..L-1 the block outputs, entry L
        ln_f(last block output).

        position_ids: optional (T,) or (B, T); segment_ids: optional (B, T)
        for packed rows (block-diagonal attention), which needs position_ids
        that restart at each segment. The whole forward runs under
        `matmul_precision(cfg.matmul_precision)`, as the JAX decoder does.

        cond (B, D) with cond_params {"w": (L, D, D), "b": (L, D)}: TSDAE's
        decoder conditioning. Cross-attention to one encoder token is a
        query-independent projection of the sentence embedding (the softmax
        of a single logit is 1), so each layer l adds cond @ w[l] + b[l], in
        the activations' dtype, to its attention output before the residual
        add (pre-LN and parallel-residual blocks alike), as the JAX forward
        does."""
        if sp_mesh is not None or tp_mesh is not None:
            raise NotImplementedError("sp_mesh / tp_mesh — ROADMAP Queue 1 items 11, 12")
        if token_type_ids is not None:
            raise NotImplementedError("token_type_ids (BERT) — ROADMAP Queue 1 item 14")
        if inputs_embeds is not None:
            raise NotImplementedError("inputs_embeds (CLIP vision) — ROADMAP Queue 1 item 14")
        if cond is not None and cond_params is None:
            raise ValueError("cond without cond_params: TSDAE conditioning needs the "
                             "per-layer projections {'w': (L, D, D), 'b': (L, D)}")
        if segment_ids is not None and position_ids is None:
            raise ValueError(
                "segment_ids without position_ids: packed rows must carry (B, T) "
                "positions that restart at each segment boundary")
        cfg = self.cfg
        B, T = input_ids.shape
        dev = input_ids.device
        positions = torch.arange(T, device=dev) if position_ids is None else position_ids
        with matmul_precision(cfg.matmul_precision):
            x = self.wte[input_ids].to(cfg.dtype)
            if self.wpe is not None:
                x = x + self.wpe[positions].to(cfg.dtype)
            if self.emb_ln is not None:
                x = self.emb_ln(x)
            key_mask = attention_mask.to(torch.int32).contiguous()
            rope = slopes = kpos = None
            if cfg.position_embedding == "rotary":
                rope = tuple(t.to(cfg.dtype) for t in rope_sincos(positions, cfg.rotary_dim))
            if cfg.position_embedding == "alibi":
                slopes = alibi_slopes(cfg.num_heads, dev)
                if segment_ids is not None:  # key positions restart in each segment
                    kpos = positions.to(torch.int32).expand(B, T).contiguous()
            if segment_ids is not None:
                segment_ids = segment_ids.to(torch.int32).contiguous()

            hidden = [x]
            for i, layer in enumerate(self.layers):
                proj = None
                if cond is not None:
                    proj = (cond.to(x.dtype) @ cond_params["w"][i].to(x.dtype)
                            + cond_params["b"][i].to(x.dtype))[:, None, :]
                x = layer(x, key_mask, segment_ids, rope, slopes, kpos, proj)
                hidden.append(x)
            final = self.ln_f(x)
            if output_hidden_states:
                return torch.stack(hidden[:-1] + [final])
            return final

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
