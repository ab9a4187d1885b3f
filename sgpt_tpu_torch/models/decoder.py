"""GPT-Neo decoder forward (counterpart of `sgpt_tpu/models/decoder.py`).

Plain PyTorch: the layers are an `nn.ModuleList` walked by a Python loop.
What the port implements is the GPT-Neo path of the JAX `_forward_impl`:
learned positions, pre-LN blocks (LayerNorm with fp32 statistics), causal
attention alternating global and local (windowed) layers, tanh-GELU MLP,
`ln_f`, `output_hidden_states` with HF semantics, and the LM head tied to
`wte` (`Decoder.logits`). Attention routes as
the JAX decoder does: with `cfg.use_flash`, T % 128 == 0 and no packed rows
(`segment_ids`), through `ops.flash_attention` (K3 on a CUDA tensor, and
K4a/K4b for the backward when a gradient is needed); every other call through
`ops.short_attention` (K1, and K2 for the backward when a gradient is
needed). On a CPU tensor both take their plain versions. The flags of the
other families raise `NotImplementedError`.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.flash_attention import flash_attention
from ..ops.short_attention import short_attention
from .config import DecoderConfig
from .params import init_params, param_shapes
from .precision import matmul_precision


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm with fp32 statistics regardless of activation dtype: for a
    bf16 input, PyTorch's kernel keeps the mean, the biased variance and the
    affine in fp32 and casts the result back, as the JAX `layer_norm` does."""
    return F.layer_norm(x, (x.shape[-1],), scale, bias, eps)


def _unsupported(cfg: DecoderConfig) -> list:
    """(flag, ROADMAP item) for each config flag this port does not implement."""
    later = []
    if cfg.position_embedding == "rotary":
        later.append(("position_embedding='rotary' (GPT-J)", "Queue 1 item 3"))
    elif cfg.position_embedding != "learned":
        later.append((f"position_embedding={cfg.position_embedding!r} "
                      "(alibi: BLOOM; none: T5)", "Queue 1 items 3, 14"))
    if cfg.parallel_residual:
        later.append(("parallel_residual (GPT-J)", "Queue 1 item 3"))
    if cfg.embedding_layernorm:
        later.append(("embedding_layernorm (BLOOM, BERT)", "Queue 1 items 3, 14"))
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


class LayerNorm(nn.Module):
    def __init__(self, D: int, eps: float):
        super().__init__()
        self.scale = nn.Parameter(torch.empty(D))
        self.bias = nn.Parameter(torch.empty(D))
        self.eps = eps

    def forward(self, x):
        return layer_norm(x, self.scale, self.bias, self.eps)


def _params(module: nn.Module, names, shapes: dict, prefix: str):
    for n in names:
        if prefix + n in shapes:
            setattr(module, n, nn.Parameter(torch.empty(shapes[prefix + n])))
        else:
            setattr(module, n, None)


class Attention(nn.Module):
    """Causal multi-head attention: projections in (B, T, H·Dh), then the
    flash attention (`use_flash`, T % 128 == 0, rows not packed) or the fused
    short-T attention, then the output projection."""

    def __init__(self, cfg: DecoderConfig, shapes: dict, prefix: str):
        super().__init__()
        _params(self, ("wq", "wk", "wv", "wo", "bq", "bk", "bv", "bo"), shapes,
                prefix + "attn.")
        self.H = cfg.num_heads
        self.scale = 1.0 / math.sqrt(cfg.head_size) if cfg.scale_attn else 1.0
        self.use_flash = cfg.use_flash

    def forward(self, x, key_mask, window: int, segment_ids):
        q = F.linear(x, self.wq, self.bq)
        k = F.linear(x, self.wk, self.bk)
        v = F.linear(x, self.wv, self.bv)
        B, T, HD = q.shape
        # GPT-Neo has no ALiBi: no slopes, use_alibi=False
        if self.use_flash and T % 128 == 0 and segment_ids is None:
            # (B, H, T, Dh) views of the projections: the kernel reads them
            # through their strides and writes the output in the same
            # (B, T, H·Dh) layout, so neither side copies on the card
            qh, kh, vh = (t.view(B, T, self.H, HD // self.H).transpose(1, 2)
                          for t in (q, k, v))
            out = flash_attention(qh, kh, vh, key_mask, None, scale=self.scale,
                                  window=window, block_kv=256 if T % 256 == 0 else 128)
            out = out.transpose(1, 2).reshape(B, T, HD)
        else:
            out = short_attention(q, k, v, key_mask, None, self.scale, window,
                                  self.H, False, segments=segment_ids)
        return F.linear(out, self.wo, self.bo)


class MLP(nn.Module):
    def __init__(self, shapes: dict, prefix: str):
        super().__init__()
        _params(self, ("wi", "bi", "wo", "bo"), shapes, prefix + "mlp.")

    def forward(self, x):
        h = F.gelu(F.linear(x, self.wi, self.bi), approximate="tanh")
        return F.linear(h, self.wo, self.bo)


class Block(nn.Module):
    """Pre-LN block: x + attn(ln1(x)), then + mlp(ln2(·))."""

    def __init__(self, cfg: DecoderConfig, shapes: dict, i: int, local: bool):
        super().__init__()
        prefix = f"layers.{i}."
        self.ln1 = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.attn = Attention(cfg, shapes, prefix)
        self.ln2 = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.mlp = MLP(shapes, prefix)
        self.window = cfg.local_window if local else 0

    def forward(self, x, key_mask, segment_ids):
        x = x + self.attn(self.ln1(x), key_mask, self.window, segment_ids)
        return x + self.mlp(self.ln2(x))


class Decoder(nn.Module):
    """GPT-Neo-style causal decoder. Parameters are created in `cfg.dtype`
    on `device` (the card by default; "cuda" without one raises, and CPU use
    passes device="cpu"), filled from `init_params(cfg, generator)`; load
    converted weights with `load_state_dict(params_from_jax(...))`."""

    def __init__(self, cfg: DecoderConfig, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Decoder: device 'cuda' requested but "
                               "torch.cuda.is_available() is False; pass device=\"cpu\"")
        later = _unsupported(cfg)
        if later:
            raise NotImplementedError(
                "not ported yet: " + "; ".join(f"{f} — ROADMAP {r}" for f, r in later))
        self.cfg = cfg
        shapes = param_shapes(cfg)
        self.wte = nn.Parameter(torch.empty(shapes["wte"]))
        self.wpe = nn.Parameter(torch.empty(shapes["wpe"]))
        self.layers = nn.ModuleList(
            Block(cfg, shapes, i, local) for i, local in enumerate(cfg.local_flags()))
        self.ln_f = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.load_state_dict(init_params(cfg, generator))
        self.to(device=device, dtype=cfg.dtype)

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
        `matmul_precision(cfg.matmul_precision)`, as the JAX decoder does."""
        if sp_mesh is not None or tp_mesh is not None:
            raise NotImplementedError("sp_mesh / tp_mesh — ROADMAP Queue 1 items 11, 12")
        if token_type_ids is not None:
            raise NotImplementedError("token_type_ids (BERT) — ROADMAP Queue 1 item 14")
        if inputs_embeds is not None:
            raise NotImplementedError("inputs_embeds (CLIP vision) — ROADMAP Queue 1 item 14")
        if cond is not None or cond_params is not None:
            raise NotImplementedError("cond / cond_params (TSDAE) — ROADMAP Queue 1 item 14")
        if segment_ids is not None and position_ids is None:
            raise ValueError(
                "segment_ids without position_ids: packed rows must carry (B, T) "
                "positions that restart at each segment boundary")
        cfg = self.cfg
        B, T = input_ids.shape
        positions = (torch.arange(T, device=input_ids.device)
                     if position_ids is None else position_ids)
        with matmul_precision(cfg.matmul_precision):
            x = self.wte[input_ids].to(cfg.dtype) + self.wpe[positions].to(cfg.dtype)
            key_mask = attention_mask.to(torch.int32).contiguous()
            if segment_ids is not None:
                segment_ids = segment_ids.to(torch.int32).contiguous()

            hidden = [x]
            for layer in self.layers:
                x = layer(x, key_mask, segment_ids)
                hidden.append(x)
            final = self.ln_f(x)
            if output_hidden_states:
                return torch.stack(hidden[:-1] + [final])
            return final

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """LM head (the JAX `logits`): GPT-Neo ties it to `wte`, so (..., D)
        → (..., V) = hidden · wteᵀ in hidden's dtype, under the config's
        matmul precision; the caller casts to fp32. A separate `lm_head`
        (GPT-J, BLOOM) comes with those families (ROADMAP Queue 1 item 3)."""
        with matmul_precision(self.cfg.matmul_precision):
            return F.linear(hidden, self.wte.to(hidden.dtype))
