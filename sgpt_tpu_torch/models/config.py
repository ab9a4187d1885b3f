"""Decoder architecture configs (counterpart of `sgpt_tpu/models/config.py`).

Same fields as the JAX `DecoderConfig`; only `dtype` differs: a `torch.dtype`
here, a `jnp.dtype` there. Presets of the three GPT families (GPT-Neo,
GPT-J, BLOOM) and of the encoder families (BERT, T5's encoder); CLIP's two
towers are built in `models/clip.py` from the same config.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    """Static architecture description of a transformer stack: a causal
    decoder (the GPT families, CLIP's text tower) or a bidirectional encoder
    (BERT, T5, CLIP's vision tower)."""

    vocab_size: int
    hidden_size: int
    num_layers: int
    num_heads: int
    max_position_embeddings: int = 2048
    intermediate_size: Optional[int] = None  # default: 4 * hidden_size
    head_dim: Optional[int] = None           # default: hidden_size // num_heads
    position_embedding: str = "learned"      # "learned" | "rotary" | "alibi" | "none"
    rotary_dim: Optional[int] = None
    attention_layout: str = "global"         # "global" | "alternating"
    local_window: int = 256
    scale_attn: bool = True                  # GPT-Neo: False (unscaled scores)
    parallel_residual: bool = False
    embedding_layernorm: bool = False
    qkv_bias: bool = False
    out_bias: bool = True
    layer_norm_eps: float = 1e-5
    bidirectional: bool = False              # no causal mask (BERT, T5, CLIP vision)
    post_layernorm: bool = False             # LN after each residual add (BERT); no ln_f
    token_type_vocab: int = 0                # > 0: token-type embeddings `wtt` (BERT)
    gelu_exact: bool = False                 # erf GELU (BERT), else the tanh approximation
    norm_style: str = "layer"                # "layer" | "rms" (T5: no mean, no bias)
    relative_attention: bool = False         # T5's bucketed relative position bias
    relative_attention_buckets: int = 32
    relative_attention_max_distance: int = 128
    mlp_activation: Optional[str] = None     # None (GELU) | "relu" | "gated_gelu" | "quick_gelu"
    mlp_bias: bool = True                    # T5: no MLP biases
    dtype: torch.dtype = torch.float32       # activation/compute dtype
    matmul_precision: str = "highest"
    use_flash: bool = False                  # flash attention (K3) at T % 128 == 0
    fused_attention: bool = False

    @property
    def head_size(self) -> int:
        return self.head_dim if self.head_dim is not None else self.hidden_size // self.num_heads

    @property
    def mlp_size(self) -> int:
        return self.intermediate_size if self.intermediate_size is not None else 4 * self.hidden_size

    def local_flags(self) -> Tuple[bool, ...]:
        """Per-layer is-local-attention flags: odd layers are local."""
        if self.attention_layout == "alternating":
            return tuple(i % 2 == 1 for i in range(self.num_layers))
        return tuple(False for _ in range(self.num_layers))

    def replace(self, **kw) -> "DecoderConfig":
        return dataclasses.replace(self, **kw)


def gpt_neo(size: str = "125m", **kw) -> DecoderConfig:
    dims = {
        "125m": dict(hidden_size=768, num_layers=12, num_heads=12),
        "1.3b": dict(hidden_size=2048, num_layers=24, num_heads=16),
        "2.7b": dict(hidden_size=2560, num_layers=32, num_heads=20),
    }[size]
    return DecoderConfig(
        vocab_size=50257,
        position_embedding="learned",
        attention_layout="alternating",
        local_window=256,
        scale_attn=False,
        qkv_bias=False,
        out_bias=True,
        **dims,
        **kw,
    )


def gpt_j_6b(**kw) -> DecoderConfig:
    return DecoderConfig(
        vocab_size=50400,
        hidden_size=4096,
        num_layers=28,
        num_heads=16,
        position_embedding="rotary",
        rotary_dim=64,
        parallel_residual=True,
        scale_attn=True,
        qkv_bias=False,
        out_bias=False,
        **kw,
    )


def bloom(size: str = "1b7", **kw) -> DecoderConfig:
    dims = {
        "560m": dict(hidden_size=1024, num_layers=24, num_heads=16),
        "1b7": dict(hidden_size=2048, num_layers=24, num_heads=16),
        "3b": dict(hidden_size=2560, num_layers=30, num_heads=32),
        "7b1": dict(hidden_size=4096, num_layers=30, num_heads=32),
    }[size]
    return DecoderConfig(
        vocab_size=250880,
        position_embedding="alibi",
        embedding_layernorm=True,
        scale_attn=True,
        qkv_bias=True,
        out_bias=True,
        **dims,
        **kw,
    )


def bert(size: str = "base", **kw) -> DecoderConfig:
    """BERT encoder presets (bert-base/large-uncased geometry): learned
    positions, token types, a LayerNorm on the embeddings, post-LN blocks,
    erf GELU, bidirectional attention scaled by 1/sqrt(Dh)."""
    dims = {
        "base": dict(hidden_size=768, num_layers=12, num_heads=12),
        "large": dict(hidden_size=1024, num_layers=24, num_heads=16),
    }[size]
    return DecoderConfig(
        vocab_size=30522,
        max_position_embeddings=512,
        position_embedding="learned",
        scale_attn=True,
        qkv_bias=True,
        out_bias=True,
        layer_norm_eps=1e-12,
        bidirectional=True,
        post_layernorm=True,
        embedding_layernorm=True,
        token_type_vocab=2,
        gelu_exact=True,
        **dims,
        **kw,
    )


def t5(size: str = "base", **kw) -> DecoderConfig:
    """T5 ENCODER presets (t5-small/base/large geometry, v1.0 ReLU MLP):
    RMSNorm (pre-LN, eps 1e-6), a bucketed relative position bias shared by
    every layer, unscaled scores, no biases, no absolute positions. For
    v1.1 (`google/t5-v1_1-*`) pass mlp_activation="gated_gelu"."""
    dims = {
        "small": dict(hidden_size=512, num_layers=6, num_heads=8,
                      intermediate_size=2048, head_dim=64),
        "base": dict(hidden_size=768, num_layers=12, num_heads=12,
                     intermediate_size=3072, head_dim=64),
        "large": dict(hidden_size=1024, num_layers=24, num_heads=16,
                      intermediate_size=4096, head_dim=64),
    }[size]
    return DecoderConfig(
        vocab_size=32128,
        max_position_embeddings=512,
        position_embedding="none",
        scale_attn=False,
        qkv_bias=False,
        out_bias=False,
        layer_norm_eps=1e-6,
        bidirectional=True,
        norm_style="rms",
        relative_attention=True,
        mlp_activation="relu",
        mlp_bias=False,
        **dims,
        **kw,
    )


def tiny(family: str = "neo", vocab_size: int = 257, **kw) -> DecoderConfig:
    """Small configs for tests; same structural flags as the full families."""
    base = dict(vocab_size=vocab_size, hidden_size=64, num_layers=4, num_heads=4,
                max_position_embeddings=128)
    base.update(kw)
    if family == "neo":
        return DecoderConfig(position_embedding="learned", attention_layout="alternating",
                             local_window=8, scale_attn=False, **base)
    if family == "gptj":
        return DecoderConfig(position_embedding="rotary", rotary_dim=8,
                             parallel_residual=True, out_bias=False, **base)
    if family == "bloom":
        return DecoderConfig(position_embedding="alibi", embedding_layernorm=True,
                             qkv_bias=True, **base)
    if family == "bert":
        return DecoderConfig(position_embedding="learned", scale_attn=True,
                             qkv_bias=True, layer_norm_eps=1e-12,
                             bidirectional=True, post_layernorm=True,
                             embedding_layernorm=True, token_type_vocab=2,
                             gelu_exact=True, **base)
    if family == "t5":
        return DecoderConfig(position_embedding="none", scale_attn=False,
                             out_bias=False, layer_norm_eps=1e-6,
                             bidirectional=True, norm_style="rms",
                             relative_attention=True,
                             relative_attention_buckets=8,
                             relative_attention_max_distance=16,
                             mlp_activation="relu", mlp_bias=False,
                             head_dim=16, **base)
    raise ValueError(f"unknown family {family!r}")


def from_jax_config(cfg) -> DecoderConfig:
    """Build the port's config from a JAX `DecoderConfig` (duck-typed: reads
    the same field names; the dtype goes through its numpy name, so this
    module needs no jax)."""
    import numpy as np

    kw = {}
    for f in dataclasses.fields(DecoderConfig):
        val = getattr(cfg, f.name)
        if f.name == "dtype":
            val = getattr(torch, np.dtype(val).name)
        kw[f.name] = val
    return DecoderConfig(**kw)
