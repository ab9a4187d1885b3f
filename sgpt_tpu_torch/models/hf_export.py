"""Export the port's decoder weights under HuggingFace names (counterpart of
`sgpt_tpu/models/hf_export.py`).

The exact inverse of `hf_loader.convert_hf_state_dict`, through the loader's
own name table (`hf_loader.hf_state_dict`: BLOOM's q/k/v joined head-major
into `query_key_value` again), so that a model trained here (BitFit biases,
TSDAE) loads into the torch / sentence-transformers ecosystem, and back into
the port with `hf_loader.load_pretrained`. Families: `neo`, `gptj`, `bloom`,
as in the JAX module, which has no BERT or T5 branch: any other family
raises its `ValueError("unknown family ...")`.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Mapping, Union

import torch
from torch import nn

from .config import DecoderConfig
from .hf_loader import hf_state_dict

FAMILIES = ("neo", "gptj", "bloom")


def _check_family(family: str) -> None:
    if family not in FAMILIES:
        raise ValueError(f"unknown family {family!r}")


def _state_dict(params: Union[nn.Module, Mapping[str, torch.Tensor]]) -> Mapping[str, torch.Tensor]:
    return params.state_dict() if isinstance(params, nn.Module) else params


def to_hf_state_dict(params: Union[nn.Module, Mapping[str, torch.Tensor]], cfg: DecoderConfig,
                     family: str, style: str = "auto") -> Dict[str, torch.Tensor]:
    """{HF name: fp32 CPU tensor} in torch's [out, in] layout, from a
    `Decoder` or its state dict.

    style: 'base' (the base model's flat keys), 'causal_lm' (the body under
    'transformer.' and the head at top level, as *ForCausalLM.from_pretrained
    expects; required for an untied head such as GPT-J's), or 'auto'
    (causal_lm when the weights hold an `lm_head`). A separate head is
    written as `lm_head.weight` (and `lm_head.bias`) in every style."""
    _check_family(family)
    sd = _state_dict(params)
    out = {k: v.detach().float().cpu().contiguous()
           for k, v in hf_state_dict(sd, cfg, family).items()}
    has_head = "lm_head.w" in sd
    if style == "auto":
        style = "causal_lm" if has_head else "base"
    if style == "causal_lm":
        out = {(k if k.startswith("lm_head.") else f"transformer.{k}"): v
               for k, v in out.items()}
    elif style != "base":
        raise ValueError(f"unknown style {style!r}: base, causal_lm or auto")
    return out


def hf_config(cfg: DecoderConfig, family: str, tied: bool = True) -> dict:
    """The config.json of an HF checkpoint of `family` with `cfg`'s shapes,
    in the keys `hf_loader.config_from_hf` reads. tied: whether the LM head
    is `wte` (False for a separate head: GPT-J's)."""
    _check_family(family)
    D, L, H = cfg.hidden_size, cfg.num_layers, cfg.num_heads
    eps = cfg.layer_norm_eps
    if family == "neo":
        if cfg.attention_layout == "alternating":
            types = [[["global", "local"], L // 2]] + ([[["global"], 1]] if L % 2 else [])
        else:
            types = [[["global"], L]]
        return {"model_type": "gpt_neo", "vocab_size": cfg.vocab_size, "hidden_size": D,
                "num_layers": L, "num_heads": H,
                "max_position_embeddings": cfg.max_position_embeddings,
                "intermediate_size": cfg.intermediate_size, "attention_types": types,
                "window_size": cfg.local_window, "layer_norm_epsilon": eps,
                "tie_word_embeddings": tied}
    if family == "gptj":
        return {"model_type": "gptj", "vocab_size": cfg.vocab_size, "n_embd": D,
                "n_layer": L, "n_head": H, "n_positions": cfg.max_position_embeddings,
                "rotary_dim": cfg.rotary_dim, "n_inner": cfg.intermediate_size,
                "layer_norm_epsilon": eps, "tie_word_embeddings": tied}
    return {"model_type": "bloom", "vocab_size": cfg.vocab_size, "n_embed": D,
            "n_layer": L, "n_head": H, "layer_norm_epsilon": eps,
            "tie_word_embeddings": tied}


def save_hf_checkpoint(path: str, params: Union[nn.Module, Mapping[str, torch.Tensor]],
                       cfg: DecoderConfig, family: str, style: str = "auto"):
    """Write `pytorch_model.bin` (`to_hf_state_dict`, fp32), as the JAX
    function does, and the `config.json` (`hf_config`) that
    `hf_loader.load_pretrained` reads it back with."""
    sd = _state_dict(params)
    os.makedirs(path, exist_ok=True)
    torch.save(to_hf_state_dict(sd, cfg, family, style=style),
               os.path.join(path, "pytorch_model.bin"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf_config(cfg, family, tied="lm_head.w" not in sd), f)
