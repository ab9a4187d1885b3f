"""Import HuggingFace checkpoints into the port's state dict (counterpart of
`sgpt_tpu/models/hf_loader.py`).

`convert_hf_state_dict` maps an HF state dict of the three GPT families
(GPT-Neo, GPT-J, BLOOM) and of the encoder families (BERT's `BertModel`,
T5's `T5EncoderModel`) to the names of `params.param_shapes`: one entry
per layer and linear weights in torch's [out, in] order, which is HF's
own, so only BLOOM's fused head-major `query_key_value` is split (as the
JAX converter splits it). T5's relative position bias comes from block 0,
the one table every layer shares; its embedding is `shared.weight` or
`encoder.embed_tokens.weight`. `load_pretrained` reads a local checkpoint
directory with `json` and torch alone: `config.json`, then
`model.safetensors`, `pytorch_model.bin` or their sharded
`*.index.json` layout. Safetensors files are read and written by hand
(`read_safetensors`, `save_safetensors`): the format is an 8-byte
little-endian header length, a JSON header of name → dtype, shape and
byte range, then the raw little-endian tensor bytes, so no `safetensors`
or `transformers` package is needed. Nothing is downloaded. One name
table serves both directions: `hf_state_dict` maps the port's names back
to HF's, so a checkpoint can be written (`chip_smoke.py`'s loader check).
"""
from __future__ import annotations

import json
import os
import re
import struct
from typing import Any, Dict, Mapping, Tuple

import torch

from .config import DecoderConfig

# safetensors dtype names ↔ torch dtypes
_ST_DTYPES = {"F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
              "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
              "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool}
_ST_NAMES = {v: k for k, v in _ST_DTYPES.items()}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """All tensors of one .safetensors file, on the CPU."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        base = 8 + n
        out = {}
        for name, info in header.items():
            if name == "__metadata__":
                continue
            begin, end = info["data_offsets"]
            f.seek(base + begin)
            buf = bytearray(f.read(end - begin))
            dtype = _ST_DTYPES[info["dtype"]]
            t = (torch.frombuffer(buf, dtype=dtype) if buf
                 else torch.empty(0, dtype=dtype))
            out[name] = t.reshape(info["shape"])
    return out


def save_safetensors(tensors: Mapping[str, torch.Tensor], path: str) -> None:
    """Write tensors (any device) as one .safetensors file."""
    header: Dict[str, Any] = {"__metadata__": {"format": "pt"}}
    blobs, offset = [], 0
    for name, t in tensors.items():
        flat = t.detach().cpu().reshape(-1).contiguous()
        data = flat.view(torch.uint8).numpy().tobytes() if flat.numel() else b""
        header[name] = {"dtype": _ST_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(data)]}
        blobs.append(data)
        offset += len(data)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)  # the data starts 8-byte aligned
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for data in blobs:
            f.write(data)


def _strip_prefix(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Drop 'transformer.' / 'model.' style prefixes; lm_head keeps its name."""
    return {re.sub(r"^(transformer\.|model\.|bert\.)", "", k): v for k, v in sd.items()}


def _layer_names(pairs: Dict[str, str], prefix: str = "h.{i}.") -> Dict[str, str]:
    return {f"layers.{{i}}.{ours}": prefix + theirs for ours, theirs in pairs.items()}


_FINAL = {"ln_f.scale": "ln_f.weight", "ln_f.bias": "ln_f.bias"}


# port name → HF name ({i}: the layer index), per family. BLOOM's q/k/v (and
# their biases) live fused in h.{i}.self_attention.query_key_value: split and
# joined in code. T5's MLP names depend on its activation (`_T5_MLP`).
_NAMES = {
    "neo": {"wte": "wte.weight", "wpe": "wpe.weight", **_layer_names({
        "ln1.scale": "ln_1.weight", "ln1.bias": "ln_1.bias",
        "ln2.scale": "ln_2.weight", "ln2.bias": "ln_2.bias",
        "attn.wq": "attn.attention.q_proj.weight", "attn.wk": "attn.attention.k_proj.weight",
        "attn.wv": "attn.attention.v_proj.weight", "attn.wo": "attn.attention.out_proj.weight",
        "attn.bo": "attn.attention.out_proj.bias",
        "mlp.wi": "mlp.c_fc.weight", "mlp.bi": "mlp.c_fc.bias",
        "mlp.wo": "mlp.c_proj.weight", "mlp.bo": "mlp.c_proj.bias"}), **_FINAL},
    "gptj": {"wte": "wte.weight", **_layer_names({
        "ln1.scale": "ln_1.weight", "ln1.bias": "ln_1.bias",
        "attn.wq": "attn.q_proj.weight", "attn.wk": "attn.k_proj.weight",
        "attn.wv": "attn.v_proj.weight", "attn.wo": "attn.out_proj.weight",
        "mlp.wi": "mlp.fc_in.weight", "mlp.bi": "mlp.fc_in.bias",
        "mlp.wo": "mlp.fc_out.weight", "mlp.bo": "mlp.fc_out.bias"}), **_FINAL},
    "bloom": {"wte": "word_embeddings.weight",
              "emb_ln.scale": "word_embeddings_layernorm.weight",
              "emb_ln.bias": "word_embeddings_layernorm.bias", **_layer_names({
                  "ln1.scale": "input_layernorm.weight", "ln1.bias": "input_layernorm.bias",
                  "ln2.scale": "post_attention_layernorm.weight",
                  "ln2.bias": "post_attention_layernorm.bias",
                  "attn.wo": "self_attention.dense.weight",
                  "attn.bo": "self_attention.dense.bias",
                  "mlp.wi": "mlp.dense_h_to_4h.weight", "mlp.bi": "mlp.dense_h_to_4h.bias",
                  "mlp.wo": "mlp.dense_4h_to_h.weight", "mlp.bo": "mlp.dense_4h_to_h.bias"}),
              **_FINAL},
    # HF BertModel (the pooler is not read: the engine pools the states)
    "bert": {"wte": "embeddings.word_embeddings.weight",
             "wpe": "embeddings.position_embeddings.weight",
             "wtt": "embeddings.token_type_embeddings.weight",
             "emb_ln.scale": "embeddings.LayerNorm.weight",
             "emb_ln.bias": "embeddings.LayerNorm.bias", **_layer_names({
                 "attn.wq": "attention.self.query.weight", "attn.bq": "attention.self.query.bias",
                 "attn.wk": "attention.self.key.weight", "attn.bk": "attention.self.key.bias",
                 "attn.wv": "attention.self.value.weight", "attn.bv": "attention.self.value.bias",
                 "attn.wo": "attention.output.dense.weight",
                 "attn.bo": "attention.output.dense.bias",
                 "ln1.scale": "attention.output.LayerNorm.weight",
                 "ln1.bias": "attention.output.LayerNorm.bias",
                 "mlp.wi": "intermediate.dense.weight", "mlp.bi": "intermediate.dense.bias",
                 "mlp.wo": "output.dense.weight", "mlp.bo": "output.dense.bias",
                 "ln2.scale": "output.LayerNorm.weight", "ln2.bias": "output.LayerNorm.bias"},
                 "encoder.layer.{i}.")},
    # HF T5EncoderModel (`wte` is added in `_names`: shared.weight or
    # encoder.embed_tokens.weight)
    "t5": {"rel_bias": "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight",
           "ln_f.scale": "encoder.final_layer_norm.weight", **_layer_names({
               "ln1.scale": "layer.0.layer_norm.weight",
               "attn.wq": "layer.0.SelfAttention.q.weight",
               "attn.wk": "layer.0.SelfAttention.k.weight",
               "attn.wv": "layer.0.SelfAttention.v.weight",
               "attn.wo": "layer.0.SelfAttention.o.weight",
               "ln2.scale": "layer.1.layer_norm.weight",
               "mlp.wo": "layer.1.DenseReluDense.wo.weight"}, "encoder.block.{i}.")},
}
_T5_MLP = {False: {"mlp.wi": "layer.1.DenseReluDense.wi.weight"},
           True: {"mlp.wi": "layer.1.DenseReluDense.wi_0.weight",
                  "mlp.wg": "layer.1.DenseReluDense.wi_1.weight"}}
_HEAD = {"lm_head.w": "lm_head.weight", "lm_head.b": "lm_head.bias"}
_QKV = "h.{i}.self_attention.query_key_value."
ENCODER_FAMILIES = ("bert", "t5")


def _names(cfg: DecoderConfig, family: str, wte: str = "shared.weight"):
    """(port name, HF name) of every tensor but BLOOM's fused q/k/v and the
    head. wte: T5's embedding name."""
    if family not in _NAMES:
        raise ValueError(f"unknown family {family!r}")
    table = dict(_NAMES[family])
    if family == "t5":
        table["wte"] = wte
        table.update(_layer_names(_T5_MLP[cfg.mlp_activation == "gated_gelu"],
                                  "encoder.block.{i}."))
    for ours, theirs in table.items():
        for i in range(cfg.num_layers) if "{i}" in ours else (0,):
            yield ours.format(i=i), theirs.format(i=i)


def convert_hf_state_dict(state_dict: Mapping[str, torch.Tensor], cfg: DecoderConfig,
                          family: str, dtype: torch.dtype = torch.float32
                          ) -> Dict[str, torch.Tensor]:
    """family: 'neo' | 'gptj' | 'bloom' | 'bert' | 't5'. Returns the port's
    state dict in `dtype` (an `lm_head.w`, and `lm_head.b`, when the HF
    dict of a GPT family has a head)."""
    sd = _strip_prefix(state_dict)
    wte = "shared.weight" if "shared.weight" in sd else "encoder.embed_tokens.weight"
    out = {ours: sd[theirs] for ours, theirs in _names(cfg, family, wte)}
    if family == "bloom":
        H, Dh, D = cfg.num_heads, cfg.head_size, cfg.hidden_size
        for i in range(cfg.num_layers):
            # fused head-major: weight (3·D, D) viewed as (H, 3, Dh, D)
            w = sd[_QKV.format(i=i) + "weight"].reshape(H, 3, Dh, D)
            b = sd[_QKV.format(i=i) + "bias"].reshape(H, 3, Dh)
            for j, name in enumerate("qkv"):
                out[f"layers.{i}.attn.w{name}"] = w[:, j].reshape(H * Dh, D)
                out[f"layers.{i}.attn.b{name}"] = b[:, j].reshape(H * Dh)
    if "lm_head.weight" in sd and family not in ENCODER_FAMILIES:
        out.update({ours: sd[theirs] for ours, theirs in _HEAD.items() if theirs in sd})
    return {k: v.to(dtype).contiguous() for k, v in out.items()}


def hf_state_dict(state_dict: Mapping[str, torch.Tensor], cfg: DecoderConfig,
                  family: str) -> Dict[str, torch.Tensor]:
    """The inverse of `convert_hf_state_dict`: the port's state dict in HF
    names (a base model's, and `lm_head.*` for a separate head), BLOOM's
    q/k/v joined head-major again. For writing checkpoints."""
    sd = state_dict
    out = {theirs: sd[ours] for ours, theirs in _names(cfg, family)}
    if family == "bloom":
        H, Dh, D = cfg.num_heads, cfg.head_size, cfg.hidden_size
        for i in range(cfg.num_layers):
            p = f"layers.{i}.attn."
            out[_QKV.format(i=i) + "weight"] = torch.stack(
                [sd[p + f"w{n}"].reshape(H, Dh, D) for n in "qkv"], 1).reshape(3 * D, D)
            out[_QKV.format(i=i) + "bias"] = torch.stack(
                [sd[p + f"b{n}"].reshape(H, Dh) for n in "qkv"], 1).reshape(3 * D)
    out.update({theirs: sd[ours] for ours, theirs in _HEAD.items() if ours in sd})
    return out


_MISSING = object()


def _get(hf_config, *names, default=_MISSING):
    """The first of `names` that a config object (attribute) or a config.json
    dict (key) holds."""
    for n in names:
        val = (hf_config.get(n, _MISSING) if isinstance(hf_config, Mapping)
               else getattr(hf_config, n, _MISSING))
        if val is not _MISSING:
            return val
    if default is _MISSING:
        raise KeyError(f"HF config has none of {names}")
    return default


def config_from_hf(hf_config, family: str) -> DecoderConfig:
    """A DecoderConfig from a transformers config object or a config.json dict."""
    eps = _get(hf_config, "layer_norm_epsilon", default=1e-5)
    if family == "neo":
        flags = [a for pattern, n in _get(hf_config, "attention_types")
                 for a in pattern * n]
        return DecoderConfig(
            vocab_size=_get(hf_config, "vocab_size"),
            hidden_size=_get(hf_config, "hidden_size"),
            num_layers=_get(hf_config, "num_layers"),
            num_heads=_get(hf_config, "num_heads"),
            max_position_embeddings=_get(hf_config, "max_position_embeddings"),
            intermediate_size=_get(hf_config, "intermediate_size", default=None),
            position_embedding="learned",
            attention_layout="alternating" if "local" in flags else "global",
            local_window=_get(hf_config, "window_size", default=256),
            scale_attn=False, qkv_bias=False, out_bias=True, layer_norm_eps=eps)
    if family == "gptj":
        D = _get(hf_config, "n_embd")
        return DecoderConfig(
            vocab_size=_get(hf_config, "vocab_size"), hidden_size=D,
            num_layers=_get(hf_config, "n_layer"), num_heads=_get(hf_config, "n_head"),
            max_position_embeddings=_get(hf_config, "n_positions"),
            intermediate_size=_get(hf_config, "n_inner", default=None) or 4 * D,
            position_embedding="rotary", rotary_dim=_get(hf_config, "rotary_dim"),
            parallel_residual=True, scale_attn=True, qkv_bias=False, out_bias=False,
            layer_norm_eps=eps)
    if family == "bloom":
        return DecoderConfig(
            vocab_size=_get(hf_config, "vocab_size"),
            hidden_size=_get(hf_config, "n_embed", "hidden_size"),
            num_layers=_get(hf_config, "n_layer", "num_hidden_layers"),
            num_heads=_get(hf_config, "n_head", "num_attention_heads"),
            position_embedding="alibi", embedding_layernorm=True,
            scale_attn=True, qkv_bias=True, out_bias=True, layer_norm_eps=eps)
    if family == "t5":
        act = _get(hf_config, "feed_forward_proj", default="relu")
        return DecoderConfig(
            vocab_size=_get(hf_config, "vocab_size"), hidden_size=_get(hf_config, "d_model"),
            num_layers=_get(hf_config, "num_layers"), num_heads=_get(hf_config, "num_heads"),
            head_dim=_get(hf_config, "d_kv"), intermediate_size=_get(hf_config, "d_ff"),
            position_embedding="none", scale_attn=False, qkv_bias=False, out_bias=False,
            layer_norm_eps=_get(hf_config, "layer_norm_epsilon", default=1e-6),
            bidirectional=True, norm_style="rms", relative_attention=True,
            relative_attention_buckets=_get(hf_config, "relative_attention_num_buckets"),
            relative_attention_max_distance=_get(hf_config, "relative_attention_max_distance",
                                                 default=128),
            mlp_activation="gated_gelu" if "gated" in act else "relu", mlp_bias=False)
    if family == "bert":
        return DecoderConfig(
            vocab_size=_get(hf_config, "vocab_size"),
            hidden_size=_get(hf_config, "hidden_size"),
            num_layers=_get(hf_config, "num_hidden_layers"),
            num_heads=_get(hf_config, "num_attention_heads"),
            max_position_embeddings=_get(hf_config, "max_position_embeddings"),
            intermediate_size=_get(hf_config, "intermediate_size"),
            position_embedding="learned", scale_attn=True, qkv_bias=True, out_bias=True,
            layer_norm_eps=_get(hf_config, "layer_norm_eps", default=1e-12),
            bidirectional=True, post_layernorm=True, embedding_layernorm=True,
            token_type_vocab=_get(hf_config, "type_vocab_size"), gelu_exact=True)
    raise ValueError(f"unknown family {family!r}")


FAMILY_PATTERNS = (
    ("bloom", ("bloom",)),
    ("gptj", ("gpt-j", "gptj", "6.1b", "5.8b")),
    ("neo", ("gpt-neo", "gptneo", "125m", "1.3b", "2.7b")),
    ("t5", ("t5",)),
    # last: "bert" also matches roberta/distilbert names, which are NOT
    # this architecture — prefer config.json's model_type where it exists
    ("bert", ("bert",)),
)

# config.json's model_type → family
_MODEL_TYPES = {"gpt_neo": "neo", "gptj": "gptj", "bloom": "bloom", "bert": "bert",
                "t5": "t5"}


def guess_family(name: str) -> str:
    low = name.lower()
    for fam, pats in FAMILY_PATTERNS:
        if any(p in low for p in pats):
            return fam
    return "neo"


def _read_weights(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a checkpoint directory: one safetensors or .bin file,
    or the shards an `*.index.json` names (safetensors first)."""
    for stem, reader in (("model.safetensors", read_safetensors),
                         ("pytorch_model.bin",
                          lambda f: torch.load(f, map_location="cpu", weights_only=True))):
        single, index = os.path.join(path, stem), os.path.join(path, stem + ".index.json")
        if os.path.exists(single):
            return dict(reader(single))
        if os.path.exists(index):
            with open(index) as f:
                files = sorted(set(json.load(f)["weight_map"].values()))
            sd: Dict[str, torch.Tensor] = {}
            for name in files:
                sd.update(reader(os.path.join(path, name)))
            return sd
    raise FileNotFoundError(f"{path}: no model.safetensors, pytorch_model.bin or "
                            "their .index.json")


def load_pretrained(path: str, dtype: torch.dtype = torch.float32
                    ) -> Tuple[Dict[str, torch.Tensor], DecoderConfig]:
    """Load an HF checkpoint from a local directory: (state dict, cfg).

    The family comes from config.json's model_type, else from the path's
    name. A tied head (`tie_word_embeddings`, HF's default except for
    GPT-J) drops `lm_head.*`, as the JAX loader does, so `Decoder.logits`
    uses `wte`; an untied one (GPT-J) is kept. BERT and T5 load their
    encoder alone (the JAX loader's `AutoModel` and `T5EncoderModel`): a
    head, a pooler and T5's decoder half are not read."""
    cfg_file = os.path.join(path, "config.json")
    if not os.path.isfile(cfg_file):
        raise FileNotFoundError(
            f"{path!r} is not a local checkpoint directory (no config.json); the port "
            "loads local checkpoints only, nothing is downloaded")
    with open(cfg_file) as f:
        hf_config = json.load(f)
    family = _MODEL_TYPES.get(hf_config.get("model_type")) or guess_family(path)
    cfg = config_from_hf(hf_config, family)
    sd = _read_weights(path)
    if hf_config.get("tie_word_embeddings", family != "gptj"):
        sd = {k: v for k, v in sd.items() if not k.startswith("lm_head.")}
    return convert_hf_state_dict(sd, cfg, family, dtype=dtype), cfg
