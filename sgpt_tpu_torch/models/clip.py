"""CLIP dual tower, text transformer and ViT (counterpart of `sgpt_tpu/models/clip.py`).

Backs the sentence-transformers `models.CLIPModel`: a mixed list of texts and
images embeds, tower by tower, into one array in input order. Both towers
are the port's `Decoder` under different config flags:

  text tower:   causal attention (on the card K1, the fused short-T
                kernel, at T ≤ 77), learned positions, quick-GELU MLP,
                pooled at the EOT token (the highest id in the row, HF
                `CLIPTextModel`'s argmax), then `text_proj`.
  vision tower: `patchify` (a reshape) and one matmul with `patch_w` (the
                strided Conv2d of the reference is exactly a linear map
                over flattened patches), the class token prepended (the
                tower's 1-row `wte`), learned positions, `emb_ln` (HF
                `pre_layrnorm`), bidirectional blocks (the decoder's plain
                attention: no TPU kernel computes them), ln_f (HF
                `post_layernorm`), pooled at the class token, then
                `visual_proj`.

Layout: the towers' parameters are `Decoder` state dicts under `text.` and
`vision.`; `patch_w` (D, 3·p·p), `text_proj` (P, D) and `visual_proj`
(P, D) are linear weights in torch's [out, in] order, the transposes of the
JAX tree's; `logit_scale` is a scalar. `clip_from_jax` and
`convert_hf_clip` convert a JAX tree and an HF `CLIPModel` state dict.
Images are (B, 3, S, S) float arrays already resized and normalised;
`preprocess_images` does CLIPProcessor's resize, center crop and
normalisation for raw uint8 arrays on the host (a copy of the JAX one).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .config import DecoderConfig
from .decoder import Decoder
from .hf_loader import _get
from .params import _to_torch, init_params, param_shapes, params_from_jax
from .precision import matmul_precision

# CLIPProcessor normalisation constants (HF image_processing_clip.py)
IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    text: DecoderConfig
    vision: DecoderConfig
    image_size: int = 224
    patch_size: int = 32
    projection_dim: int = 512

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    def replace(self, **kw) -> "CLIPConfig":
        return dataclasses.replace(self, **kw)


def _tower(D, L, H, *, causal: bool, ctx: int, quick=True, **kw) -> DecoderConfig:
    return DecoderConfig(
        vocab_size=kw.pop("vocab_size", 1), hidden_size=D, num_layers=L,
        num_heads=H, max_position_embeddings=ctx,
        position_embedding="learned", scale_attn=True,
        qkv_bias=True, out_bias=True, layer_norm_eps=1e-5,
        bidirectional=not causal, mlp_activation="quick_gelu" if quick else None,
        **kw)


def clip_vit_b_32(**kw) -> CLIPConfig:
    """openai/clip-vit-base-patch32 geometry."""
    return CLIPConfig(
        text=_tower(512, 12, 8, causal=True, ctx=77, vocab_size=49408),
        vision=_tower(768, 12, 12, causal=False, ctx=50,
                      embedding_layernorm=True),
        image_size=224, patch_size=32, projection_dim=512, **kw)


def clip_tiny(**kw) -> CLIPConfig:
    """Small config for tests (mirrors models.config.tiny)."""
    return CLIPConfig(
        text=_tower(32, 2, 2, causal=True, ctx=16, vocab_size=99),
        vision=_tower(48, 2, 2, causal=False, ctx=10,
                      embedding_layernorm=True),
        image_size=12, patch_size=4, projection_dim=24, **kw)


def clip_param_shapes(cfg: CLIPConfig) -> Dict[str, tuple]:
    """Name → shape of every parameter; the vision tower's `wte` is the
    class embedding (1 row) and its context 1 + num_patches."""
    p = cfg.patch_size
    shapes = {f"text.{k}": v for k, v in param_shapes(cfg.text).items()}
    shapes.update({f"vision.{k}": v for k, v in param_shapes(cfg.vision).items()})
    shapes.update({"patch_w": (cfg.vision.hidden_size, 3 * p * p),
                   "text_proj": (cfg.projection_dim, cfg.text.hidden_size),
                   "visual_proj": (cfg.projection_dim, cfg.vision.hidden_size),
                   "logit_scale": ()})
    return shapes


def init_clip_params(cfg: CLIPConfig, generator: Optional[torch.Generator] = None
                     ) -> Dict[str, torch.Tensor]:
    """Random init with the JAX package's distribution (each tower as
    `init_params`; the patch and projection weights 0.02·N(0, 1);
    logit_scale ln(1/0.07), HF's init), drawn in float32 on the CPU from
    `generator`."""
    out = {f"text.{k}": v for k, v in init_params(cfg.text, generator).items()}
    out.update({f"vision.{k}": v for k, v in init_params(cfg.vision, generator).items()})
    for name, shape in clip_param_shapes(cfg).items():
        if name in ("patch_w", "text_proj", "visual_proj"):
            out[name] = 0.02 * torch.randn(shape, generator=generator)
    out["logit_scale"] = torch.tensor(2.6592)
    return out


class CLIP(nn.Module):
    """The dual tower: `text` and `vision` Decoders, the patch embedding and
    the two projections, in `cfg.text.dtype` on `device` (the card by
    default; CPU use passes device="cpu"). weights: a state dict
    (`clip_from_jax`, `convert_hf_clip`), else random from `generator`
    (`init_clip_params`)."""

    def __init__(self, cfg: CLIPConfig, *, device="cuda",
                 generator: Optional[torch.Generator] = None,
                 weights: Optional[Mapping[str, torch.Tensor]] = None):
        super().__init__()
        if weights is None:
            weights = init_clip_params(cfg, generator)
        self.cfg = cfg
        tower = {t: {k[len(t) + 1:]: v for k, v in weights.items() if k.startswith(t + ".")}
                 for t in ("text", "vision")}
        self.text = Decoder(cfg.text, device=device, weights=tower["text"])
        self.vision = Decoder(cfg.vision, device=device, weights=tower["vision"])
        factory = dict(device=torch.device(device), dtype=cfg.text.dtype)
        for name in ("patch_w", "text_proj", "visual_proj", "logit_scale"):
            setattr(self, name, nn.Parameter(weights[name].to(**factory).contiguous()))
        left = set(weights) - set(self.state_dict())
        if left:
            raise ValueError(f"CLIP: weights not consumed: {sorted(left)}")

    @property
    def device(self) -> torch.device:
        return self.patch_w.device


def patchify(pixels: torch.Tensor, patch: int) -> torch.Tensor:
    """(B, 3, H, W) → (B, P, 3·p·p), channel-major within a patch: the
    flatten order of HF's Conv2d weight (D, 3, p, p), so one matmul with
    `patch_w` is the strided convolution."""
    B, C, H, W = pixels.shape
    gh, gw = H // patch, W // patch
    x = pixels.reshape(B, C, gh, patch, gw, patch)
    x = x.permute(0, 2, 4, 1, 3, 5)                         # (B, gh, gw, C, p, p)
    return x.reshape(B, gh * gw, C * patch * patch)


def encode_image(model: CLIP, pixels: torch.Tensor) -> torch.Tensor:
    """(B, 3, H, W) preprocessed pixels → (B, projection_dim) image
    embeddings (not normalised; HF `CLIPModel.get_image_features`)."""
    cfg = model.cfg
    dt = cfg.vision.dtype
    with matmul_precision(cfg.vision.matmul_precision):
        emb = F.linear(patchify(pixels.to(dt), cfg.patch_size), model.patch_w.to(dt))
        B = emb.shape[0]
        cls = model.vision.wte.to(dt).expand(B, 1, emb.shape[-1])
        embeds = torch.cat([cls, emb], dim=1)               # (B, 1 + P, D)
        mask = torch.ones(embeds.shape[:2], dtype=torch.int32, device=embeds.device)
        pooled = model.vision(None, mask, inputs_embeds=embeds)[:, 0]   # after ln_f
        return F.linear(pooled, model.visual_proj.to(pooled.dtype))


def encode_text(model: CLIP, input_ids: torch.Tensor, attention_mask: torch.Tensor
                ) -> torch.Tensor:
    """(B, T) token ids → (B, projection_dim) text embeddings, pooled at the
    EOT position, the argmax of each row's ids (CLIP's EOT is the highest
    id in the vocab; the first one on a tie)."""
    cfg = model.cfg
    with matmul_precision(cfg.text.matmul_precision):
        h = model.text(input_ids, attention_mask)
        eot = torch.argmax(input_ids, dim=-1)
        pooled = h[torch.arange(h.shape[0], device=h.device), eot]
        return F.linear(pooled, model.text_proj.to(pooled.dtype))


def preprocess_images(images: Sequence[np.ndarray], image_size: int = 224) -> np.ndarray:
    """uint8 (H, W, 3) arrays → (B, 3, S, S) float32, CLIPProcessor
    semantics: resize shortest side to S (bilinear), center-crop S×S,
    scale to [0,1], normalize with the CLIP mean/std."""
    out = []
    mean = np.asarray(IMAGE_MEAN, np.float32)[:, None, None]
    std = np.asarray(IMAGE_STD, np.float32)[:, None, None]
    for im in images:
        a = np.asarray(im)
        if a.ndim == 2:
            a = np.stack([a] * 3, axis=-1)
        h, w = a.shape[:2]
        scale = image_size / min(h, w)
        nh, nw = max(image_size, round(h * scale)), max(image_size, round(w * scale))
        a = _bilinear_resize(a.astype(np.float32), nh, nw)
        top, left = (nh - image_size) // 2, (nw - image_size) // 2
        a = a[top:top + image_size, left:left + image_size]
        a = a.transpose(2, 0, 1) / 255.0
        out.append((a - mean) / std)
    return np.stack(out)


def _bilinear_resize(img: np.ndarray, nh: int, nw: int) -> np.ndarray:
    h, w = img.shape[:2]
    if (h, w) == (nh, nw):
        return img
    ys = (np.arange(nh) + 0.5) * h / nh - 0.5
    xs = (np.arange(nw) + 0.5) * w / nw - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, w - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    wy = np.clip(ys - y0, 0, 1)[:, None, None]
    wx = np.clip(xs - x0, 0, 1)[None, :, None]
    top = img[y0][:, x0] * (1 - wx) + img[y0][:, x1] * wx
    bot = img[y1][:, x0] * (1 - wx) + img[y1][:, x1] * wx
    return top * (1 - wy) + bot * wy


# ---------------------------------------------------------------------------
# Weight conversion
# ---------------------------------------------------------------------------

_PROJECTIONS = ("patch_w", "text_proj", "visual_proj")


def clip_from_jax(tree: dict, cfg: CLIPConfig) -> Dict[str, torch.Tensor]:
    """The JAX CLIP tree (`init_clip_params`, `convert_hf_clip`: "text" and
    "vision" decoder trees, `patch_w` (3·p·p, D), `text_proj` and
    `visual_proj` (D, P), `logit_scale`) → the port's state dict: each
    tower through `params_from_jax`, the three projections transposed to
    [out, in]. Raises on a leaf it does not consume."""
    left = set(tree) - {"text", "vision", *_PROJECTIONS, "logit_scale"}
    if left:
        raise ValueError(f"clip_from_jax: leaves not consumed: {sorted(left)}")
    sd = {f"text.{k}": v for k, v in params_from_jax(tree["text"], cfg.text).items()}
    sd.update({f"vision.{k}": v for k, v in params_from_jax(tree["vision"], cfg.vision).items()})
    shapes = clip_param_shapes(cfg)
    for name in _PROJECTIONS:
        arr = _to_torch(tree[name]).T.contiguous()
        if tuple(arr.shape) != shapes[name]:
            raise ValueError(f"{name}: shape {tuple(arr.shape)}, expected {shapes[name]}")
        sd[name] = arr
    sd["logit_scale"] = _to_torch(tree["logit_scale"]).reshape(())
    return sd


def _layers(prefix: str, L: int) -> Dict[str, str]:
    names = {"ln1.scale": "layer_norm1.weight", "ln1.bias": "layer_norm1.bias",
             "ln2.scale": "layer_norm2.weight", "ln2.bias": "layer_norm2.bias",
             "mlp.wi": "mlp.fc1.weight", "mlp.bi": "mlp.fc1.bias",
             "mlp.wo": "mlp.fc2.weight", "mlp.bo": "mlp.fc2.bias"}
    for ours, theirs in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"), ("o", "out_proj")):
        names[f"attn.w{ours}"] = f"self_attn.{theirs}.weight"
        names[f"attn.b{ours}"] = f"self_attn.{theirs}.bias"
    return {f"layers.{i}.{ours}": f"{prefix}encoder.layers.{i}.{theirs}"
            for i in range(L) for ours, theirs in names.items()}


def convert_hf_clip(state_dict: Mapping[str, torch.Tensor], cfg: CLIPConfig,
                    dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """An HF `CLIPModel.state_dict()` → the port's state dict in `dtype`
    (the JAX `convert_hf_clip`'s mapping, in torch's layout)."""
    sd = state_dict
    t, v = "text_model.", "vision_model."
    text = {"wte": sd[t + "embeddings.token_embedding.weight"],
            "wpe": sd[t + "embeddings.position_embedding.weight"],
            "ln_f.scale": sd[t + "final_layer_norm.weight"],
            "ln_f.bias": sd[t + "final_layer_norm.bias"]}
    text.update({ours: sd[theirs] for ours, theirs in _layers(t, cfg.text.num_layers).items()})
    vision = {"wte": sd[v + "embeddings.class_embedding"].reshape(1, -1),
              "wpe": sd[v + "embeddings.position_embedding.weight"],
              "emb_ln.scale": sd[v + "pre_layrnorm.weight"],
              "emb_ln.bias": sd[v + "pre_layrnorm.bias"],
              "ln_f.scale": sd[v + "post_layernorm.weight"],
              "ln_f.bias": sd[v + "post_layernorm.bias"]}
    vision.update({ours: sd[theirs]
                   for ours, theirs in _layers(v, cfg.vision.num_layers).items()})
    out = {f"text.{k}": x for k, x in text.items()}
    out.update({f"vision.{k}": x for k, x in vision.items()})
    Dv = cfg.vision.hidden_size
    # Conv2d (D, 3, p, p) → the flattened-patch weight (D, 3·p·p), in
    # patchify's (3, p, p) flatten order
    out["patch_w"] = sd[v + "embeddings.patch_embedding.weight"].reshape(Dv, -1)
    out["text_proj"] = sd["text_projection.weight"]
    out["visual_proj"] = sd["visual_projection.weight"]
    out["logit_scale"] = sd["logit_scale"].reshape(())
    return {k: x.detach().to(dtype).contiguous() for k, x in out.items()}


def clip_config_from_hf(hf_config) -> CLIPConfig:
    """A CLIPConfig from a transformers `CLIPConfig` or its config.json dict."""
    tc, vc = _get(hf_config, "text_config"), _get(hf_config, "vision_config")
    image_size, patch = _get(vc, "image_size"), _get(vc, "patch_size")
    return CLIPConfig(
        text=_tower(_get(tc, "hidden_size"), _get(tc, "num_hidden_layers"),
                    _get(tc, "num_attention_heads"), causal=True,
                    ctx=_get(tc, "max_position_embeddings"), vocab_size=_get(tc, "vocab_size"),
                    intermediate_size=_get(tc, "intermediate_size")),
        vision=_tower(_get(vc, "hidden_size"), _get(vc, "num_hidden_layers"),
                      _get(vc, "num_attention_heads"), causal=False,
                      ctx=1 + (image_size // patch) ** 2, embedding_layernorm=True,
                      intermediate_size=_get(vc, "intermediate_size")),
        image_size=image_size, patch_size=patch,
        projection_dim=_get(hf_config, "projection_dim"))


# ---------------------------------------------------------------------------
# The sentence-transformers runtime
# ---------------------------------------------------------------------------

class CLIPEncoder:
    """ST `models.CLIPModel` runtime semantics: a mixed list of texts and
    images embeds to one (N, projection_dim) float32 array in input order.
    Images are numpy (H, W, 3) uint8 or preprocessed (3, S, S) float
    arrays; everything else is a text. Texts are tokenized with ids clamped
    below EOT (the vocab's top id), cut to the context and closed with EOT;
    each tower runs in batches of `batch_size` on the model's device."""

    def __init__(self, model: CLIP, cfg: CLIPConfig, tokenizer, *,
                 normalize_embeddings: bool = False, batch_size: int = 32):
        if model.cfg != cfg:
            raise ValueError("CLIPEncoder: cfg differs from the model's config")
        self.model, self.cfg = model.eval(), cfg
        self.tokenizer = tokenizer
        self.normalize = normalize_embeddings
        self.batch_size = batch_size
        self.out_dim = cfg.projection_dim

    def _encode_texts(self, texts) -> np.ndarray:
        ctx = self.cfg.text.max_position_embeddings
        eot = self.cfg.text.vocab_size - 1  # CLIP: EOT is the top vocab id
        rows = [[min(i, eot - 1) for i in self.tokenizer.encode(t)][: ctx - 1]
                + [eot] for t in texts]
        T = max(len(r) for r in rows)
        ids = np.zeros((len(rows), T), np.int32)
        mask = np.zeros((len(rows), T), np.int32)
        for i, r in enumerate(rows):
            ids[i, : len(r)] = r
            mask[i, : len(r)] = 1
        dev = self.model.device
        with torch.inference_mode():
            out = encode_text(self.model, torch.from_numpy(ids).to(dev),
                              torch.from_numpy(mask).to(dev))
        return out.float().cpu().numpy()

    def _encode_images(self, images) -> np.ndarray:
        arrs = []
        for im in images:
            a = np.asarray(im)
            if a.ndim == 3 and a.shape[0] == 3 and a.dtype != np.uint8:
                arrs.append(a.astype(np.float32))  # already (3, S, S)
            else:
                arrs.append(preprocess_images([a], self.cfg.image_size)[0])
        with torch.inference_mode():
            out = encode_image(self.model, torch.from_numpy(np.stack(arrs)).to(self.model.device))
        return out.float().cpu().numpy()

    def encode(self, items: Sequence, **_) -> np.ndarray:
        is_image = [not isinstance(x, str) for x in items]
        out = np.zeros((len(items), self.out_dim), np.float32)
        texts = [(i, x) for i, (x, im) in enumerate(zip(items, is_image)) if not im]
        images = [(i, x) for i, (x, im) in enumerate(zip(items, is_image)) if im]
        for group, fn in ((texts, self._encode_texts), (images, self._encode_images)):
            for s in range(0, len(group), self.batch_size):
                chunk = group[s: s + self.batch_size]
                out[[i for i, _ in chunk]] = fn([x for _, x in chunk])
        if self.normalize:
            out /= np.maximum(np.linalg.norm(out, axis=1, keepdims=True), 1e-12)
        return out
