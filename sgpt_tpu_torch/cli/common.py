"""Shared CLI plumbing of the port: logging setup and model construction
(counterpart of `sgpt_tpu/cli/common.py`, less the mesh flags: meshes are not
ported, ROADMAP Queue 1 item 12)."""
from __future__ import annotations

import logging


def setup_logging():
    logging.basicConfig(format="%(asctime)s - %(message)s", datefmt="%Y-%m-%d %H:%M:%S",
                        level=logging.INFO)


def build_model(model_name: str, *, random_init: bool = False, dtype_str: str = "bfloat16",
                device="cuda", seed: int = 0):
    """(model, cfg, tokenizer): a random-init GPT-Neo preset (`--randominit`,
    the reference's `--reinit` debugging flag and the zero-egress smoke
    path), with weights from `seed` and the hash tokenizer bounded by the
    model's vocab. As the JAX `build_model`, the dtype defaults to bf16 and
    the config runs at `matmul_precision="default"` (TF32 float32 products
    on the card); build a `Decoder` from a config at "highest" for strict
    float32."""
    import torch

    from ..models import Decoder, gpt_neo
    from ..tokenization import get_tokenizer

    if not random_init:
        raise NotImplementedError(
            f"loading checkpoint {model_name!r} needs the HF state-dict loader "
            "(hf_loader) — ROADMAP Queue 1 item 2; pass --randominit")
    low = model_name.lower()
    if any(s in low for s in ("6b", "5.8b", "6.1b", "bert", "bloom", "t5")):
        raise NotImplementedError(f"{model_name!r}: only GPT-Neo is ported "
                                  "(ROADMAP Queue 1 items 3, 14)")
    size = "1.3b" if "1.3b" in low else "2.7b" if "2.7b" in low else "125m"
    dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype_str]
    cfg = gpt_neo(size, dtype=dtype, matmul_precision="default")
    model = Decoder(cfg, device=device, generator=torch.Generator().manual_seed(seed))
    return model, cfg, get_tokenizer(None, vocab_size=cfg.vocab_size)
