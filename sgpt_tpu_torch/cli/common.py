"""Shared CLI plumbing of the port: logging setup, the mesh flags and model
construction (counterpart of `sgpt_tpu/cli/common.py`).

`--device` names the devices a CLI may use: one device (`cuda`, `cuda:1`,
`cpu`), or a comma-separated list (`cuda:0,cuda:1`, `cpu,cpu`, repeats
allowed), the port's stand-in for the device list JAX sees; `cuda` alone
means every visible card. `--dp`/`--tp` arrange them into a mesh as the JAX
flags do (`build_mesh`).
"""
from __future__ import annotations

import logging


def setup_logging():
    logging.basicConfig(format="%(asctime)s - %(message)s", datefmt="%Y-%m-%d %H:%M:%S",
                        level=logging.INFO)


def add_mesh_args(parser):
    parser.add_argument("--dp", type=int, default=-1,
                        help="data-parallel mesh axis (-1 = all devices / tp)")
    parser.add_argument("--tp", type=int, default=1,
                        help="tensor-parallel mesh axis (Megatron sharding; replaces the "
                        "reference's device_map='auto', sgptce.py:54)")
    return parser


def _device_list(device: str):
    """--device as a device list; None for `cuda` alone (every visible card)."""
    return None if device == "cuda" else [d.strip() for d in device.split(",") if d.strip()]


def build_mesh(args):
    """Mesh from --dp/--tp over the --device list; None for the trivial
    one-device case, as in JAX: dp=1, tp=1 is an explicit single-device
    request, and dp=-1 with tp=1 on one device is too. A mesh the devices
    cannot make exits with the reason; without a card, `--device cuda`
    with a mesh raises (no CPU mesh in its place)."""
    import torch

    from ..parallel import make_mesh

    devices = _device_list(args.device)
    if args.tp == 1 and args.dp == 1:
        return None
    if args.tp == 1 and args.dp == -1:
        n = torch.cuda.device_count() if devices is None else len(devices)
        if n <= 1:
            return None
    try:
        return make_mesh(dp=args.dp, tp=args.tp, devices=devices)
    except ValueError as e:
        raise SystemExit(f"--dp {args.dp} --tp {args.tp} over --device {args.device}: {e}")


def first_device(args, mesh) -> str:
    """The device a CLI builds its model on: the mesh's first device, or
    the first device of --device."""
    if mesh is not None:
        return str(mesh.devices[0, 0])
    devices = _device_list(args.device)
    return "cuda" if devices is None else devices[0]


def maybe_shard(model, mesh):
    """`model` sharded over `mesh` (`parallel.shard_params`), or as it is
    without one. Quantize before sharding."""
    if mesh is None:
        return model
    from ..parallel import shard_params
    return shard_params(model, mesh)


def build_model(model_name: str, *, random_init: bool = False, dtype_str: str = "bfloat16",
                device="cuda", seed: int = 0):
    """(model, cfg, tokenizer), as the JAX `build_model`: with `random_init`
    (`--randominit`, the reference's `--reinit` debugging flag and the
    zero-egress smoke path) a preset chosen from the name in the JAX order
    ("6b", "5.8b", "6.1b": GPT-J-6B; "bert": BERT base, or large; "bloom":
    BLOOM-1b7; "t5": T5's encoder base, or small or large, gated-GELU for
    "v1_1"/"v1.1"; "1.3b", "2.7b", else 125M: GPT-Neo) with weights from
    `seed` and the hash tokenizer bounded by the model's vocab; else the
    local checkpoint directory `model_name` (`hf_loader.load_pretrained`)
    with its own tokenizer (`get_tokenizer(model_name, fallback=False)`:
    real weights refuse the hash tokenizer). As the JAX `build_model`, the
    dtype defaults to bf16 and the config runs at
    `matmul_precision="default"` (TF32 float32 products on the card; a
    float32 checkpoint stays at "highest"); build a `Decoder` from a config
    at "highest" for strict float32. Random weights are drawn where the
    model lives: on the card from a generator there (no host copy of up to
    6B parameters), on the CPU from a host generator."""
    import torch

    from ..models import Decoder, bert, bloom, gpt_j_6b, gpt_neo, t5
    from ..models.hf_loader import load_pretrained
    from ..tokenization import get_tokenizer

    dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype_str]
    low = model_name.lower()
    if not random_init:
        sd, cfg = load_pretrained(model_name, dtype=dtype)
        cfg = cfg.replace(dtype=dtype)
        if dtype != torch.float32:
            cfg = cfg.replace(matmul_precision="default")
        model = Decoder(cfg, device=device, weights=sd)
        return model, cfg, get_tokenizer(model_name, fallback=False)
    if any(s in low for s in ("6b", "5.8b", "6.1b")):
        cfg = gpt_j_6b()
    elif "bert" in low:
        cfg = bert("large" if "large" in low else "base")
    elif "bloom" in low:
        cfg = bloom("1b7")
    elif "t5" in low:
        cfg = t5("large" if "large" in low else "small" if "small" in low else "base")
        if "v1_1" in low or "v1.1" in low:
            cfg = cfg.replace(mlp_activation="gated_gelu")
    else:
        cfg = gpt_neo("1.3b" if "1.3b" in low else "2.7b" if "2.7b" in low else "125m")
    cfg = cfg.replace(dtype=dtype, matmul_precision="default")
    on_card = torch.device(device).type == "cuda" and torch.cuda.is_available()
    generator = torch.Generator(device=device if on_card else "cpu").manual_seed(seed)
    model = Decoder(cfg, device=device, generator=generator)
    return model, cfg, get_tokenizer(None, vocab_size=cfg.vocab_size)
