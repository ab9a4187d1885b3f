"""`matmul_precision` as a PyTorch scope (counterpart of the JAX decoder's
`jax.default_matmul_precision(cfg.matmul_precision)`).

"highest" runs float32 matrix products in full float32; "high" and
"default" let cuBLAS and cuDNN run them in TF32 on the card, which is what
XLA does for "default" on a GPU. The scope sets
`torch.backends.cuda.matmul.allow_tf32` and `torch.backends.cudnn.allow_tf32`
and restores both on exit, also when the body raises. The flags are global to
the process, as PyTorch keeps them: one precision at a time. They change
nothing on the CPU and nothing in the port's hand-written kernels, whose
fp32 paths stay exact fp32. bf16 products are bf16 whatever the scope.
"""
from __future__ import annotations

import contextlib

import torch

# precision name → whether float32 products may run in TF32
_TF32 = {"highest": False, "high": True, "default": True}


@contextlib.contextmanager
def matmul_precision(name: str):
    """Run the body with float32 matrix products at `name` ("highest",
    "high" or "default"); any other name raises ValueError."""
    if name not in _TF32:
        raise ValueError(f"matmul_precision {name!r}: expected one of {sorted(_TF32)}")
    mm, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = (mm.allow_tf32, cudnn.allow_tf32)
    mm.allow_tf32 = cudnn.allow_tf32 = _TF32[name]
    try:
        yield
    finally:
        mm.allow_tf32, cudnn.allow_tf32 = saved
