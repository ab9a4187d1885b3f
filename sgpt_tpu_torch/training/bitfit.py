"""BitFit, bias-only fine-tuning (counterpart of `sgpt_tpu/training/bitfit.py`).

The mask is a dict parameter name → trainable, over `named_parameters()`.
A parameter is trainable when the last component of its name is a bias
name (LayerNorm `bias` counts, `scale` does not), optionally `wte`, or when
`extra_trainable` accepts its name split into components. The trainer sets
`requires_grad=False` on the rest, which is what the JAX optimizer's zeroing
of frozen updates amounts to.
"""
from __future__ import annotations

from typing import Callable, Dict

from torch import nn

BIAS_NAMES = frozenset({"bias", "bi", "bo", "bq", "bk", "bv"})


def bitfit_mask(model: nn.Module, *, train_wte: bool = False,
                extra_trainable: Callable[[tuple], bool] | None = None) -> Dict[str, bool]:
    """True = trainable. Biases only (+wte / extra predicate if requested)."""
    mask = {}
    for name, _ in model.named_parameters():
        keys = tuple(name.split("."))
        mask[name] = (keys[-1] in BIAS_NAMES
                      or (train_wte and keys[-1] == "wte")
                      or (extra_trainable is not None and bool(extra_trainable(keys))))
    return mask


def trainable_count(model: nn.Module, **mask_kw) -> int:
    mask = bitfit_mask(model, **mask_kw)
    return sum(p.numel() for name, p in model.named_parameters() if mask[name])
