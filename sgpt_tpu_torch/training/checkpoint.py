"""Checkpointing in a torch-native format (counterpart of
`sgpt_tpu/training/checkpoint.py`).

A checkpoint is a directory: `params.pt` (a nested dict of tensors, e.g.
{"model": state_dict, "aux": {...}}), optionally `opt_state.pt` (the
optimizer's `state_dict()`), and `meta.json` with the step. `torch.save`
keeps every dtype, so bf16 comes back bit for bit, and `load_checkpoint`
reads with `weights_only=True`. Retention pruning keeps the newest step
directories, as ST's fit does.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Optional

import torch


def save_checkpoint(path: str, params: Any, opt_state: Any = None,
                    step: Optional[int] = None, metadata: Optional[dict] = None):
    """Save params (+ optional optimizer state) under `path`."""
    os.makedirs(path, exist_ok=True)
    torch.save(params, os.path.join(path, "params.pt"))
    if opt_state is not None:
        torch.save(opt_state, os.path.join(path, "opt_state.pt"))
    meta = {"step": step, "backend": "torch", **(metadata or {})}
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f)


def load_checkpoint(path: str) -> Any:
    """The params saved by `save_checkpoint`, on the CPU."""
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    if meta.get("backend") != "torch":
        raise ValueError(f"{path}: a {meta.get('backend')!r} checkpoint of the JAX "
                         "package, not a torch one")
    return torch.load(os.path.join(path, "params.pt"), map_location="cpu", weights_only=True)


def prune_checkpoints(root: str, keep: int):
    """Keep the `keep` newest step dirs (numeric names), delete the rest."""
    if not os.path.isdir(root) or keep <= 0:
        return
    steps = sorted((int(d) for d in os.listdir(root) if d.isdigit()))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(root, str(s)), ignore_errors=True)
