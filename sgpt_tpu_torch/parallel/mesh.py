"""Device meshes (counterpart of `sgpt_tpu/parallel/mesh.py`).

One process drives every device of a mesh, as the JAX package's single
controller does: a `Mesh` is a (dp, tp) array of `torch.device`s with the
named axes

    dp — data parallel (rows of a batch, rows of a corpus)
    tp — tensor parallel (Megatron sharding of the decoder's weights)

and the code that runs on it (`parallel/sharding.py`, the engine, the
ranker, the indexes) launches each shard's work on its device from this
process; the collectives between shards are plain functions on lists of
per-device tensors (`parallel/collectives.py`). Nothing here opens a socket,
spawns a process or calls `torch.distributed`.

A device list may name one device more than once: `["cpu"] * 8` is the CPU
tests' stand-in for the JAX tests' forced 8-device CPU mesh, and
`["cuda:0", "cuda:0"]` runs dp=2 or tp=2 on one card with every shard's
kernels launched, which checks a mesh's results and measures its per-shard
overhead, not its scaling across cards.

The arrangement logic (`arrange_devices`) is the JAX one: tp groups stay
inside one slice and dp rows are laid out slice-major where devices carry a
`slice_index` (torch devices carry none: a single slice, a row-major
reshape).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch


def _slice_id(d) -> int:
    """Slice index of a device: `slice_index` where a device has one, else 0
    (one slice: every torch device)."""
    s = getattr(d, "slice_index", None)
    return int(s) if s is not None else 0


def _order_within_slice(devices, shape) -> np.ndarray:
    """(rows, cols) arrangement of one slice's devices, in list order (the
    JAX function falls back to list order for devices without physical
    coordinates, and for those whose topology it cannot read)."""
    out = np.empty(len(devices), dtype=object)
    out[:] = list(devices)
    return out.reshape(shape)


def arrange_devices(devices: Sequence, dp: int, tp: int) -> np.ndarray:
    """(dp, tp) device array with tp inside a slice and dp spanning slices.

    Raises if tp would cross a slice boundary or the dp×tp factorization
    does not tile the slices evenly (the JAX rules, word for word)."""
    n = len(devices)
    if dp * tp != n:
        raise ValueError(f"dp*tp = {dp}*{tp} != {n} devices")
    slices: dict = {}
    for d in devices:
        slices.setdefault(_slice_id(d), []).append(d)
    sizes = {len(v) for v in slices.values()}
    if len(slices) == 1:
        return _order_within_slice(devices, (dp, tp))
    if len(sizes) != 1:
        raise ValueError(f"uneven slices: {sorted((k, len(v)) for k, v in slices.items())}")
    per_slice = sizes.pop()
    if per_slice % tp:
        raise ValueError(
            f"tp={tp} does not divide the slice size {per_slice}: a tp group "
            "would span DCN — per-layer collectives must stay on ICI")
    rows = [_order_within_slice(slices[sid], (per_slice // tp, tp)) for sid in sorted(slices)]
    return np.concatenate(rows, axis=0)


class Mesh:
    """A (dp, tp) array of torch devices with the axes ("dp", "tp").

    `devices[i, j]` runs tp shard j of dp row i; `shape` is a dict, as the
    JAX mesh's, so code reads `mesh.shape["dp"]`."""

    axis_names = ("dp", "tp")

    def __init__(self, devices: np.ndarray):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != 2 or devices.size == 0:
            raise ValueError(f"Mesh: a (dp, tp) device array, got shape {devices.shape}")
        self.devices = devices

    @property
    def shape(self) -> dict:
        return {"dp": self.devices.shape[0], "tp": self.devices.shape[1]}

    def __eq__(self, other) -> bool:
        return (isinstance(other, Mesh) and self.devices.shape == other.devices.shape
                and all(a == b for a, b in zip(self.devices.flat, other.devices.flat)))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[[str(d) for d in r] for r in self.devices]})"


def _torch_device(d) -> torch.device:
    """A mesh device: "cuda" names the current card; a CUDA device without a
    card raises, as every entry point of the port does."""
    d = torch.device(d)
    if d.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"make_mesh: device {d} requested but "
                               "torch.cuda.is_available() is False; pass devices=['cpu', ...]")
        if d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
    return d


def placement(device, mesh: Optional[Mesh], who: str) -> torch.device:
    """Where an entry point (engine, ranker, index) runs: with a mesh, the
    mesh's first device (a `device` given must name it); else `device`, the
    card ("cuda") by default, and "cuda" without a card raises."""
    if mesh is not None:
        first = mesh.devices[0, 0]
        d = None if device is None else torch.device(device)
        if d is not None and (d.type != first.type or d.index not in (None, first.index)):
            raise ValueError(f"{who}: device {device} is not the mesh's first device {first}")
        return first
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who}: device 'cuda' requested but torch.cuda.is_available() "
                           "is False; pass device=\"cpu\"")
    return device


def make_mesh(dp: int = -1, tp: int = 1, devices: Optional[Sequence] = None) -> Mesh:
    """Build a (dp, tp) mesh. dp=-1 means 'all remaining devices'.

    devices: torch devices or their names, repeats allowed; None means every
    visible card (`cuda:0` … `cuda:{n-1}`), and raises without one. With
    fewer devices asked for than given (dp*tp < n), a prefix is taken."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no devices given and torch.cuda.is_available() "
                               "is False; pass devices=['cpu', ...] for a CPU mesh")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = [_torch_device(d) for d in devices]
    n = len(devices)
    if dp == -1:
        if n % tp:
            raise ValueError(f"{n} devices not divisible by tp={tp}")
        dp = n // tp
    if dp < 1 or tp < 1:
        raise ValueError(f"make_mesh: dp={dp}, tp={tp}; both must be positive (dp may be -1)")
    if dp * tp > n:
        raise ValueError(f"dp*tp = {dp}*{tp} > {n} devices")
    if dp * tp != n:
        devices = sorted(devices, key=_slice_id)[: dp * tp]
    return Mesh(arrange_devices(devices, dp, tp))
