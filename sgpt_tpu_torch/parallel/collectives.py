"""Collectives of a single-controller mesh: plain functions on lists of
per-device tensors (the port's counterpart of the psum / all_gather that
XLA inserts for the JAX package's shardings).

Each takes one tensor per shard, in shard order, and returns one result per
shard, on that shard's device. Between distinct cards a shard's tensor
reaches another card as a peer copy (`.to(device, non_blocking=True)`,
ordered after the work that wrote it by PyTorch's cross-device copy); on a
repeated device it is the tensor itself. The sums add the shards in shard
order (shard 0 first) on every device, so a device's result, and a run's,
repeats bit for bit; a device that holds several shards computes its
result once, and its shards share it.

Every function is built from `.to()`, `torch.add`, `torch.maximum` and
`torch.cat`, so autograd transposes it: the backward of an all-reduce sums
the gradients of every result into each part (on a repeated device the one
shared result has gathered its shards' gradients first, and passes their sum
on once), and the backward of a gather hands each part its slice. Training
under a mesh adds `sum_grads`: one gradient for all the copies of a leaf.
"""
from __future__ import annotations

from typing import Callable, List, Sequence

import numpy as np
import torch


def _per_device(parts: Sequence[torch.Tensor],
                combine: Callable[[List[torch.Tensor]], torch.Tensor]) -> List[torch.Tensor]:
    """combine(every part moved to d) once for each distinct device d of
    parts, each part's entry the result on its own device."""
    done: dict = {}
    out = []
    for p in parts:
        d = p.device
        if d not in done:
            done[d] = combine([q.to(d, non_blocking=True) for q in parts])
        out.append(done[d])
    return out


def _fold(fn, ts: List[torch.Tensor]) -> torch.Tensor:
    acc = ts[0]
    for t in ts[1:]:
        acc = fn(acc, t)
    return acc


def all_reduce_sum(parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Σ parts on each part's device, added in shard order (shard 0 first)."""
    return _per_device(parts, lambda ts: _fold(torch.add, ts))


def all_reduce_max(parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The elementwise maximum of parts on each part's device (exact in any
    order)."""
    return _per_device(parts, lambda ts: _fold(torch.maximum, ts))


def all_gather(parts: Sequence[torch.Tensor], dim: int = -1) -> List[torch.Tensor]:
    """The parts concatenated along `dim` in shard order, on each part's device."""
    return _per_device(parts, lambda ts: torch.cat(ts, dim=dim))


def reduce_sum_to(parts: Sequence[torch.Tensor], device) -> torch.Tensor:
    """Σ parts on one device, added in shard order."""
    return _fold(torch.add, [p.to(device, non_blocking=True) for p in parts])


def gather_to(parts: Sequence[torch.Tensor], device, dim: int = -1) -> torch.Tensor:
    """The parts concatenated along `dim` in shard order, on one device."""
    return torch.cat([p.to(device, non_blocking=True) for p in parts], dim=dim)


def sum_grads(copies: Sequence[torch.Tensor]) -> None:
    """Give every copy of a leaf (its pieces on the shards that hold it) the
    sum of all the copies' `.grad`, added in shard order (shard 0 first) on
    each copy's device; a copy with no gradient counts as zero. Each copy
    gets its own tensor, and every copy the same bits. No gradient at all
    leaves every `.grad` None."""
    grads = [c.grad for c in copies if c.grad is not None]
    if not grads:
        return
    totals = {d: _fold(torch.add, [g.to(d, non_blocking=True) for g in grads])
              for d in dict.fromkeys(c.device for c in copies)}
    given = set()
    for c in copies:
        t = totals[c.device]
        c.grad = t if c.device not in given else t.clone()
        given.add(c.device)


def rows_to_device(device, *arrays: np.ndarray) -> List[torch.Tensor]:
    """Host rows → `device` without a synchronise: copies to a card go from
    pinned memory with non_blocking=True (PyTorch does not reuse a pinned
    block before its copy completes), so the host goes on to the next batch
    while the card runs this one. On the CPU the tensors share the arrays'
    memory (a build without CUDA cannot pin)."""
    out = [torch.from_numpy(a) for a in arrays]
    if torch.device(device).type == "cuda":
        out = [t.pin_memory().to(device, non_blocking=True) for t in out]
    return out


def copy_rows_to_host(parts: Sequence[torch.Tensor]) -> list:
    """Start the device-to-host copy of row shards without waiting for it:
    each card part is copied into pinned host memory with non_blocking=True
    on its device's current stream, and an event is recorded after the
    copy. Work queued on the stream later does not delay it, as a `.cpu()`
    made later would be (a copy waits for everything queued before it on
    its stream). `wait_rows` returns the rows. CPU parts are kept as they
    are."""
    out = []
    for p in parts:
        p = p.detach()
        if p.device.type != "cuda":
            out.append((p, None))
            continue
        host = torch.empty(p.shape, dtype=p.dtype, pin_memory=True)
        host.copy_(p, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(p.device))
        out.append((host, done))
    return out


def wait_rows(copies: list) -> np.ndarray:
    """The rows of `copy_rows_to_host(parts)` as one host array in shard
    order (`gather_rows`'s dtypes), once each copy's event has completed:
    it waits for the copies, not for what was queued on the streams after
    them."""
    for _, done in copies:
        if done is not None:
            done.synchronize()
    return gather_rows([host for host, _ in copies])


def gather_rows(parts: Sequence[torch.Tensor]) -> np.ndarray:
    """Row shards (dim 0) → one host array in shard order: float rows as
    float32 (exact for bf16), integer and bool rows in their own dtype.
    Blocks until every part is computed."""
    host = [p.detach().cpu() for p in parts]
    host = [h.float() if h.is_floating_point() else h for h in host]
    return torch.cat(host).numpy()
