"""GradCache: contrastive batches larger than device memory allows
(counterpart of `sgpt_tpu/training/gradcache.py`).

  1. encode every chunk of every tower under `no_grad`,
  2. differentiate the loss with respect to the (small) representations,
  3. re-encode each chunk with grad and call `backward()` on the surrogate
     sum(reps · rep_grad), whose gradient with respect to the parameters is
     the true loss gradient; `.grad` accumulates over the chunks.

Peak memory is one chunk's activations plus the representations. The
decoder has no dropout, so the second forward replays the first exactly and
needs no RNG capture (the torch original's `RandContext`).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence

import torch


def chunk_tree(tree: Dict[str, Any], chunk_size: int) -> Dict[str, Any]:
    """{name: (N, ...)} → {name: (N // chunk_size, chunk_size, ...)}; N must
    divide evenly (the trainer trims a ragged batch first)."""

    def rechunk(x):
        n = x.shape[0]
        if n % chunk_size:
            raise ValueError(f"batch {n} not divisible by chunk {chunk_size}")
        return x.reshape(n // chunk_size, chunk_size, *x.shape[1:])

    return {k: rechunk(v) for k, v in tree.items()}


def _chunks(tower: Dict[str, Any]) -> List[Dict[str, Any]]:
    n = next(iter(tower.values())).shape[0]
    return [{k: v[i] for k, v in tower.items()} for i in range(n)]


def gradcache_backward(encode_fn: Callable[[Dict[str, Any]], torch.Tensor],
                       loss_fn: Callable[..., torch.Tensor],
                       towers: Sequence[Dict[str, Any]]) -> torch.Tensor:
    """Loss of chunked towers, with the parameters' gradients accumulated
    into their `.grad`.

    encode_fn(chunk) -> (chunk, D) representations; loss_fn(*tower_reps) ->
    scalar (e.g. `losses.mnrl_loss`); each tower is {name: (n_chunks, chunk,
    ...)} (see `chunk_tree`). Returns the loss, detached."""
    # Pass 1: chunked encode, no autograd graph kept.
    with torch.no_grad():
        reps = [torch.cat([encode_fn(c) for c in _chunks(t)]) for t in towers]
    # Loss and its gradient with respect to the representations only.
    reps = [r.detach().requires_grad_() for r in reps]
    loss = loss_fn(*reps)
    rep_grads = torch.autograd.grad(loss, reps)
    # Pass 2: chunked re-encode with the surrogate; .grad accumulates.
    for tower, rg in zip(towers, rep_grads):
        chunks = _chunks(tower)
        for chunk, cache in zip(chunks, rg.split(rg.shape[0] // len(chunks))):
            (encode_fn(chunk) * cache).sum().backward()
    return loss.detach()
