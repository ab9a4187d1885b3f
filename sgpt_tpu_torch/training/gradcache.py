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

Under a mesh (`gradcache_backward_rows`) each chunk's rows are split over
the dp rows, as the JAX trainer shards chunks P(None, "dp", None): dp row r
encodes its block of every chunk with its own encoder, keeps its
representations on its device, and the loss takes one list per tower.
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
    return gradcache_backward_rows([encode_fn], lambda *lists: loss_fn(*[r[0] for r in lists]),
                                   [towers])


def gradcache_backward_rows(encode_fns: Sequence[Callable[[Dict[str, Any]], torch.Tensor]],
                            loss_fn: Callable[..., torch.Tensor],
                            rows: Sequence[Sequence[Dict[str, Any]]]) -> torch.Tensor:
    """`gradcache_backward` over dp rows: rows[r] holds dp row r's towers
    (its block of each chunk, on its device), encode_fns[r] its encoder;
    loss_fn(*per_tower_lists) -> scalar takes, for each tower, the list of
    the rows' (n_local, D) representations (e.g. `losses.mnrl_loss_dp`).
    Pass 2 re-encodes row by row within each chunk, so `.grad` accumulates
    on each row's parameters. Returns the loss, detached."""
    # Pass 1: chunked encode, no autograd graph kept.
    with torch.no_grad():
        reps = [[torch.cat([enc(c) for c in _chunks(t)]) for t in towers]
                for enc, towers in zip(encode_fns, rows)]
    # Loss and its gradient with respect to the representations only.
    reps = [[r.detach().requires_grad_() for r in row] for row in reps]
    loss = loss_fn(*[list(tower) for tower in zip(*reps)])
    grads = torch.autograd.grad(loss, [r for row in reps for r in row])
    n_towers = len(rows[0])
    rep_grads = [grads[i * n_towers:(i + 1) * n_towers] for i in range(len(rows))]
    # Pass 2: chunked re-encode with the surrogate; .grad accumulates.
    for t in range(n_towers):
        per_row = [_chunks(towers[t]) for towers in rows]
        for c in range(len(per_row[0])):
            for enc, chunks, rg in zip(encode_fns, per_row, rep_grads):
                n = rg[t].shape[0] // len(chunks)
                (enc(chunks[c]) * rg[t][c * n:(c + 1) * n]).sum().backward()
    return loss.detach()
