"""Ring attention: causal attention with the sequence axis sharded over a
mesh (counterpart of `sgpt_tpu/ops/ring_attention.py`).

One process drives every shard, as the port's meshes do: shard r holds
positions [r·T_local, (r+1)·T_local) of q, k, v and the key mask on its
device. Q stays where it is; K, V and the key mask rotate around the ring
by peer copies (`.to(next device)`; on a repeated device the tensor itself),
and each shard folds every block it receives into an online-softmax state
(running maximum, denominator and numerator, fp32). The ring folds n−1
times with a rotation, then once more without one. Key positions are
global (src_rank·T_local + arange), so causality, the local window of
GPT-Neo's layers and ALiBi (slope_h · key position, the right-padding form)
hold across shards; whole blocks in the future fold as all-masked. The mask
constant is -1e30; a row with no valid key anywhere returns 0.

The JAX module computes this in plain shard_map + XLA, with no Pallas
kernel, so the port computes it with plain tensor ops: the score and P·V
products in fp32 at "highest" (`matmul_precision`), P cast to V's dtype
before its product, as the JAX einsums with `preferred_element_type=fp32`.
Every op is differentiable, so autograd gives the ring's backward (the
transposed products take the precision of the scope the backward runs in).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

NEG = -1e30  # the JAX module's mask constant


def _fold(q, k, v, kv_mask, q_pos, kv_start: int, state, scale: float, window: int,
          slopes: Optional[torch.Tensor]):
    """Fold one K/V block into the online-softmax state (m, l, acc)."""
    from ..models.precision import matmul_precision  # models imports this module

    m_prev, l_prev, acc = state
    with matmul_precision("highest"):
        s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    if scale != 1.0:
        s = s * scale
    kv_pos = kv_start + torch.arange(k.shape[2], device=q.device)
    if slopes is not None:
        s = s + slopes[None, :, None, None] * kv_pos.float()[None, None, None, :]
    ok = kv_pos[None, :] <= q_pos[:, None]
    if window > 0:
        ok = ok & (kv_pos[None, :] > q_pos[:, None] - window)
    ok = ok[None, None] & kv_mask[:, None, None, :].bool()
    s = torch.where(ok, s, torch.full((), NEG, device=s.device))
    m_new = torch.maximum(m_prev, s.max(-1, keepdim=True).values)
    alpha = torch.exp(m_prev - m_new)
    p = torch.exp(s - m_new)
    l_new = l_prev * alpha + p.sum(-1, keepdim=True)
    with matmul_precision("highest"):
        pv = torch.matmul(p.to(v.dtype).float(), v.float())
    return m_new, l_new, acc * alpha + pv


def ring_attention_shards(qs: Sequence[torch.Tensor], ks: Sequence[torch.Tensor],
                          vs: Sequence[torch.Tensor], key_masks: Sequence[torch.Tensor],
                          alibi_slopes: Optional[torch.Tensor] = None, *,
                          scale: float = 1.0, window: int = 0) -> List[torch.Tensor]:
    """Ring attention over shard lists: qs[r], ks[r], vs[r] (B, H, T_local,
    Dh) and key_masks[r] (B, T_local) on shard r's device, in ring order.
    Returns shard r's (B, H, T_local, Dh) output, in q's dtype, on its
    device."""
    n = len(qs)
    devices = [q.device for q in qs]
    B, H, T_local, Dh = qs[0].shape
    slopes = [None if alibi_slopes is None else alibi_slopes.float().to(d) for d in devices]
    q_pos = [r * T_local + torch.arange(T_local, device=d) for r, d in enumerate(devices)]
    state = [(torch.full((B, H, T_local, 1), NEG, device=d),
              torch.zeros((B, H, T_local, 1), device=d),
              torch.zeros((B, H, T_local, Dh), device=d)) for d in devices]
    kv = list(zip(ks, vs, key_masks))
    for step in range(n):
        state = [_fold(qs[r], *kv[r], q_pos[r], ((r - step) % n) * T_local, state[r], scale,
                       window, slopes[r]) for r in range(n)]
        if step < n - 1:  # rotate: shard r receives shard r-1's block
            kv = [tuple(t.to(devices[r], non_blocking=True) for t in kv[(r - 1) % n])
                  for r in range(n)]
    out = []
    for q, (m, l, acc) in zip(qs, state):
        # a row with no valid key anywhere keeps m == NEG: its p was 1 for
        # every key, so acc / l would be mean(V); it returns 0 instead
        dead = m <= NEG / 2
        l = torch.where(dead, torch.ones((), device=l.device), l)
        out.append(torch.where(dead, torch.zeros((), device=acc.device), acc / l).to(q.dtype))
    return out


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, key_mask: torch.Tensor,
                   alibi_slopes: Optional[torch.Tensor] = None, *, mesh, axis: str = "dp",
                   scale: float = 1.0, window: int = 0) -> torch.Tensor:
    """q, k, v: (B, H, T, Dh); key_mask: (B, T). T is sharded over
    `mesh.devices[:, 0]` (the `dp` axis, the only one the ring runs over)
    and must divide by its size. Returns (B, H, T, Dh) on q's device; equal
    to single-device causal attention (fp32 state, "highest" products)."""
    if axis != "dp":
        raise ValueError(f"ring_attention: the ring runs over the mesh's 'dp' axis, not {axis!r}")
    devices = list(mesh.devices[:, 0])
    n, T = len(devices), q.shape[2]
    if T % n:
        raise ValueError(f"ring_attention: T={T} does not divide by the {n} ring devices")
    t = T // n

    def cut(x, dim):
        return [x.narrow(dim, r * t, t).to(d, non_blocking=True) for r, d in enumerate(devices)]

    outs = ring_attention_shards(cut(q, 2), cut(k, 2), cut(v, 2), cut(key_mask, 1),
                                 alibi_slopes, scale=scale, window=window)
    return torch.cat([o.to(q.device) for o in outs], dim=2)
