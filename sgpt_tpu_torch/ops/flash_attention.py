"""Causal flash attention forward (counterpart of `sgpt_tpu/ops/pallas/flash_attention.py`).

`flash_attention` keeps the JAX signature and the (B, H, T, Dh) layout: an
online softmax over key tiles with fp32 running max, sum and accumulator,
tiles pruned by causality and the sliding window, an optional scale, an
optional ALiBi term (slope_h × key index), a key-padding mask, masked scores
at -1e30, and the logsumexp per query row. T must divide by the block sizes.

On a CUDA tensor it launches the kernel of `csrc/flash_attention.cu` (K3),
on a CPU tensor `flash_attention_reference`, the plain PyTorch version,
which follows the TPU kernel tile by tile and is the kernel's oracle on the
card. A CUDA tensor never takes the plain version: the kernel launches or
the call raises. q, k and v may be strided views, such as the (B, T, H·Dh)
projections seen as (B, H, T, Dh): the kernel reads them through their
strides, and the output has q's strides.

When q, k or v requires grad, the call goes through `FlashAttention`, whose
backward is the flash backward (K4a/K4b) and is not ported yet: it raises.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30  # the TPU kernel's mask constant (the decoder and K1 use -1e9)
TILE = 64        # the kernel's query and key sub-tile: block sizes must divide by it
HEAD_DIMS = (16, 32, 64, 128)

# kernel launches made by `flash_attention` (K3); reset and read by chip_smoke.py
launches = 0

_NO_BACKWARD = ("flash_attention backward: the flash backward kernels (K4a/K4b, "
                "sgpt_tpu/ops/pallas/flash_attention.py:231,276) are not ported yet "
                "— ROADMAP Queue 2 K4, Queue 1 item 11 (long-context training)")


def _blocks(T: int, block_q: int, block_kv: int):
    """The JAX clamp of the block sizes to T, and its divisibility check."""
    block_q, block_kv = min(block_q, T), min(block_kv, T)
    if T % block_q or T % block_kv:
        raise ValueError(f"flash_attention: T={T} does not divide by the blocks "
                         f"(block_q={block_q}, block_kv={block_kv})")
    return block_q, block_kv


def _visited(qi: int, ki: int, block_q: int, block_kv: int, window: int) -> bool:
    """The TPU kernel's tile pruning: whether query tile qi visits key tile
    ki (any causal pair, and with a window any pair inside it)."""
    q_start, k_start = qi * block_q, ki * block_kv
    run = k_start <= q_start + block_q - 1
    if window > 0:
        run = run and k_start + block_kv - 1 > q_start - window
    return run


def flash_attention_reference(q, k, v, key_mask, alibi_slopes=None, *, scale: float = 1.0,
                              window: int = 0, block_q: int = 128, block_kv: int = 128):
    """Plain PyTorch version of the TPU kernel, tile by tile: for each key
    tile, the query tiles that visit it update their fp32 running max m, sum
    l and accumulator (scores q·k in fp32, × scale, + slope·kpos, where(mask,
    s, -1e30); p = exp(s − m_new); P cast to v's dtype before P·V); then
    l == 0 → 1, out = acc / l in q's dtype and lse = m + log(l).

    A padded row that the window leaves with no valid key keeps m = -1e30,
    so p = 1 on every key of the tiles it visits: its output is the mean of
    V over those tiles, which depends on the block sizes, as in the TPU
    kernel. Returns (out (B, H, T, Dh), lse (B, H, T) fp32)."""
    B, H, T, Dh = q.shape
    block_q, block_kv = _blocks(T, block_q, block_kv)
    n_q, n_kv = T // block_q, T // block_kv
    dev, f32 = q.device, torch.float32
    qf = q.float().reshape(B, H, n_q, block_q, Dh)
    m = torch.full((B, H, n_q, block_q, 1), NEG_INF, dtype=f32, device=dev)
    l = torch.zeros((B, H, n_q, block_q, 1), dtype=f32, device=dev)
    acc = torch.zeros((B, H, n_q, block_q, Dh), dtype=f32, device=dev)
    keep = key_mask.to(device=dev) != 0
    qpos = torch.arange(T, device=dev).reshape(n_q, block_q)
    for ki in range(n_kv):
        tiles = [qi for qi in range(n_q) if _visited(qi, ki, block_q, block_kv, window)]
        if not tiles:
            continue
        lo, hi = tiles[0], tiles[-1] + 1  # the visiting tiles are contiguous
        k0 = ki * block_kv
        kpos = torch.arange(k0, k0 + block_kv, device=dev)
        s = torch.einsum("bhnqd,bhkd->bhnqk", qf[:, :, lo:hi],
                         k[:, :, k0:k0 + block_kv].float())
        if scale != 1.0:
            s = s * scale
        qp = qpos[lo:hi, :, None]
        mask = kpos <= qp
        if window > 0:
            mask = mask & (kpos > qp - window)
        mask = mask & keep[:, None, None, None, k0:k0 + block_kv]
        if alibi_slopes is not None:
            slope = alibi_slopes.to(device=dev, dtype=f32)[None, :, None, None, None]
            s = s + slope * kpos.to(f32)
        s = torch.where(mask, s, torch.full((), NEG_INF, device=dev))
        m_prev = m[:, :, lo:hi]
        m_new = torch.maximum(m_prev, s.amax(-1, keepdim=True))
        alpha = torch.exp(m_prev - m_new)
        p = torch.exp(s - m_new)
        l[:, :, lo:hi] = l[:, :, lo:hi] * alpha + p.sum(-1, keepdim=True)
        pv = torch.einsum("bhnqk,bhkd->bhnqd", p.to(v.dtype).float(),
                          v[:, :, k0:k0 + block_kv].float())
        acc[:, :, lo:hi] = acc[:, :, lo:hi] * alpha + pv
        m[:, :, lo:hi] = m_new
    l = torch.where(l == 0.0, torch.ones((), device=dev), l)  # fully masked rows
    out = (acc / l).to(q.dtype).reshape(B, H, T, Dh)
    lse = (m + torch.log(l)).reshape(B, H, T)
    return out, lse


def _check_inputs(q, k, v, key_mask, alibi_slopes, block_q: int, block_kv: int):
    """Refuse what the kernel does not take; returns the int32 key mask and
    the fp32 slopes (or None) the C entry point reads."""
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention: no kernel for device {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_attention: dtype {q.dtype}; the kernel takes float32 "
                        "or bfloat16")
    B, H, T, Dh = q.shape
    for name, t in (("k", k), ("v", v)):
        if (t.shape != q.shape or t.dtype != q.dtype or t.device != q.device
                or t.stride() != q.stride()):
            raise ValueError(f"flash_attention: {name} {tuple(t.shape)} {t.dtype} "
                             f"{t.device} strides {t.stride()} differs from q "
                             f"{tuple(q.shape)} {q.dtype} {q.device} strides {q.stride()}")
    if Dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {Dh}; the kernel takes {HEAD_DIMS}")
    if block_q % TILE or block_kv % TILE:
        raise ValueError(f"flash_attention: blocks ({block_q}, {block_kv}) must divide "
                         f"by the kernel's {TILE}-row tile")
    esize = q.element_size()
    aligned = all(t.data_ptr() % 16 == 0 for t in (q, k, v))
    if q.stride(3) != 1 or not aligned or any(
            (q.stride(i) * esize) % 16 for i in range(3)):
        raise ValueError("flash_attention: q/k/v need unit stride along Dh and "
                         f"16-byte aligned rows (strides {q.stride()})")
    if not (1 <= B <= 65535 and 1 <= H <= 65535):
        raise ValueError(f"flash_attention: B={B}, H={H} outside [1, 65535]")
    if key_mask.shape != (B, T):
        raise ValueError(f"flash_attention: key_mask {tuple(key_mask.shape)}, "
                         f"expected {(B, T)}")
    km = key_mask.to(device=q.device, dtype=torch.int32).contiguous()
    sl = None
    if alibi_slopes is not None:
        sl = alibi_slopes.to(device=q.device, dtype=torch.float32).contiguous()
        if sl.shape != (H,):
            raise ValueError(f"flash_attention: alibi_slopes {tuple(sl.shape)}, "
                             f"expected ({H},)")
    return km, sl


def _forward(q, k, v, key_mask, alibi_slopes, scale, window, block_q, block_kv):
    """K3 on a CUDA tensor, the plain version on a CPU tensor: (out, lse)."""
    global launches
    block_q, block_kv = _blocks(q.shape[2], block_q, block_kv)
    window = window if window > 0 else 0
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, key_mask, alibi_slopes, scale=scale,
                                         window=window, block_q=block_q, block_kv=block_kv)
    km, sl = _check_inputs(q, k, v, key_mask, alibi_slopes, block_q, block_kv)
    from ._build import check, library

    B, H, T, Dh = q.shape
    out = torch.empty_like(q)  # q's strides when q is dense, else contiguous
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        code = library().sgpt_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            km.data_ptr(), None if sl is None else sl.data_ptr(), B, H, T, Dh,
            *q.stride()[:3], *out.stride()[:3], float(scale), int(window), block_q,
            block_kv, int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream)
    check(code, "flash_attention")
    launches += 1
    return out, lse


class FlashAttention(torch.autograd.Function):
    """Flash attention with autograd (the JAX `flash_attention_trainable`
    custom VJP). The forward is K3 or the plain version; the backward is the
    flash backward (K4a/K4b), not ported yet: it raises on every device, and
    no plain backward ever runs on the card."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask, alibi_slopes, scale, window, block_q, block_kv):
        out, lse = _forward(q, k, v, key_mask, alibi_slopes, scale, window, block_q,
                            block_kv)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, g_out, g_lse):
        raise NotImplementedError(_NO_BACKWARD)


def flash_attention(q, k, v, key_mask, alibi_slopes: Optional[torch.Tensor] = None, *,
                    scale: float = 1.0, window: int = 0, block_q: int = 128,
                    block_kv: int = 128, return_residuals: bool = False):
    """Causal attention.

    q, k, v: (B, H, T, Dh); T must divide by the block sizes (clamped to T).
    key_mask: (B, T) 1 = attend, 0 = padding. alibi_slopes: optional (H,)
    fp32, adds slope·key_index (BLOOM). scale: score multiplier (1.0 =
    GPT-Neo, unscaled). window: 0 = global causal; > 0 = sliding window
    (key > query − window). Returns (B, H, T, Dh) in q's dtype, and with
    return_residuals also the (B, H, T) fp32 logsumexp."""
    if q.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"flash_attention: no kernel for device {q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        out, lse = FlashAttention.apply(q, k, v, key_mask, alibi_slopes, scale, window,
                                        block_q, block_kv)
    else:
        out, lse = _forward(q, k, v, key_mask, alibi_slopes, scale, window, block_q,
                            block_kv)
    return (out, lse) if return_residuals else out
