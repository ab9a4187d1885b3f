"""Causal flash attention (counterpart of `sgpt_tpu/ops/pallas/flash_attention.py`).

`flash_attention` keeps the JAX signature and the (B, H, T, Dh) layout: an
online softmax over key tiles with fp32 running max, sum and accumulator,
tiles pruned by causality and the sliding window, an optional scale, an
optional ALiBi term (slope_h × key index), a key-padding mask, masked scores
at -1e30, and the logsumexp per query row. T must divide by the block sizes.

On a CUDA tensor it launches the kernel of `csrc/flash_attention.cu` (K3,
head sizes 16-256),
on a CPU tensor `flash_attention_reference`, the plain PyTorch version,
which follows the TPU kernel tile by tile and is the kernel's oracle on the
card. A CUDA tensor never takes the plain version: the kernel launches or
the call raises. q, k and v may be strided views, such as the (B, T, H·Dh)
projections seen as (B, H, T, Dh): the kernel reads them through their
strides, and the output has q's strides.

When q, k or v requires grad, the call goes through `FlashAttention`, whose
backward is `flash_attention_bwd`, the JAX function of the same name: on a
CUDA tensor the kernels of `csrc/flash_attention_bwd.cu`, K4a (dQ, and
D = rowsum(dO∘O) in its prologue) then K4b (dK, dV); on a CPU tensor
`flash_attention_bwd_reference`, their plain version and oracle.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30  # the TPU kernel's mask constant (the decoder and K1 use -1e9)
TILE = 64        # the kernel's query and key sub-tile: block sizes must divide by it
HEAD_DIMS = (16, 32, 64, 128, 256)  # K3, K4a and K4b

# kernel launches made by `flash_attention` (K3) and by `flash_attention_bwd`
# (K4a, K4b); reset and read by chip_smoke.py
launches = 0
bwd_dq_launches = 0
bwd_dkv_launches = 0


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


def flash_attention_bwd_reference(q, k, v, key_mask, alibi_slopes, g, out, lse, *,
                                  scale: float = 1.0, window: int = 0, block_q: int = 128,
                                  block_kv: int = 128):
    """Plain PyTorch version of the TPU backward kernels, in fp32: D =
    rowsum(g∘out); for each key tile, the query tiles that visit it
    recompute s = q·k (× scale, + slope·kpos, rounded as the forward),
    p = where(mask, exp(s − lse), 0) with the where outside the exp (a fully
    masked row has lse = -1e30, so none of its pairs reaches a product),
    dp = g·vᵀ and ds = p∘(dp − D); dq accumulates ds·k·scale over the key
    tiles, dk = dsᵀ·q·scale and dv = pᵀ·g over the query tiles. A tile that
    is not visited has every pair masked, so the visited set does not change
    the values. Returns (dq, dk, dv) in the input dtypes."""
    B, H, T, Dh = q.shape
    block_q, block_kv = _blocks(T, block_q, block_kv)
    n_q, n_kv = T // block_q, T // block_kv
    dev, f32 = q.device, torch.float32
    qf = q.float().reshape(B, H, n_q, block_q, Dh)
    gf = g.to(device=dev, dtype=f32).reshape(B, H, n_q, block_q, Dh)
    lse_t = lse.to(device=dev, dtype=f32).reshape(B, H, n_q, block_q, 1)
    dsum = (gf * out.to(device=dev, dtype=f32).reshape(B, H, n_q, block_q, Dh)).sum(
        -1, keepdim=True)
    dq = torch.zeros_like(qf)
    dk = torch.zeros((B, H, T, Dh), dtype=f32, device=dev)
    dv = torch.zeros((B, H, T, Dh), dtype=f32, device=dev)
    keep = key_mask.to(device=dev) != 0
    qpos = torch.arange(T, device=dev).reshape(n_q, block_q)
    zero = torch.zeros((), device=dev)
    for ki in range(n_kv):
        tiles = [qi for qi in range(n_q) if _visited(qi, ki, block_q, block_kv, window)]
        if not tiles:
            continue
        lo, hi = tiles[0], tiles[-1] + 1  # the visiting tiles are contiguous
        k0 = ki * block_kv
        kt = k[:, :, k0:k0 + block_kv].float()
        vt = v[:, :, k0:k0 + block_kv].float()
        kpos = torch.arange(k0, k0 + block_kv, device=dev)
        s = torch.einsum("bhnqd,bhkd->bhnqk", qf[:, :, lo:hi], kt)
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
        p = torch.where(mask, torch.exp(s - lse_t[:, :, lo:hi]), zero)
        dp = torch.einsum("bhnqd,bhkd->bhnqk", gf[:, :, lo:hi], vt)
        ds = p * (dp - dsum[:, :, lo:hi])
        dq[:, :, lo:hi] += torch.einsum("bhnqk,bhkd->bhnqd", ds, kt) * scale
        dk[:, :, k0:k0 + block_kv] = torch.einsum("bhnqk,bhnqd->bhkd", ds,
                                                  qf[:, :, lo:hi]) * scale
        dv[:, :, k0:k0 + block_kv] = torch.einsum("bhnqk,bhnqd->bhkd", p, gf[:, :, lo:hi])
    return dq.reshape(B, H, T, Dh).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


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


def _kernel_layout(t, q, name: str):
    """t as K4a/K4b read it: q's shape, dtype and device, unit stride along Dh
    and 16-byte aligned rows; a tensor laid out otherwise (an expanded or
    transposed gradient) is copied to a contiguous one."""
    if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
        raise ValueError(f"flash_attention_bwd: {name} {tuple(t.shape)} {t.dtype} {t.device} "
                         f"differs from q {tuple(q.shape)} {q.dtype} {q.device}")
    esize = t.element_size()
    if t.stride(3) != 1 or t.data_ptr() % 16 or any((t.stride(i) * esize) % 16
                                                     for i in range(3)):
        t = t.contiguous()
    return t


def _bwd_args(q, k, v, key_mask, alibi_slopes, g, out, lse, scale, window, block_q,
              block_kv) -> dict:
    """Check what K4a/K4b take, allocate dq, dk and dv (q's strides) and D =
    rowsum(g∘out) (a (B, H, T) fp32 buffer that K4a fills and K4b reads), and
    build both C calls' arguments less the stream. The dict keeps every
    tensor the kernels read or write alive."""
    km, sl = _check_inputs(q, k, v, key_mask, alibi_slopes, block_q, block_kv)
    g, out = _kernel_layout(g, q, "g"), _kernel_layout(out, q, "out")
    B, H, T, Dh = q.shape
    if lse.shape != (B, H, T):
        raise ValueError(f"flash_attention_bwd: lse {tuple(lse.shape)}, expected {(B, H, T)}")
    lse = lse.to(device=q.device, dtype=torch.float32).contiguous()
    dsum = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    dq = torch.empty_like(q)  # q's strides when q is dense, else contiguous
    dk, dv = torch.empty_like(dq), torch.empty_like(dq)
    head = (km.data_ptr(), None if sl is None else sl.data_ptr(), B, H, T, Dh,
            *q.stride()[:3], *g.stride()[:3])
    tail = (*dq.stride()[:3], float(scale), int(window), int(q.dtype == torch.bfloat16))
    return {"device": q.device, "grads": (dq, dk, dv), "keep": (q, k, v, g, out, km, sl, lse, dsum),
            "dq": (*(t.data_ptr() for t in (q, k, v, g, out, lse, dsum, dq)), *head,
                   *out.stride()[:3], *tail),
            "dkv": (*(t.data_ptr() for t in (q, k, v, g, lse, dsum, dk, dv)), *head, *tail)}


def _launch_dq(a) -> None:
    """K4a (fp32 `flash_bwd_dq_tf32`, bf16 `flash_bwd_dq`; at Dh 256
    `flash_bwd_dq_wide` in both): dq, and D in its prologue."""
    global bwd_dq_launches
    from ._build import check, library

    with torch.cuda.device(a["device"]):
        check(library().sgpt_flash_attention_bwd_dq(
            *a["dq"], torch.cuda.current_stream(a["device"]).cuda_stream),
            "flash_attention_bwd (K4a)")
    bwd_dq_launches += 1


def _launch_dkv(a) -> None:
    """K4b (fp32 `flash_bwd_dkv_tf32`, bf16 `flash_bwd_dkv`; at Dh 256
    `flash_bwd_dkv_wide` in both): dk and dv, from the D that K4a wrote."""
    global bwd_dkv_launches
    from ._build import check, library

    with torch.cuda.device(a["device"]):
        check(library().sgpt_flash_attention_bwd_dkv(
            *a["dkv"], torch.cuda.current_stream(a["device"]).cuda_stream),
            "flash_attention_bwd (K4b)")
    bwd_dkv_launches += 1


def flash_attention_bwd(q, k, v, key_mask, alibi_slopes, g, out, lse, *, scale: float = 1.0,
                        window: int = 0, block_q: int = 128, block_kv: int = 128):
    """The flash backward (JAX `flash_attention_bwd`): (dq, dk, dv) in q's
    dtype. g: the output's cotangent (B, H, T, Dh); out, lse: the forward's
    output and (B, H, T) logsumexp. On a CUDA tensor it launches K4a (dQ, and
    D = rowsum(g∘out) in its prologue) then K4b (dK, dV), and writes all
    three with q's strides; on a CPU tensor it runs the plain version."""
    if q.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"flash_attention_bwd: no kernel for device {q.device}")
    block_q, block_kv = _blocks(q.shape[2], block_q, block_kv)
    window = window if window > 0 else 0
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(q, k, v, key_mask, alibi_slopes, g, out, lse,
                                             scale=scale, window=window, block_q=block_q,
                                             block_kv=block_kv)
    a = _bwd_args(q, k, v, key_mask, alibi_slopes, g, out, lse, scale, window, block_q,
                  block_kv)
    _launch_dq(a)
    _launch_dkv(a)
    return a["grads"]


class FlashAttention(torch.autograd.Function):
    """Flash attention with autograd (the JAX `flash_attention_trainable`
    custom VJP): the forward is K3 or its plain version, the backward
    `flash_attention_bwd` (K4a, K4b or their plain version) from the saved
    q, k, v, output and logsumexp. The key mask, the slopes and the static
    arguments get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask, alibi_slopes, scale, window, block_q, block_kv):
        out, lse = _forward(q, k, v, key_mask, alibi_slopes, scale, window, block_q,
                            block_kv)
        ctx.save_for_backward(q, k, v, out, lse, key_mask, alibi_slopes)
        ctx.static = dict(scale=scale, window=window, block_q=block_q, block_kv=block_kv)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, g_out, g_lse):
        q, k, v, out, lse, key_mask, slopes = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, key_mask, slopes, g_out, out, lse,
                                         **ctx.static)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention(q, k, v, key_mask, alibi_slopes: Optional[torch.Tensor] = None, *,
                    scale: float = 1.0, window: int = 0, block_q: int = 128,
                    block_kv: int = 128, return_residuals: bool = False,
                    causal: bool = True):
    """Causal attention (causal=False raises ValueError: the kernel and its
    plain version mask every key after the query).

    q, k, v: (B, H, T, Dh); T must divide by the block sizes (clamped to T).
    key_mask: (B, T) 1 = attend, 0 = padding. alibi_slopes: optional (H,)
    fp32, adds slope·key_index (BLOOM). scale: score multiplier (1.0 =
    GPT-Neo, unscaled). window: 0 = global causal; > 0 = sliding window
    (key > query − window). Returns (B, H, T, Dh) in q's dtype, and with
    return_residuals also the (B, H, T) fp32 logsumexp."""
    if not causal:
        raise ValueError("flash_attention (K3) computes causal attention only; "
                         "bidirectional attention takes the decoder's plain path")
    if q.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"flash_attention: no kernel for device {q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        out, lse = FlashAttention.apply(q, k, v, key_mask, alibi_slopes, scale, window,
                                        block_q, block_kv)
    else:
        out, lse = _forward(q, k, v, key_mask, alibi_slopes, scale, window, block_q,
                            block_kv)
    return (out, lse) if return_residuals else out
