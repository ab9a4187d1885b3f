"""Fused short-T causal attention (counterpart of `sgpt_tpu/ops/pallas/short_attention.py`).

`short_attention` keeps the JAX signature and the (B, T, H·Dh) projection
layout. When q, k or v need a gradient it goes through `ShortAttention`, an
autograd function like the JAX custom VJP: the forward is the kernel of
`csrc/short_attention.cu` (K1) and the backward the kernel of
`csrc/short_attention_bwd.cu` (K2) on a CUDA tensor, and on a CPU tensor
`short_attention_reference` and `short_attention_bwd_reference`, the plain
PyTorch versions of the same math, which are also the kernels' oracles on
the card. Without a gradient (`no_grad`, `inference_mode`) it launches K1
alone. A CUDA tensor never takes a plain version: a kernel launches or the
call raises. K1 picks its kernel inside the C entry point, by dtype and
head size, with 16-byte-aligned tensors: `mma_kernel` for bf16 at head
sizes 16, 32, 64, 128 and 256 (GPT-J), `tf32_kernel` for fp32 at 16-128
and `tf32_kernel_wide` for fp32 at 256 (3xTF32 tensor-core products,
within 1e-5 of the exact fp32 plain version); every other call takes
`scalar_kernel`. K2 picks likewise: fp32 at those head sizes with
16-byte-aligned tensors (q, k, v, g and the three gradients) takes
`tf32_rows` then `tf32_cols`, at 256 `tf32_rows_wide` then `tf32_cols_wide`
(3xTF32, deterministic, within 1e-5·max|ref| + 1e-5·|ref| of the plain
version); bf16, other head sizes and unaligned tensors take `rows_kernel`
then `cols_kernel` on the CUDA cores. Both keep each row's max, sum and D =
rowsum(dP∘P) in `stats` between their two passes.
"""
from __future__ import annotations

import torch

NEG = -1e9   # the decoder's and the TPU kernel's mask constant
MAX_T = 2048  # GPT-Neo's max_position_embeddings; the score strip is sized for it
MAX_DH = 256

# kernel launches made by `short_attention` (K1) and by the backward (K2);
# reset and read by chip_smoke.py
launches = 0
bwd_launches = 0


def _scores(q2, k2, key_mask, slopes, *, scale, window, H, use_alibi, segments,
            positions):
    """fp32 masked scores (B, H, T, T) and the boolean mask, in the TPU
    kernel's order: scale, then ALiBi, then where(mask, s, -1e9)."""
    B, T, HD = q2.shape
    Dh = HD // H
    q = q2.reshape(B, T, H, Dh)
    k = k2.reshape(B, T, H, Dh)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    if scale != 1.0:
        s = s * scale
    i = torch.arange(T, device=q2.device)
    mask = i[None, :] <= i[:, None]
    if window > 0:
        mask = mask & (i[None, :] > i[:, None] - window)
    mask = mask[None, None] & (key_mask > 0)[:, None, None, :]
    if segments is not None:
        same = segments[:, :, None] == segments[:, None, :]
        mask = mask & same[:, None]
    if use_alibi:
        kp = positions if positions is not None else i.expand(B, T)
        s = s + slopes.float()[None, :, None, None] * kp.float()[:, None, None, :]
    s = torch.where(mask, s, torch.full((), NEG, device=s.device))
    return s, mask


def short_attention_reference(q2, k2, v2, key_mask, slopes, *, scale: float,
                              window: int, H: int, use_alibi: bool,
                              segments=None, positions=None):
    """Plain PyTorch version (a copy of the JAX `_reference_hd`): fp32
    scores, where(mask, s, -1e9), fp32 softmax, probabilities cast to the
    input dtype before P·V."""
    B, T, HD = q2.shape
    s, _ = _scores(q2, k2, key_mask, slopes, scale=scale, window=window, H=H,
                   use_alibi=use_alibi, segments=segments, positions=positions)
    p = torch.softmax(s, dim=-1).to(q2.dtype)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v2.reshape(B, T, H, HD // H))
    return o.reshape(B, T, HD)


def short_attention_bwd_reference(q2, k2, v2, key_mask, slopes, g, *, scale: float,
                                  window: int, H: int, use_alibi: bool,
                                  segments=None, positions=None):
    """Plain PyTorch version of the backward, K2's formula written out (the
    JAX `_bwd_kernel`): recompute P in fp32; dV = Pbᵀ·g with Pb rounded to
    the input dtype; dP = g·Vᵀ; dS = P∘(dP − rowsum(dP∘P)), re-masked to 0,
    times the scale; dQ = dS·K and dK = dSᵀ·Q in fp32. Returns (dq, dk, dv)
    in q2's dtype."""
    B, T, HD = q2.shape
    Dh = HD // H
    s, mask = _scores(q2, k2, key_mask, slopes, scale=scale, window=window, H=H,
                      use_alibi=use_alibi, segments=segments, positions=positions)
    p = torch.softmax(s, dim=-1)
    pb = p.to(q2.dtype).float()
    q, k, v, gh = (t.reshape(B, T, H, Dh).float() for t in (q2, k2, v2, g))
    dv = torch.einsum("bhqk,bqhd->bkhd", pb, gh)
    dp = torch.einsum("bqhd,bkhd->bhqk", gh, v)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    ds = torch.where(mask, ds, torch.zeros((), device=ds.device))
    if scale != 1.0:
        ds = ds * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q)
    return tuple(t.reshape(B, T, HD).to(q2.dtype) for t in (dq, dk, dv))


def _int32(x, B: int, T: int):
    return x.to(torch.int32).expand(B, T).contiguous()


def _check_inputs(what: str, q2, k2, v2, key_mask, slopes, H: int, use_alibi: bool,
                  segments, positions):
    """Refuse what the kernels do not take; returns the int32 and fp32
    auxiliary tensors the C entry points read."""
    if q2.device.type != "cuda":
        raise RuntimeError(f"{what}: no kernel for device {q2.device}")
    B, T, HD = q2.shape
    if q2.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what}: dtype {q2.dtype}; the kernel takes float32 or bfloat16")
    for name, t in (("k2", k2), ("v2", v2)):
        if t.shape != q2.shape or t.dtype != q2.dtype or t.device != q2.device:
            raise ValueError(f"{what}: {name} {tuple(t.shape)} {t.dtype} "
                             f"{t.device} differs from q2 {tuple(q2.shape)} "
                             f"{q2.dtype} {q2.device}")
    for name, t in (("q2", q2), ("k2", k2), ("v2", v2)):
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} is not contiguous")
    if HD % H:
        raise ValueError(f"{what}: H·Dh={HD} does not divide by H={H}")
    if not 1 <= T <= MAX_T:
        raise ValueError(f"{what}: T={T} outside [1, {MAX_T}]")
    if not 1 <= HD // H <= MAX_DH:
        raise ValueError(f"{what}: head dim {HD // H} outside [1, {MAX_DH}]")
    if not 1 <= B <= 65535:
        raise ValueError(f"{what}: B={B} outside [1, 65535]")
    aux = {"key_mask": key_mask, "segments": segments, "positions": positions}
    if use_alibi:
        aux["slopes"] = slopes
    for name, t in aux.items():
        if t is not None and t.device != q2.device:
            raise ValueError(f"{what}: {name} on {t.device}, q2 on {q2.device}")
    km = _int32(key_mask, B, T)
    seg = None if segments is None else _int32(segments, B, T)
    kpos = None if positions is None or not use_alibi else _int32(positions, B, T)
    sl = None
    if use_alibi:
        sl = slopes.to(torch.float32).contiguous()
        if sl.shape != (H,):
            raise ValueError(f"{what}: slopes {tuple(sl.shape)}, expected ({H},)")
    return km, sl, seg, kpos


def _ptr(t):
    return None if t is None else t.data_ptr()


def _forward(q2, k2, v2, key_mask, slopes, scale, window, H, use_alibi, segments,
             positions):
    """K1 on a CUDA tensor, the plain version on a CPU tensor."""
    global launches
    if q2.device.type == "cpu":
        return short_attention_reference(
            q2, k2, v2, key_mask, slopes, scale=scale, window=window, H=H,
            use_alibi=use_alibi, segments=segments, positions=positions)
    km, sl, seg, kpos = _check_inputs("short_attention", q2, k2, v2, key_mask, slopes,
                                      H, use_alibi, segments, positions)
    from ._build import check, library

    B, T, HD = q2.shape
    out = torch.empty_like(q2)
    with torch.cuda.device(q2.device):
        code = library().sgpt_short_attention_fwd(
            q2.data_ptr(), k2.data_ptr(), v2.data_ptr(), out.data_ptr(),
            km.data_ptr(), _ptr(sl), _ptr(seg), _ptr(kpos), B, T, H, HD // H,
            float(scale), int(window), int(bool(use_alibi)),
            int(q2.dtype == torch.bfloat16),
            torch.cuda.current_stream(q2.device).cuda_stream)
    check(code, "short_attention")
    launches += 1
    return out


def short_attention_bwd(q2, k2, v2, key_mask, slopes, g, *, scale: float, window: int,
                        H: int, use_alibi: bool, segments=None, positions=None):
    """(dq, dk, dv) of `short_attention` for the output gradient g: K2 on a
    CUDA tensor, `short_attention_bwd_reference` on a CPU tensor."""
    global bwd_launches
    if q2.device.type == "cpu":
        return short_attention_bwd_reference(
            q2, k2, v2, key_mask, slopes, g, scale=scale, window=window, H=H,
            use_alibi=use_alibi, segments=segments, positions=positions)
    km, sl, seg, kpos = _check_inputs("short_attention_bwd", q2, k2, v2, key_mask,
                                      slopes, H, use_alibi, segments, positions)
    if g.shape != q2.shape or g.dtype != q2.dtype or g.device != q2.device:
        raise ValueError(f"short_attention_bwd: g {tuple(g.shape)} {g.dtype} {g.device} "
                         f"differs from q2 {tuple(q2.shape)} {q2.dtype} {q2.device}")
    g = g.contiguous()  # autograd may hand over a strided or expanded gradient
    from ._build import check, library

    B, T, HD = q2.shape
    dq, dk, dv = (torch.empty_like(q2) for _ in range(3))
    stats = torch.empty(3 * B * H * T, dtype=torch.float32, device=q2.device)
    with torch.cuda.device(q2.device):
        code = library().sgpt_short_attention_bwd(
            q2.data_ptr(), k2.data_ptr(), v2.data_ptr(), g.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats.data_ptr(),
            km.data_ptr(), _ptr(sl), _ptr(seg), _ptr(kpos), B, T, H, HD // H,
            float(scale), int(window), int(bool(use_alibi)),
            int(q2.dtype == torch.bfloat16),
            torch.cuda.current_stream(q2.device).cuda_stream)
    check(code, "short_attention_bwd")
    bwd_launches += 1
    return dq, dk, dv


class ShortAttention(torch.autograd.Function):
    """Differentiable short attention (the JAX `_short_attention_core`
    custom VJP). Saves q2, k2, v2 and the mask inputs, as the JAX residuals
    do, and no (T, T) tensor; the mask, slopes, segments and positions get
    no gradient."""

    @staticmethod
    def forward(ctx, q2, k2, v2, key_mask, slopes, segments, positions, scale, window, H,
                use_alibi):
        ctx.save_for_backward(q2, k2, v2, key_mask, slopes, segments, positions)
        ctx.conf = (scale, window, H, use_alibi)
        return _forward(q2, k2, v2, key_mask, slopes, scale, window, H, use_alibi,
                        segments, positions)

    @staticmethod
    def backward(ctx, g):
        q2, k2, v2, key_mask, slopes, segments, positions = ctx.saved_tensors
        scale, window, H, use_alibi = ctx.conf
        dq, dk, dv = short_attention_bwd(q2, k2, v2, key_mask, slopes, g, scale=scale,
                                         window=window, H=H, use_alibi=use_alibi,
                                         segments=segments, positions=positions)
        return dq, dk, dv, None, None, None, None, None, None, None, None


def short_attention(q2, k2, v2, key_mask, slopes, scale: float, window: int,
                    H: int, use_alibi: bool, segments=None, positions=None, *,
                    causal: bool = True):
    """q2/k2/v2: (B, T, H·Dh) projection outputs. key_mask: (B, T).
    slopes: (H,) fp32 (read only with use_alibi). segments: optional (B, T)
    ids for packed rows — queries attend only to keys of the same id.
    positions: optional (B, T) ALiBi key positions (default: the key index).
    causal: the caller's attention is causal; False raises ValueError,
    since the kernel and its plain version mask every key after the query.
    Returns (B, T, H·Dh) in q2's dtype, with a `grad_fn` when q2, k2 or v2
    requires grad and grad mode is on."""
    if not causal:
        raise ValueError("short_attention (K1) computes causal attention only; "
                         "bidirectional attention takes the decoder's plain path")
    if q2.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"short_attention: no kernel for device {q2.device}")
    if torch.is_grad_enabled() and (q2.requires_grad or k2.requires_grad
                                    or v2.requires_grad):
        return ShortAttention.apply(q2, k2, v2, key_mask, slopes, segments, positions,
                                    scale, window, H, use_alibi)
    return _forward(q2, k2, v2, key_mask, slopes, scale, window, H, use_alibi, segments,
                    positions)
