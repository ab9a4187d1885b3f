"""Fused short-T causal attention (counterpart of `sgpt_tpu/ops/pallas/short_attention.py`).

`short_attention` keeps the JAX signature and the (B, T, H·Dh) projection
layout. On a CUDA tensor it launches the hand-written kernel in
`csrc/short_attention.cu` (or raises); on a CPU tensor it runs
`short_attention_reference`, the plain PyTorch version of the same math,
which is also the kernel's oracle on the card.
"""
from __future__ import annotations

import torch

NEG = -1e9   # the decoder's and the TPU kernel's mask constant
MAX_T = 2048  # GPT-Neo's max_position_embeddings; the score strip is sized for it
MAX_DH = 256

# kernel launches made by `short_attention` (reset and read by chip_smoke.py)
launches = 0


def short_attention_reference(q2, k2, v2, key_mask, slopes, *, scale: float,
                              window: int, H: int, use_alibi: bool,
                              segments=None, positions=None):
    """Plain PyTorch version (a copy of the JAX `_reference_hd`): fp32
    scores, where(mask, s, -1e9), fp32 softmax, probabilities cast to the
    input dtype before P·V."""
    B, T, HD = q2.shape
    Dh = HD // H
    q = q2.reshape(B, T, H, Dh)
    k = k2.reshape(B, T, H, Dh)
    v = v2.reshape(B, T, H, Dh)
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
    p = torch.softmax(s, dim=-1).to(q2.dtype)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v)
    return o.reshape(B, T, HD)


def _int32(x, B: int, T: int):
    return x.to(torch.int32).expand(B, T).contiguous()


def short_attention(q2, k2, v2, key_mask, slopes, scale: float, window: int,
                    H: int, use_alibi: bool, segments=None, positions=None):
    """q2/k2/v2: (B, T, H·Dh) projection outputs. key_mask: (B, T).
    slopes: (H,) fp32 (read only with use_alibi). segments: optional (B, T)
    ids for packed rows — queries attend only to keys of the same id.
    positions: optional (B, T) ALiBi key positions (default: the key index).
    Returns (B, T, H·Dh) in q2's dtype."""
    global launches
    if q2.device.type == "cpu":
        return short_attention_reference(
            q2, k2, v2, key_mask, slopes, scale=scale, window=window, H=H,
            use_alibi=use_alibi, segments=segments, positions=positions)
    if q2.device.type != "cuda":
        raise RuntimeError(f"short_attention: no kernel for device {q2.device}")
    B, T, HD = q2.shape
    if q2.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"short_attention: dtype {q2.dtype}; the kernel takes "
                        "float32 or bfloat16")
    for name, t in (("k2", k2), ("v2", v2)):
        if t.shape != q2.shape or t.dtype != q2.dtype or t.device != q2.device:
            raise ValueError(f"short_attention: {name} {tuple(t.shape)} {t.dtype} "
                             f"{t.device} differs from q2 {tuple(q2.shape)} "
                             f"{q2.dtype} {q2.device}")
    for name, t in (("q2", q2), ("k2", k2), ("v2", v2)):
        if not t.is_contiguous():
            raise ValueError(f"short_attention: {name} is not contiguous")
    if HD % H:
        raise ValueError(f"short_attention: H·Dh={HD} does not divide by H={H}")
    if not 1 <= T <= MAX_T:
        raise ValueError(f"short_attention: T={T} outside [1, {MAX_T}]")
    if not 1 <= HD // H <= MAX_DH:
        raise ValueError(f"short_attention: head dim {HD // H} outside [1, {MAX_DH}]")
    if not 1 <= B <= 65535:
        raise ValueError(f"short_attention: B={B} outside [1, 65535]")
    aux = {"key_mask": key_mask, "segments": segments, "positions": positions}
    if use_alibi:
        aux["slopes"] = slopes
    for name, t in aux.items():
        if t is not None and t.device != q2.device:
            raise ValueError(f"short_attention: {name} on {t.device}, q2 on {q2.device}")

    from ._build import check, library

    km = _int32(key_mask, B, T)
    seg = None if segments is None else _int32(segments, B, T)
    kpos = None if positions is None or not use_alibi else _int32(positions, B, T)
    sl = None
    if use_alibi:
        sl = slopes.to(torch.float32).contiguous()
        if sl.shape != (H,):
            raise ValueError(f"short_attention: slopes {tuple(sl.shape)}, expected ({H},)")
    out = torch.empty_like(q2)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(q2.device):
        code = library().sgpt_short_attention_fwd(
            q2.data_ptr(), k2.data_ptr(), v2.data_ptr(), out.data_ptr(),
            km.data_ptr(), ptr(sl), ptr(seg), ptr(kpos), B, T, H, HD // H,
            float(scale), int(window), int(bool(use_alibi)),
            int(q2.dtype == torch.bfloat16),
            torch.cuda.current_stream(q2.device).cuda_stream)
    check(code, "short_attention")
    launches += 1
    return out
