"""Port's short-attention backward (plain version on the CPU) == the JAX backward kernel.

The JAX side runs the Pallas `_bwd_kernel` through `_short_attention_bwd_impl`
in interpret mode on the CPU, as tests/test_short_attention.py does. Inputs
come from a numpy seed, over the cases of tests/test_torch_short_attention.py.
fp32 throughout. Tolerance 1e-5 absolute plus 1e-5 relative: the two sides
sum in another order (batched einsums against per-head dots), and with
ALiBi some gradients reach |8|, where 1e-5 is a few fp32 ulps.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the JAX reference runs on the CPU (as tests/conftest.py sets), also under
# --noconftest on a machine whose JAX would otherwise take the GPU
os.environ.setdefault("JAX_PLATFORMS", "cpu")
pytest.importorskip("jax").config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

from sgpt_tpu.ops.pallas.short_attention import (_seg_kpos_blocks,  # noqa: E402
                                                 _short_attention_bwd_impl)
from sgpt_tpu_torch.ops import short_attention as sa  # noqa: E402

from test_torch_short_attention import (CASES, PV_ORDER, _inputs,  # noqa: E402
                                        _mma_tf32)

ATOL, RTOL = 1e-5, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The emulations below run thousands of small tensor operations. With
    a pool of intra-op threads in each of several test processes sharing
    the host's cores, every operation's thread barrier waits on threads
    that are not running, and a run of seconds takes many minutes. One
    thread gives the same values: no emulation's product or sum depends on
    the thread count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _torch(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("name", sorted(CASES))
def test_bwd_reference_matches_jax_kernel(name):
    T, scale, window, pad_at, alibi, segments = CASES[name]
    B, H, Dh = 2, 4, 16
    q, k, v, km, slopes, seg, pos = _inputs(len(name), B, T, H, Dh, pad_at, segments, alibi)
    g = np.random.default_rng(len(name) + 100).normal(size=q.shape).astype(np.float32)
    got = sa.short_attention_bwd_reference(
        *_torch(q, k, v, km, slopes, g), scale=scale, window=window, H=H,
        use_alibi=alibi, segments=_torch(seg)[0], positions=_torch(pos)[0])
    jseg, jkpos = _seg_kpos_blocks(jnp.asarray(km), None if seg is None else jnp.asarray(seg),
                                   None if pos is None else jnp.asarray(pos), B, T)
    want = _short_attention_bwd_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(km), jnp.asarray(slopes),
        jseg, jkpos, jnp.asarray(g), scale, window, H, alibi, seg is not None,
        interpret=True)
    for part, gg, ww in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(gg.numpy(), np.asarray(ww), atol=ATOL, rtol=RTOL,
                                   err_msg=part)


@pytest.mark.parametrize("name", sorted(CASES))
def test_autograd_function_matches_autograd_through_reference(name):
    """`ShortAttention`'s backward on the CPU (the formula) == torch autograd
    through `short_attention_reference`."""
    T, scale, window, pad_at, alibi, segments = CASES[name]
    B, H, Dh = 2, 4, 16
    q, k, v, km, slopes, seg, pos = _inputs(len(name), B, T, H, Dh, pad_at, segments, alibi)
    g = torch.from_numpy(np.random.default_rng(7).normal(size=q.shape).astype(np.float32))
    kw = dict(segments=_torch(seg)[0], positions=_torch(pos)[0])
    qa, ka, va = (t.requires_grad_() for t in _torch(q, k, v))
    kmt, sl = _torch(km, slopes)
    out = sa.short_attention(qa, ka, va, kmt, sl, scale, window, H, alibi, **kw)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, (qa, ka, va), g)
    qb, kb, vb = (t.requires_grad_() for t in _torch(q, k, v))
    ref = sa.short_attention_reference(qb, kb, vb, kmt, sl, scale=scale, window=window, H=H,
                                       use_alibi=alibi, **kw)
    want = torch.autograd.grad(ref, (qb, kb, vb), g)
    torch.testing.assert_close(out, ref, atol=0, rtol=0)
    for part, gg, ww in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(gg.numpy(), ww.numpy(), atol=ATOL, rtol=RTOL,
                                   err_msg=part)


def test_fully_masked_rows_get_no_query_gradient():
    """Rows 45.. of the last batch row see no valid key (window 16, padding
    from 30): their P is uniform, the re-mask gives dS = 0, so dq = 0 there,
    while dv still collects their g/T."""
    T, H, Dh, window = 60, 2, 16, 16
    q, k, v, km, _, _, _ = _inputs(0, 2, T, H, Dh, pad_at=30)
    g = np.random.default_rng(1).normal(size=q.shape).astype(np.float32)
    dq, dk, dv = sa.short_attention_bwd_reference(*_torch(q, k, v, km), None,
                                                  torch.from_numpy(g), scale=1.0,
                                                  window=window, H=H, use_alibi=False)
    assert torch.all(dq[1, 45:] == 0)
    assert torch.all(dq[1, 1:30].abs().sum(-1) > 0)  # row 0 has one key: P = 1, dS = 0
    # keys 30.. are padding: only the fully masked rows' uniform P reaches them
    np.testing.assert_allclose(dv[1, 30:].numpy(),
                               np.broadcast_to(g[1, 45:].sum(0) / T, (T - 30, H * Dh)),
                               atol=ATOL)


def test_no_grad_path_launches_forward_only_and_builds_no_graph():
    q, k, v, km, _, _, _ = _inputs(1, 2, 24, 2, 8)
    qa = torch.from_numpy(q).requires_grad_()
    args = [qa] + _torch(k, v, km)
    before = (sa.launches, sa.bwd_launches)
    with torch.no_grad():
        out = sa.short_attention(*args, None, 1.0, 0, 2, False)
    assert out.grad_fn is None
    with torch.inference_mode():
        out = sa.short_attention(*args, None, 1.0, 0, 2, False)
    assert out.grad_fn is None
    out = sa.short_attention(*args, None, 1.0, 0, 2, False)
    out.sum().backward()
    assert qa.grad is not None and qa.grad.abs().sum() > 0
    assert (sa.launches, sa.bwd_launches) == before  # CPU: plain versions, not counted


TILE = 64  # K2's fp32 pair on the card: query rows and keys per block and tile


def _k2_tf32(q2, k2, v2, key_mask, slopes, g, *, scale, window, H, use_alibi, segments=None,
             positions=None, three=True, visit_dead=True):
    """K2's fp32 pair on the card, in plain PyTorch: its (3x)TF32 products
    in the card's order and its tile walks. Rows pass, per 64-row query
    tile over the key tiles that hold a causal, in-window pair for it: walk
    1 takes m, l and Σ exp(s − m)·dP online, 32 keys at a time (S = Q·Kᵀ
    and dP = g·Vᵀ with Q and g as A), adds each unvisited key to l as
    exp(-1e9 − m), D = that sum / l (at Dh 256, `tf32_rows_wide`: 16 keys
    at a time, and only the keys before T rounded up to 16, the rest counted
    as unvisited; there both passes sum each half of Dh into the scores
    apart, then add the halves); walk 2 forms P = exp(s − m)·(1/l) and
    dS = P∘(dP − D), re-masked and scaled, and dQ = dS·K with each 8-key
    step in PV_ORDER. Cols pass, per 64-key block over the
    query tiles that reach it and (`visit_dead`) every tile with a fully
    masked row: Sᵀ = K·Qᵀ and dPᵀ = V·gᵀ with K and V as A (the swapped
    product order), P = exp(s − m)·(1/l) from the rows pass's statistics,
    dV = Pᵀ·g and dK = dSᵀ·Q in PV_ORDER. Returns (dq, dk, dv) and whether
    both passes saw the same P bit for bit."""
    B, T, HD = q2.shape
    Dh = HD // H
    Tp = -(-T // TILE) * TILE  # padded to whole tiles: zero rows, masked
    pad = (lambda t: torch.nn.functional.pad(t, (0, 0, 0, Tp - T)))
    q, k, v, gh = (pad(t.reshape(B, T, H, Dh).transpose(1, 2).float())
                   for t in (q2, k2, v2, g))
    _, mask = sa._scores(q2, k2, key_mask, slopes, scale=scale, window=window, H=H,
                         use_alibi=use_alibi, segments=segments, positions=positions)
    mask = torch.nn.functional.pad(mask, (0, Tp - T, 0, Tp - T))

    def masked(dots):  # raw q·k (B, H, Tp, Tp) → K1's masked scores
        s = dots * scale
        if use_alibi:
            kp = positions if positions is not None else torch.arange(T).expand(B, T)
            kp = torch.nn.functional.pad(kp.float(), (0, Tp - T))
            s = s + slopes.float()[None, :, None, None] * kp[:, None, None, :]
        return torch.where(mask, s, torch.full((), sa.NEG))

    halves = Dh == 256  # the wide pair: two warps each sum half of Dh into the scores
    # rows pass
    s = masked(_mma_tf32(q, k.transpose(-1, -2), range(8), three, halves=halves))
    dp = _mma_tf32(gh, v.transpose(-1, -2), range(8), three, halves=halves)
    m = torch.zeros(B, H, Tp, 1)
    l, dd = torch.ones_like(m), torch.zeros_like(m)  # past T: as the cols pass reads them
    seen = torch.zeros(B, H, Tp, Tp, dtype=torch.bool)
    for q0 in range(0, T, TILE):
        rows = slice(q0, q0 + TILE)
        kt_lo = max(0, q0 - window + 1) // TILE if window > 0 else 0
        kt_hi = min(q0 + TILE - 1, T - 1) // TILE
        mr, lr, dr = (torch.full((B, H, TILE, 1), x) for x in (sa.NEG, 0.0, 0.0))
        chunk, end = TILE // 2, (kt_hi + 1) * TILE  # halves of a tile, the whole tiles
        if Dh == 256:
            chunk, end = 16, min(end, -(-T // 16) * 16)
        for c in range(kt_lo * TILE, end, chunk):
            cols = slice(c, c + chunk)
            st, dpt = s[:, :, rows, cols], dp[:, :, rows, cols]
            m_new = torch.maximum(mr, st.amax(-1, keepdim=True))
            w, rescale = torch.exp(st - m_new), torch.exp(mr - m_new)
            lr = lr * rescale + w.sum(-1, keepdim=True)
            dr = dr * rescale + (w * dpt).sum(-1, keepdim=True)
            mr = m_new
        lr = lr + (T - (end - kt_lo * TILE)) * torch.exp(sa.NEG - mr)
        n = min(TILE, T - q0)
        m[:, :, q0:q0 + n], l[:, :, q0:q0 + n] = mr[:, :, :n], lr[:, :, :n]
        dd[:, :, q0:q0 + n] = (dr / lr)[:, :, :n]
        seen[:, :, rows, kt_lo * TILE:(kt_hi + 1) * TILE] = True
    p_rows = torch.exp(s - m) * (1 / l)
    ds = torch.where(s == sa.NEG, torch.zeros(()), p_rows * (dp - dd)) * scale
    dq = _mma_tf32(torch.where(seen, ds, torch.zeros(())), k, PV_ORDER, three)

    # cols pass
    st = masked(_mma_tf32(k, q.transpose(-1, -2), range(8), three, swapped=True,
                          halves=halves).transpose(-1, -2)).transpose(-1, -2)
    dpt = _mma_tf32(v, gh.transpose(-1, -2), range(8), three, swapped=True, halves=halves)
    mt, lt, dt = (x.transpose(-1, -2) for x in (m, l, dd))  # per query: a column
    p_cols = torch.exp(st - mt) * (1 / lt)
    dst = torch.where(st == sa.NEG, torch.zeros(()), p_cols * (dpt - dt)) * scale
    dead = (m[..., 0] == sa.NEG).reshape(B, H, Tp // TILE, TILE).any(-1)  # (B, H, tiles)
    visit = torch.zeros(B, H, Tp, Tp, dtype=torch.bool)
    last = (T - 1) // TILE
    for kb in range(Tp // TILE):
        k0 = kb * TILE
        qt_hi = min(last, (k0 + TILE - 2 + window) // TILE) if window > 0 else last
        for qt in range(last + 1):
            keys, qs = slice(k0, k0 + TILE), slice(qt * TILE, (qt + 1) * TILE)
            if kb <= qt <= qt_hi:
                visit[:, :, keys, qs] = True
            elif visit_dead:
                visit[:, :, keys, qs] = dead[:, :, qt, None, None]
    zero = torch.zeros(())
    dv = _mma_tf32(torch.where(visit, p_cols, zero), gh, PV_ORDER, three)
    dk = _mma_tf32(torch.where(visit, dst, zero), q, PV_ORDER, three)
    same_p = torch.equal(p_rows[:, :, :T, :T], p_cols.transpose(-1, -2)[:, :, :T, :T])
    out = tuple(t[:, :, :T].transpose(1, 2).reshape(B, T, HD) for t in (dq, dk, dv))
    return out, same_p


def _k2_gate(got, want):
    """K2's fp32 gate on the card: |Δ| ≤ 1e-5·max|ref| + 1e-5·|ref| in every
    element; returns the largest |Δ| − 1e-5·|ref| over 1e-5·max|ref| (≤ 1
    holds)."""
    return float(((got - want).abs() - 1e-5 * want.abs()).max() / (1e-5 * want.abs().max()))


@pytest.mark.parametrize("name", sorted(CASES))
def test_k2_3xtf32_holds_the_fp32_gate_against_the_jax_kernel(name):
    """The CPU witness of K2's fp32 pair on the card (3xTF32 products in
    the card's order, the online D, dQ in the permuted key order, the cols
    pass's Sᵀ/dPᵀ/dV/dK with K and V as A, both tile walks) over the JAX
    `_bwd_kernel` in interpret mode and over the plain version; both passes
    see the same P bit for bit."""
    T, scale, window, pad_at, alibi, segments = CASES[name]
    B, H, Dh = 2, 4, 16
    q, k, v, km, slopes, seg, pos = _inputs(len(name), B, T, H, Dh, pad_at, segments, alibi)
    q, k, v = (x * np.float32(0.5) for x in (q, k, v))  # std 0.5, as the card's checks use
    g = np.random.default_rng(len(name) + 100).normal(size=q.shape).astype(np.float32)
    kw = dict(scale=scale, window=window, H=H, use_alibi=alibi, segments=_torch(seg)[0],
              positions=_torch(pos)[0])
    args = _torch(q, k, v, km, slopes, g)
    got, same_p = _k2_tf32(*args, **kw)
    plain = sa.short_attention_bwd_reference(*args, **kw)
    jseg, jkpos = _seg_kpos_blocks(jnp.asarray(km), None if seg is None else jnp.asarray(seg),
                                   None if pos is None else jnp.asarray(pos), B, T)
    jax_kernel = _short_attention_bwd_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(km), jnp.asarray(slopes),
        jseg, jkpos, jnp.asarray(g), scale, window, H, alibi, seg is not None,
        interpret=True)
    for part, gg, pp, jj in zip(("dq", "dk", "dv"), got, plain, jax_kernel):
        assert _k2_gate(gg, pp) <= 1, part
        assert _k2_gate(gg, torch.from_numpy(np.array(jj))) <= 1, part
    assert same_p


K2_TF32_CASES = {  # name: (T, Dh, scale, window, pad_at, alibi, segments)
    "causal-T300-Dh64": (300, 64, 1.0, 0, 200, False, False),
    "window256-T300-Dh64": (300, 64, 1.0, 256, 20, False, False),  # rows 275.. fully masked
    "window16-T200-Dh32-fully-masked": (200, 32, 1.0, 16, 100, False, False),  # rows 115..
    "alibi-window16-T130-Dh128": (130, 128, 1.0, 16, 110, True, False),
    "segments-scale-T150-Dh16": (150, 16, 0.125, 0, 140, False, True),
    # GPT-J's head size (`tf32_rows_wide`, `tf32_cols_wide` on the card): its
    # scale with key padding, fully masked rows (75..) and packed segments
    # with ALiBi, each over two tiles
    "scale16-padded-T120-Dh256": (120, 256, 0.0625, 0, 80, False, False),
    "window16-T128-Dh256-fully-masked": (128, 256, 0.0625, 16, 60, False, False),
    "segments-alibi-T100-Dh256": (100, 256, 0.0625, 0, 90, True, True),
}


def _k2_case(name, seed_offset=0):
    T, Dh, scale, window, pad_at, alibi, segments = K2_TF32_CASES[name]
    B, H = 2, 2
    q, k, v, km, slopes, seg, pos = _inputs(T + Dh + seed_offset, B, T, H, Dh, pad_at,
                                            segments, alibi)
    q, k, v = (x * np.float32(0.5) for x in (q, k, v))
    g = np.random.default_rng(T + 1).normal(size=q.shape).astype(np.float32)
    kw = dict(scale=scale, window=window, H=H, use_alibi=alibi, segments=_torch(seg)[0],
              positions=_torch(pos)[0])
    return _torch(q, k, v, km, slopes, g), kw


@pytest.mark.parametrize("name", sorted(K2_TF32_CASES))
def test_k2_3xtf32_tile_walks_hold_the_fp32_gate_over_several_tiles(name):
    """The same witness where T spans several 64-row tiles, so that the
    online D rescales, the rows pass prunes key tiles, and the cols pass
    skips query tiles or visits them only for their fully masked rows."""
    args, kw = _k2_case(name)
    got, same_p = _k2_tf32(*args, **kw)
    want = sa.short_attention_bwd_reference(*args, **kw)
    for part, gg, ww in zip(("dq", "dk", "dv"), got, want):
        assert _k2_gate(gg, ww) <= 1, part
    assert same_p


@pytest.mark.parametrize("name", ["causal-T300-Dh64", "scale16-padded-T120-Dh256"])
def test_k2_single_tf32_product_fails_the_fp32_gate(name):
    """Why K2 splits its operands: one TF32 product per pair misses the
    fp32 gate at the train shape's T=300, and at GPT-J's head size and
    scale."""
    args, kw = _k2_case(name)
    want = sa.short_attention_bwd_reference(*args, **kw)
    one, _ = _k2_tf32(*args, **kw, three=False)
    assert max(_k2_gate(gg, ww) for gg, ww in zip(one, want)) > 1


@pytest.mark.parametrize("name", sorted(n for n in K2_TF32_CASES if "Dh256" in n))
def test_k2_3xtf32_at_head_size_256_holds_the_fp32_gate_against_the_jax_kernel(name):
    """The witness of GPT-J's fp32 K2 pair (`tf32_rows_wide`,
    `tf32_cols_wide`: two warps to each 16 rows or keys, each summing half
    of Dh into the scores, S = S_lo + S_hi, and keeping half of the
    gradient's columns; walk 1 16 keys at a time) against the JAX
    `_bwd_kernel` in interpret mode, within K2's fp32 gate; both passes see
    the same P bit for bit."""
    args, kw = _k2_case(name)
    got, same_p = _k2_tf32(*args, **kw)
    q, k, v, km, slopes, g = (None if a is None else a.numpy() for a in args)
    seg, pos = (None if kw[x] is None else kw[x].numpy() for x in ("segments", "positions"))
    B, T = km.shape
    jseg, jkpos = _seg_kpos_blocks(jnp.asarray(km), None if seg is None else jnp.asarray(seg),
                                   None if pos is None else jnp.asarray(pos), B, T)
    jax_kernel = _short_attention_bwd_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(km), jnp.asarray(slopes),
        jseg, jkpos, jnp.asarray(g), kw["scale"], kw["window"], kw["H"], kw["use_alibi"],
        seg is not None, interpret=True)
    for part, gg, jj in zip(("dq", "dk", "dv"), got, jax_kernel):
        assert _k2_gate(gg, torch.from_numpy(np.array(jj))) <= 1, part
    assert same_p


@pytest.mark.parametrize("name", ["window256-T300-Dh64", "window16-T200-Dh32-fully-masked"])
def test_k2_fully_masked_rows_reach_every_key(name):
    """Padded query rows that the window leaves with no valid key (the
    query tower's tail in a local layer) softmax to 1/T over all T keys:
    dQ is 0 there, yet their g/T reaches dV of every key, past their causal
    range and on padded keys too. The cols pass must visit their tiles for
    every key block: without that (window 16) dV misses it."""
    args, kw = _k2_case(name)
    T, window, pad_at = args[0].shape[1], kw["window"], K2_TF32_CASES[name][4]
    dead = pad_at + window - 1  # first row of the last batch row with no valid key
    (dq, dk, dv), _ = _k2_tf32(*args, **kw)
    want = sa.short_attention_bwd_reference(*args, **kw)
    assert torch.all(dq[-1, dead:] == 0) and torch.all(want[0][-1, dead:] == 0)
    assert _k2_gate(dv, want[2]) <= 1
    g = args[5]
    np.testing.assert_allclose(dv[-1, pad_at:].numpy(),
                               (g[-1, dead:].sum(0) / T).expand(T - pad_at, -1).numpy(),
                               atol=1e-5)
    (_, _, dv_skip), _ = _k2_tf32(*args, **kw, visit_dead=False)
    if window < TILE:  # with window 256 at T=300 every query tile reaches every key block
        assert _k2_gate(dv_skip, want[2]) > 1
