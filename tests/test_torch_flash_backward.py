"""Port's flash backward (plain version on the CPU) == the JAX flash backward.

The JAX side runs `flash_attention_bwd(..., interpret=True)`, the bodies of
the two TPU kernels (K4a dQ, K4b dK/dV), and `_flash_bwd_scan`, the XLA scan
backward its custom VJP takes off the TPU; both sides start from the same
forward residuals (out, lse of the JAX kernel). Inputs come from a numpy
seed, with key padding that leaves fully masked query rows. Tolerances:
fp32 |Δ| ≤ 1e-5·max|ref| + 1e-5·|ref| (all three sum the same fp32
products in another order); bf16 2e-2 + 1e-2·|ref| (a flipped rounding of
an output cast to bf16; the arithmetic is fp32 on both sides). The 3xTF32
emulations of K4a's and K4b's fp32 kernels (`_k4a_tf32`, `_k4b_tf32`) are
held to the same fp32 gate of both.
"""
import functools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the JAX reference runs on the CPU (as tests/conftest.py sets), also under
# --noconftest on a machine whose JAX would otherwise take the GPU
os.environ.setdefault("JAX_PLATFORMS", "cpu")
pytest.importorskip("jax").config.update("jax_platforms", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sgpt_tpu.ops.pallas.flash_attention import _flash_bwd_scan  # noqa: E402
from sgpt_tpu.ops.pallas.flash_attention import flash_attention as jax_flash  # noqa: E402
from sgpt_tpu.ops.pallas.flash_attention import flash_attention_bwd as jax_bwd  # noqa: E402
from sgpt_tpu.ops.pallas.flash_attention import flash_attention_trainable  # noqa: E402
from sgpt_tpu_torch.models.decoder import alibi_slopes  # noqa: E402
from sgpt_tpu_torch.ops import flash_attention as fa  # noqa: E402
from test_torch_short_attention import PV_ORDER, _mma_tf32  # noqa: E402

DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain backward's sums in one fixed order, whatever the host's
    cores and the test runner's workers: one torch thread for this module,
    the count restored after. Measured on an 8-core host for every fp32
    case, the worst |Δ| against the tolerance was the same under 1, 2, 6
    and 8 threads (at most 0.071 of it; 0.017 for T128-Dh32-bkv128-w0)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)

CASES = [  # T, Dh, block_kv, window, scale, alibi, lengths
    (128, 32, 128, 0, 1.0, False, (20, 91)),
    (128, 16, 256, 64, 0.25, True, (20, 128)),         # block_kv clamps to 128
    (256, 32, 128, 64, 1.0, False, (20, 219)),
    (256, 64, 256, 0, 0.125, False, (0, 219)),         # a fully padded batch row
    (256, 16, 256, 256, 1.0, True, (20, 256)),
    (384, 32, 128, 64, 0.17677669, False, (40, 300)),
    (512, 64, 256, 256, 1.0, False, (20, 475)),        # the decoder's local layers
    (512, 16, 128, 0, 1.0, True, (100, 512)),
    # GPT-J's head size 256 (K4a/K4b's `flash_bwd_dq_wide`/`flash_bwd_dkv_wide`
    # on the card), with and without BLOOM's slopes, a fully padded batch row
    (256, 256, 128, 0, 0.0625, False, (20, 219)),
    (256, 256, 256, 64, 0.0625, "bloom", (0, 256)),
    (384, 256, 128, 256, 0.0625, "bloom", (40, 300)),
]


def _ids(c):
    alibi = "bloom" if c[5] == "bloom" else "alibi" if c[5] else "noalibi"
    return "T{}-Dh{}-bkv{}-w{}-s{:.3g}-{}".format(*c[:5], alibi)


def _inputs(seed, T, Dh, lengths, alibi, B=2, H=None):
    """q/k/v (B, H, T, Dh) at the scale of real projections (std 0.5), a
    cotangent g (std 1), a key mask of right padding, BLOOM-sized slopes
    (alibi True, H 2) or BLOOM's own `alibi_slopes` (alibi "bloom", H 4:
    0.25 down to 2^-8)."""
    H = H or (4 if alibi == "bloom" else 2)
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.normal(0.0, s, (B, H, T, Dh)).astype(np.float32)
                  for s in (0.5, 0.5, 0.5, 1.0))
    km = (np.arange(T)[None, :] < np.asarray(lengths)[:, None]).astype(np.int32)
    slopes = None
    if alibi == "bloom":
        slopes = alibi_slopes(H).numpy()
    elif alibi:
        slopes = (0.03 * rng.random(H)).astype(np.float32)
    return q, k, v, g, km, slopes


def _jax_all(q, k, v, g, km, slopes, dtype, **kw):
    """The JAX forward residuals, then (kernels in interpret mode, scan), as
    fp32 numpy."""
    jd = DTYPES[dtype][1]
    jq, jk, jv, jg = (jnp.asarray(x, jd) for x in (q, k, v, g))
    js = None if slopes is None else jnp.asarray(slopes)
    jkm = jnp.asarray(km)
    out, lse = jax_flash(jq, jk, jv, jkm, js, return_residuals=True, **kw)
    kern = jax_bwd(jq, jk, jv, jkm, js, jg, out, lse, interpret=True, **kw)
    scan = _flash_bwd_scan(kw.get("scale", 1.0), kw.get("window", 0), kw.get("block_kv", 128),
                           (jq, jk, jv, jkm, js, out, lse), jg)[:3]
    f32 = lambda x: np.array(x.astype(jnp.float32))  # noqa: E731
    return f32(out), np.array(lse), [f32(x) for x in kern], [f32(x) for x in scan]


def _port(q, k, v, g, km, slopes, out, lse, dtype, **kw):
    td = DTYPES[dtype][0]
    got = fa.flash_attention_bwd(
        *(torch.from_numpy(x).to(td) for x in (q, k, v)), torch.from_numpy(km),
        None if slopes is None else torch.from_numpy(slopes), torch.from_numpy(g).to(td),
        torch.from_numpy(out).to(td), torch.from_numpy(lse), **kw)
    assert all(t.dtype == td and t.shape == q.shape for t in got)
    return [t.float().numpy() for t in got]


def _close(got, want, dtype, what):
    if dtype == "float32":
        atol, rtol = 1e-5 * max(np.abs(want).max(), 1e-30), 1e-5
    else:
        atol, rtol = 2e-2, 1e-2
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol, err_msg=what)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_plain_backward_matches_jax_kernels_and_scan(case, dtype):
    T, Dh, block_kv, window, scale, alibi, lengths = case
    q, k, v, g, km, slopes = _inputs(T + Dh + window + bool(alibi), T, Dh, lengths, alibi)
    kw = dict(scale=scale, window=window, block_kv=block_kv)
    out, lse, kern, scan = _jax_all(q, k, v, g, km, slopes, dtype, **kw)
    before = (fa.bwd_dq_launches, fa.bwd_dkv_launches)
    got = _port(q, k, v, g, km, slopes, out, lse, dtype, **kw)
    assert (fa.bwd_dq_launches, fa.bwd_dkv_launches) == before  # CPU: the plain version
    for name, a, b, c in zip(("dq", "dk", "dv"), got, kern, scan):
        _close(a, b, dtype, f"{name} against the TPU kernels (interpret mode)")
        _close(a, c, dtype, f"{name} against _flash_bwd_scan")


@pytest.mark.parametrize("window", [0, 64])
def test_fully_masked_rows_contribute_exactly_zero(window):
    """Leading padded keys leave rows 0..139 with no valid key (causal), and
    with a window the tail of a short row too; they carry lse = -1e30. Their
    dq is exactly 0, the padded keys' dk and dv are exactly 0, and any g on
    those rows changes no gradient (the where stays outside the exp)."""
    T, Dh = 256, 32
    q, k, v, g, _, _ = _inputs(5, T, Dh, (T, T), False)
    km = np.ones((2, T), np.int32)
    km[0, :140] = 0
    km[1, 20:] = 0
    kw = dict(scale=0.2, window=window)
    out, lse, kern, _ = _jax_all(q, k, v, g, km, None, "float32", **kw)
    dead = lse == fa.NEG_INF                        # (B, H, T)
    assert dead[0, :, :140].all() and not dead[0, :, 140:].any()
    assert dead[1].any() == (window > 0)
    got = _port(q, k, v, g, km, None, out, lse, "float32", **kw)
    dq, dk, dv = got
    assert all(np.isfinite(x).all() for x in got)
    assert (dq[dead] == 0).all()
    padded = np.broadcast_to((km == 0)[:, None, :], dead.shape)
    assert (dk[padded] == 0).all() and (dv[padded] == 0).all()
    for name, a, b in zip(("dq", "dk", "dv"), got, kern):
        _close(a, b, "float32", name)
    g2 = g.copy()
    g2[dead] = 1e3 * np.random.default_rng(1).normal(size=g2[dead].shape)
    again = _port(q, k, v, g2, km, None, out, lse, "float32", **kw)
    for a, b in zip(got, again):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("block_kv,window", [(128, 64), (256, 256), (256, 0)])
def test_visited_tile_set_does_not_change_the_backward(monkeypatch, block_kv, window):
    """The TPU kernels skip the tiles their pruning rules out; a tile left out
    has every pair masked, so visiting every tile gives the same gradients."""
    T, Dh = 512, 16
    q, k, v, g, km, _ = _inputs(11, T, Dh, (20, 475), False)
    out, lse, _, _ = _jax_all(q, k, v, g, km, None, "float32", window=window,
                              block_kv=block_kv)
    kw = dict(window=window, block_kv=block_kv)
    pruned = _port(q, k, v, g, km, None, out, lse, "float32", **kw)
    visited = []
    real = fa._visited
    monkeypatch.setattr(fa, "_visited", lambda *a: visited.append(real(*a)) or True)
    every = _port(q, k, v, g, km, None, out, lse, "float32", **kw)
    assert not all(visited)  # some tiles are pruned at this shape
    for a, b in zip(pruned, every):
        np.testing.assert_allclose(a, b, atol=1e-6 * np.abs(b).max(), rtol=0)


def test_cotangent_with_decoder_strides():
    """q, k, v, out and g as the decoder hands them: (B, T, H·Dh) tensors seen
    as (B, H, T, Dh); the gradients equal those of contiguous copies, and the
    JAX kernels'."""
    B, T, H, Dh = 2, 256, 2, 32
    q, k, v, g, km, _ = _inputs(3, T, Dh, (100, T), False, B=B, H=H)
    out, lse, kern, _ = _jax_all(q, k, v, g, km, None, "float32", window=64)

    def view(x):  # (B, H, T, Dh) values in the projection layout
        return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1, 3))).view(
            B, T, H, Dh).transpose(1, 2)

    args = [view(x) for x in (q, k, v)]
    assert not args[0].is_contiguous() and args[0].stride() == (T * H * Dh, Dh, H * Dh, 1)
    got = fa.flash_attention_bwd(*args, torch.from_numpy(km), None, view(g), view(out),
                                 torch.from_numpy(lse), window=64)
    dense = fa.flash_attention_bwd(*(t.contiguous() for t in args), torch.from_numpy(km), None,
                                   view(g).contiguous(), view(out).contiguous(),
                                   torch.from_numpy(lse), window=64)
    for name, a, b, c in zip(("dq", "dk", "dv"), got, dense, kern):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6 * b.abs().max().item(),
                                   rtol=0, err_msg=name)
        _close(a.numpy(), c, "float32", name)


@pytest.mark.parametrize("T,Dh,block_kv,window,scale,alibi", [
    (128, 32, 128, 0, 1.0, False), (256, 16, 256, 64, 0.25, True),
    (512, 32, 256, 256, 1.0, False)])
def test_autograd_matches_jax_grad(T, Dh, block_kv, window, scale, alibi):
    """`FlashAttention` gradients (loss = Σ out·w) against `jax.grad` through
    `flash_attention_trainable`, from the same inputs."""
    q, k, v, w, km, slopes = _inputs(T + window, T, Dh, (30, T - 50), alibi)

    def jloss(q, k, v):
        out = flash_attention_trainable(q, k, v, jnp.asarray(km),
                                        None if slopes is None else jnp.asarray(slopes),
                                        scale, window, block_kv)
        return jnp.sum(out * jnp.asarray(w))

    want = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = fa.flash_attention(tq, tk, tv, torch.from_numpy(km),
                             None if slopes is None else torch.from_numpy(slopes),
                             scale=scale, window=window, block_kv=block_kv)
    assert out.grad_fn is not None
    (out * torch.from_numpy(w)).sum().backward()
    for name, t, ww in zip(("dq", "dk", "dv"), (tq, tk, tv), want):
        _close(t.grad.numpy(), np.asarray(ww), "float32", name)


def test_backward_refuses_mismatched_cotangent_and_other_devices():
    q, k, v, g, km, _ = _inputs(0, 128, 16, (128, 60), False)
    t = [torch.from_numpy(x) for x in (q, k, v)]
    lse = torch.zeros(2, 2, 128)
    with pytest.raises(ValueError, match="divide"):
        fa.flash_attention_bwd(*(x[:, :, :100] for x in t), torch.from_numpy(km)[:, :100],
                               None, t[0][:, :, :100], t[0][:, :, :100], lse[..., :100],
                               block_q=64, block_kv=64)
    x = torch.zeros(1, 1, 128, 16, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        fa.flash_attention_bwd(x, x, x, torch.ones(1, 128, dtype=torch.int32), None, x, x,
                               torch.zeros(1, 1, 128, device="meta"))


# A dV/dK k-step's 8 queries in the order of its slots on the card: slot t
# is the query of Sᵀ's accumulator column 2t, slot t + 4 that of column
# 2t + 1, and column c of an 8-query n-tile holds query c ^ (c >> 2 & 1).
K4B_Q_ORDER = (0, 2, 5, 7, 1, 3, 4, 6)
K4B_QT = 32  # query rows of a stage of the kernel's ring


def _k4b_tf32(q, k, v, g, key_mask, slopes, lse, dsum, *, scale, window, three=True):
    """`flash_bwd_dkv_tf32`'s walk and arithmetic on the CPU: Sᵀ = K·Qᵀ and
    dPᵀ = V·gᵀ in (3x)TF32 (`_mma_tf32`, K and V as A, the products in
    K3's term order, each 8-deep step's Dh columns in PV_ORDER), × scale,
    + slope·kpos; P = where(mask, exp(s − lse), 0) and dS = where(mask,
    P∘(dP − D), 0), the where outside the exp; then per batch row and
    64-key block, unless all its keys are padded, over the 32-row query
    tiles from the block's first key to the last query that sees one of its
    keys: dV = Pᵀ·g and dK = dSᵀ·Q·scale, one 8-query step at a time in
    K4B_Q_ORDER. Returns (dk, dv) and the number of key blocks skipped."""
    B, H, T, Dh = q.shape
    st = _mma_tf32(k, q.transpose(-1, -2), PV_ORDER, three, swapped=True)  # (B, H, keys, queries)
    dpt = _mma_tf32(v, g.transpose(-1, -2), PV_ORDER, three, swapped=True)
    pos = torch.arange(T)
    if scale != 1.0:
        st = st * scale
    if slopes is not None:
        st = st + slopes[None, :, None, None] * pos.float()[:, None]
    allowed = pos[:, None] <= pos[None, :]  # key ≤ query
    if window > 0:
        allowed = allowed & (pos[:, None] > pos[None, :] - window)
    mask = allowed[None, None] & (key_mask != 0)[:, None, :, None]
    zero = torch.zeros(())
    p = torch.where(mask, torch.exp(st - lse[:, :, None, :]), zero)
    ds = torch.where(mask, p * (dpt - dsum[:, :, None, :]), zero)
    dk, dv, skipped = torch.zeros(B, H, T, Dh), torch.zeros(B, H, T, Dh), 0
    for b in range(B):
        for k0 in range(0, T, fa.TILE):
            keys = slice(k0, k0 + fa.TILE)
            if not bool((key_mask[b, keys] != 0).any()):
                skipped += 1
                continue
            q_end = min(T, k0 + fa.TILE - 1 + window) if window > 0 else T
            qs = slice(k0, k0 + -(-(q_end - k0) // K4B_QT) * K4B_QT)
            dv[b, :, keys] = _mma_tf32(p[b, :, keys, qs], g[b, :, qs], K4B_Q_ORDER, three)
            dk[b, :, keys] = _mma_tf32(ds[b, :, keys, qs], q[b, :, qs], K4B_Q_ORDER,
                                       three) * scale
    return (dk, dv), skipped


K4A_KT = 32  # keys of a stage of K4a's ring


def _k4a_tf32(q, k, v, g, key_mask, slopes, lse, dsum, *, scale, window, three=True):
    """`flash_bwd_dq_tf32`'s walk and arithmetic on the CPU: S = Q·Kᵀ and
    dP = g·Vᵀ in (3x)TF32 (`_mma_tf32`, Q and g as A, the products in K3's
    term order, each 8-deep step's Dh columns in PV_ORDER), × scale,
    + slope·kpos; dS = where(mask, exp(s − lse)∘(dP − D), 0), the where
    outside the exp; then per batch row and 64-row query block, over the
    32-key tiles from the first row's window start to the block's last row,
    less those whose keys are all padded: dQ = dS·K·scale, one 8-key step
    at a time in K4B_Q_ORDER (the key permutation of S's n-tiles is K4b's
    query permutation). Returns dq and the number of key tiles skipped."""
    B, H, T, Dh = q.shape
    s = _mma_tf32(q, k.transpose(-1, -2), PV_ORDER, three)  # (B, H, queries, keys)
    dp = _mma_tf32(g, v.transpose(-1, -2), PV_ORDER, three)
    pos = torch.arange(T)
    if scale != 1.0:
        s = s * scale
    if slopes is not None:
        s = s + slopes[None, :, None, None] * pos.float()
    allowed = pos[None, :] <= pos[:, None]  # key ≤ query
    if window > 0:
        allowed = allowed & (pos[None, :] > pos[:, None] - window)
    mask = allowed[None, None] & (key_mask != 0)[:, None, None, :]
    zero = torch.zeros(())
    ds = torch.where(mask, torch.exp(s - lse[..., None]) * (dp - dsum[..., None]), zero)
    dq, skipped = torch.zeros(B, H, T, Dh), 0
    for b in range(B):
        for q0 in range(0, T, fa.TILE):
            lo = max(0, q0 - window + 1) if window > 0 else 0
            tiles = range(lo // K4A_KT * K4A_KT, q0 + fa.TILE, K4A_KT)
            live = [k0 for k0 in tiles if bool((key_mask[b, k0:k0 + K4A_KT] != 0).any())]
            skipped += len(tiles) - len(live)
            if live:
                keys = torch.cat([torch.arange(k0, k0 + K4A_KT) for k0 in live])
                rows = slice(q0, q0 + fa.TILE)
                dq[b, :, rows] = _mma_tf32(ds[b, :, rows][..., keys], k[b, :, keys], K4B_Q_ORDER,
                                           three) * scale
    return dq, skipped


K4B_CASES = CASES + [  # Dh 128 (GPT-Neo 1.3B/2.7B heads)
    (256, 128, 128, 64, 0.125, True, (20, 219)),
    (512, 128, 256, 0, 1.0, False, (0, 475)),          # a fully padded batch row
]


@functools.lru_cache(maxsize=None)
def _k4_case(case, three=True):
    """The JAX kernels' and the plain version's (dq, dk, dv) on one case, and
    the emulations' (`_k4a_tf32`: dq; `_k4b_tf32`: dk, dv) from the same
    forward residuals and D, with each emulation's count of skipped tiles
    and the lse. Cached: the K4a and K4b tests of a case share one build."""
    T, Dh, block_kv, window, scale, alibi, lengths = case
    q, k, v, g, km, slopes = _inputs(T + Dh + window + bool(alibi), T, Dh, lengths, alibi)
    kw = dict(scale=scale, window=window, block_kv=block_kv)
    out, lse, kern, _ = _jax_all(q, k, v, g, km, slopes, "float32", **kw)
    plain = _port(q, k, v, g, km, slopes, out, lse, "float32", **kw)
    tq, tk, tv, tg, tout = (torch.from_numpy(x) for x in (q, k, v, g, out))
    dsum = (tg * tout).sum(-1)  # D = rowsum(dO∘O), as the plain version takes it
    args = (tq, tk, tv, tg, torch.from_numpy(km),
            None if slopes is None else torch.from_numpy(slopes), torch.from_numpy(lse), dsum)
    dq, skipped_a = _k4a_tf32(*args, scale=scale, window=window, three=three)
    (dk, dv), skipped_b = _k4b_tf32(*args, scale=scale, window=window, three=three)
    return [x.numpy() for x in (dq, dk, dv)], kern, plain, (skipped_a, skipped_b), lse


@pytest.mark.parametrize("case", K4B_CASES, ids=_ids)
def test_k4b_3xtf32_walk_holds_the_fp32_gate(case):
    """The CPU witness of K4b's fp32 numerics on the card
    (`flash_bwd_dkv_tf32`): 3xTF32 products on the kernel's key blocks and
    query-tile walk stay within K4's fp32 gate of the JAX kernels
    (interpret mode) and of the plain version in dk and dv, fully masked
    rows (lse -1e30) and fully padded key blocks included."""
    got, kern, plain, (_, skipped), lse = _k4_case(case)
    lengths = case[6]
    assert (skipped > 0) == (min(lengths) < case[0] - fa.TILE + 1)
    if case[3] > 0 and min(lengths) < case[0] - case[3]:
        assert (lse == fa.NEG_INF).any()  # a window leaves rows with no valid key
    for name, a, b, c in zip(("dk", "dv"), got[1:], kern[1:], plain[1:]):
        _close(a, b, "float32", f"{name} against the TPU kernels (interpret mode)")
        _close(a, c, "float32", f"{name} against the plain version")


@pytest.mark.parametrize("case", K4B_CASES, ids=_ids)
def test_k4a_3xtf32_walk_holds_the_fp32_gate(case):
    """The CPU witness of K4a's fp32 numerics on the card
    (`flash_bwd_dq_tf32`): 3xTF32 products on the kernel's query blocks and
    key-tile walk stay within K4's fp32 gate of the JAX kernels (interpret
    mode) and of the plain version in dq; fully masked rows (lse -1e30: a
    window's dead rows, a fully padded batch row) get dq exactly 0, and the
    walk skips key tiles exactly where a row's padded tail fills one."""
    got, kern, plain, (skipped, _), lse = _k4_case(case)
    T, window, lengths = case[0], case[3], case[6]
    assert (skipped > 0) == (min(lengths) <= T - K4A_KT)
    if window > 0 and min(lengths) < T - window:
        assert (lse == fa.NEG_INF).any()  # a window leaves rows with no valid key
    assert (got[0][lse == fa.NEG_INF] == 0).all()
    _close(got[0], kern[0], "float32", "dq against the TPU kernels (interpret mode)")
    _close(got[0], plain[0], "float32", "dq against the plain version")


def _gate_excess(got, want):
    """The largest |Δ| − 1e-5·|ref| over 1e-5·max|ref|: above 1 fails K4's
    fp32 gate."""
    return float(((np.abs(got - want) - 1e-5 * np.abs(want)) / (1e-5 * np.abs(want).max())).max())


def test_single_tf32_product_fails_the_k4b_fp32_gate():
    """Why K4b's fp32 path splits its operands: one TF32 product per pair
    misses K4's fp32 gate in the decoder's global layers."""
    case = (512, 64, 256, 0, 1.0, False, (20, 475))
    one, _, plain, _, _ = _k4_case(case, three=False)
    assert max(_gate_excess(a, b) for a, b in zip(one[1:], plain[1:])) > 1
    three, _, plain, _, _ = _k4_case(case)
    assert max(_gate_excess(a, b) for a, b in zip(three[1:], plain[1:])) <= 1


def test_single_tf32_product_fails_the_k4a_fp32_gate():
    """Why K4a's fp32 path splits its operands: one TF32 product per pair
    misses K4's fp32 gate in dq in the decoder's global layers (by ~120×
    on this case), where 3xTF32 stays within it."""
    case = (512, 64, 256, 0, 1.0, False, (20, 475))
    one, _, plain, _, _ = _k4_case(case, three=False)
    assert _gate_excess(one[0], plain[0]) > 1
    three, _, plain, _, _ = _k4_case(case)
    assert _gate_excess(three[0], plain[0]) <= 1
