"""Port's flash attention (plain version on the CPU) == the JAX flash kernel.

The JAX side runs the Pallas kernel in interpret mode on the CPU, as
tests/test_flash_attention.py does. Inputs come from a numpy seed, with key
padding that leaves fully masked query rows under a window (and one case
with a fully padded batch row); output and lse are compared on ALL rows,
those included. Tolerances: fp32 1e-5 absolute (summation order only),
bf16 2e-2 (a flipped rounding of P or of the output). The fp32 kernel's
arithmetic (3xTF32 products on the card's walk) is witnessed by an
emulation held to the fp32 gate |Δ| ≤ 1e-5 + 1e-5·|ref|.
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

from sgpt_tpu.ops.pallas.flash_attention import flash_attention as jax_flash  # noqa: E402
from sgpt_tpu_torch.ops import flash_attention as fa  # noqa: E402
from test_torch_short_attention import PV_ORDER, _mma_tf32  # noqa: E402

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}

CASES = [  # T, Dh, block_kv, window, scale, alibi, lengths
    (128, 64, 128, 0, 1.0, False, (20, 91)),
    (128, 16, 256, 64, 0.125, True, (20, 128)),
    (256, 64, 256, 0, 0.125, False, (0, 219)),      # a fully padded batch row
    (256, 16, 128, 64, 1.0, False, (20, 219)),
    (256, 64, 128, 256, 1.0, True, (20, 219)),
    (512, 64, 256, 256, 1.0, False, (20, 475)),     # the decoder's local layers
    (512, 16, 128, 64, 0.125, True, (20, 475)),
    (512, 64, 256, 0, 1.0, True, (20, 475)),
]


def _inputs(seed, T, Dh, lengths, alibi, B=2, H=2):
    """q/k/v (B, H, T, Dh) at the scale of real projections (std 0.5), a key
    mask of right padding, and BLOOM-sized slopes."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(0.0, 0.5, (B, H, T, Dh)).astype(np.float32) for _ in range(3))
    km = (np.arange(T)[None, :] < np.asarray(lengths)[:, None]).astype(np.int32)
    slopes = (0.03 * rng.random(H)).astype(np.float32) if alibi else None
    return q, k, v, km, slopes


def _jax(q, k, v, km, slopes, dtype, **kw):
    jd = DTYPES[dtype][1]
    out, lse = jax_flash(jnp.asarray(q, jd), jnp.asarray(k, jd), jnp.asarray(v, jd),
                         jnp.asarray(km), None if slopes is None else jnp.asarray(slopes),
                         return_residuals=True, **kw)
    return np.asarray(out.astype(jnp.float32)), np.asarray(lse)


def _torch(q, k, v, km, slopes, dtype, **kw):
    td = DTYPES[dtype][0]
    out, lse = fa.flash_attention(
        *(torch.from_numpy(x).to(td) for x in (q, k, v)), torch.from_numpy(km),
        None if slopes is None else torch.from_numpy(slopes), return_residuals=True, **kw)
    assert out.dtype == td and lse.dtype == torch.float32
    return out.float().numpy(), lse.numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "T{}-Dh{}-bkv{}-w{}-s{}-{}".format(
    *c[:5], "alibi" if c[5] else "noalibi"))
def test_plain_version_matches_jax_kernel(case, dtype):
    T, Dh, block_kv, window, scale, alibi, lengths = case
    q, k, v, km, slopes = _inputs(T + Dh + window, T, Dh, lengths, alibi)
    kw = dict(scale=scale, window=window, block_kv=block_kv)
    want_o, want_l = _jax(q, k, v, km, slopes, dtype, **kw)
    launches = fa.launches
    got_o, got_l = _torch(q, k, v, km, slopes, dtype, **kw)
    assert fa.launches == launches  # a CPU tensor takes the plain version
    assert got_o.shape == want_o.shape == q.shape and got_l.shape == want_l.shape == q.shape[:3]
    np.testing.assert_allclose(got_o, want_o, atol=TOL[dtype], rtol=0)
    np.testing.assert_allclose(got_l, want_l, atol=TOL[dtype], rtol=0)


@pytest.mark.parametrize("block_kv,window", [(128, 64), (256, 64), (128, 256), (256, 256)])
def test_fully_masked_rows_average_v_over_the_visited_tiles(block_kv, window):
    """A padded row that the window leaves with no valid key: m stays -1e30,
    every key of the tiles its query tile visits gets p = 1, so the output is
    the mean of V over those keys and lse = -1e30, as in the TPU kernel."""
    T, L = 512, 20
    q, k, v, km, _ = _inputs(7, T, 16, (L, T), False)
    out, lse = fa.flash_attention_reference(
        *(torch.from_numpy(x) for x in (q, k, v)), torch.from_numpy(km),
        window=window, block_kv=block_kv)
    dead = [r for r in range(T) if r - window + 1 >= L]
    assert dead
    for r in dead:
        qi = r // 128
        keys = [j for ki in range(T // block_kv)
                if fa._visited(qi, ki, 128, block_kv, window)
                for j in range(ki * block_kv, (ki + 1) * block_kv)]
        np.testing.assert_allclose(out[0, :, r].numpy(), v[0][:, keys].mean(axis=1), atol=1e-5)
        assert (lse[0, :, r] == fa.NEG_INF).all()


@pytest.mark.parametrize("T,block_q,block_kv", [(200, 128, 128), (384, 128, 256)])
def test_blocks_that_do_not_divide_t_raise(T, block_q, block_kv):
    q, k, v, km, _ = _inputs(0, T, 16, (T, T), False)
    with pytest.raises(AssertionError):  # the JAX function asserts
        _jax(q, k, v, km, None, "float32", block_q=block_q, block_kv=block_kv)
    with pytest.raises(ValueError, match="divide"):
        _torch(q, k, v, km, None, "float32", block_q=block_q, block_kv=block_kv)


def test_backward_raises_naming_k4():
    """Named for the refusal it replaced (the backward, K4a/K4b, is ported
    now): with a gradient the call goes through `FlashAttention`, whose
    backward is `flash_attention_bwd` (its plain version on the CPU) from the
    forward's own output and logsumexp; without one there is no graph."""
    q, k, v, km, _ = _inputs(1, 128, 16, (128, 60), False)
    g = np.random.default_rng(2).normal(size=q.shape).astype(np.float32)
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    before = (fa.bwd_dq_launches, fa.bwd_dkv_launches)
    out, lse = fa.flash_attention(qt, kt, vt, torch.from_numpy(km), window=64,
                                  return_residuals=True)
    assert out.grad_fn is not None and not lse.requires_grad
    out.backward(torch.from_numpy(g))
    assert (fa.bwd_dq_launches, fa.bwd_dkv_launches) == before  # CPU: the plain version
    want = fa.flash_attention_bwd_reference(
        *(torch.from_numpy(x) for x in (q, k, v)), torch.from_numpy(km), None,
        torch.from_numpy(g), out.detach(), lse, window=64)
    for t, w in zip((qt, kt, vt), want):
        assert torch.equal(t.grad, w)
    with torch.no_grad():  # no graph: the forward alone, equal to the plain version
        out = fa.flash_attention(qt, torch.from_numpy(k), torch.from_numpy(v),
                                 torch.from_numpy(km))
    assert out.grad_fn is None


def test_strided_views_equal_contiguous_inputs():
    """The decoder passes (B, T, H·Dh) projections viewed as (B, H, T, Dh)."""
    B, T, H, Dh = 2, 256, 2, 16
    rng = np.random.default_rng(3)
    q2, k2, v2 = (torch.from_numpy(rng.normal(0, 0.5, (B, T, H * Dh)).astype(np.float32))
                  for _ in range(3))
    km = torch.from_numpy((np.arange(T)[None] < np.array([[100], [T]])).astype(np.int32))
    views = [t.view(B, T, H, Dh).transpose(1, 2) for t in (q2, k2, v2)]
    got = fa.flash_attention(*views, km, window=64)
    want = fa.flash_attention(*(t.contiguous() for t in views), km, window=64)
    assert torch.equal(got, want)


def test_refuses_other_devices():
    x = torch.zeros(1, 1, 128, 16, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        fa.flash_attention(x, x, x, torch.ones(1, 128, dtype=torch.int32))


def _k3_tf32(q, k, v, key_mask, slopes, *, scale, window, block_kv, block_q=128, three=True):
    """`flash_fwd_tf32`'s walk and arithmetic on the CPU: per batch row and
    64-row query tile, the 64-key sub-tiles of the block_kv tiles its
    block_q tile visits, less those `Walk` skips (every pair masked, in a
    tile whose rows all hold a valid key); S = Q·Kᵀ in (3x)TF32 (`_mma_tf32`,
    the card's term order), × scale, + slope·kpos, where(mask, s, -1e30);
    per sub-tile the online softmax m_new, alpha, p = exp(s − m_new), l =
    l·alpha + Σp and O = O·alpha, then O += P·V one 8-key step at a time in
    PV_ORDER; out = O / l (l == 0 → 1), lse = m + log(l). Returns (out,
    lse, number of sub-tiles skipped)."""
    B, H, T, Dh = q.shape
    block_q, block_kv = fa._blocks(T, block_q, block_kv)
    s_all = _mma_tf32(q, k.transpose(-1, -2), range(8), three)
    if scale != 1.0:
        s_all = s_all * scale
    if slopes is not None:
        s_all = s_all + slopes[None, :, None, None] * torch.arange(T, dtype=torch.float32)
    pos = torch.arange(T)
    allowed = pos[None, :] <= pos[:, None]
    if window > 0:
        allowed = allowed & (pos[None, :] > pos[:, None] - window)
    live = key_mask != 0
    s_all = torch.where(allowed[None, None] & live[:, None, None, :], s_all,
                        torch.full((), fa.NEG_INF))
    out, lse, skipped = torch.zeros(B, H, T, Dh), torch.zeros(B, H, T), 0
    sub = fa.TILE  # the card kernel's query rows and keys per sub-tile
    for b in range(B):
        for q0 in range(0, T, sub):
            qs = q0 // block_q * block_q
            last = min(T // block_kv - 1, (qs + block_q - 1) // block_kv)
            all_live = all(bool(live[b, max(0, r - window + 1) if window > 0 else 0])
                           for r in range(q0, q0 + sub))
            subtiles = []
            for ki in range(last + 1):
                if window > 0 and not ki * block_kv + block_kv - 1 > qs - window:
                    continue
                for k0 in range(ki * block_kv, (ki + 1) * block_kv, sub):
                    in_range = k0 <= q0 + sub - 1 and (window <= 0 or k0 + sub - 1 > q0 - window)
                    masked = not bool(live[b, k0:k0 + sub].any()) or not in_range
                    if all_live and masked:
                        skipped += 1
                    else:
                        subtiles.append(k0)
            m = torch.full((H, sub, 1), fa.NEG_INF)
            l, o = torch.zeros(H, sub, 1), torch.zeros(H, sub, Dh)
            for k0 in subtiles:
                s = s_all[b, :, q0:q0 + sub, k0:k0 + sub]
                m_new = torch.maximum(m, s.amax(-1, keepdim=True))
                alpha = torch.exp(m - m_new)
                p = torch.exp(s - m_new)
                l = l * alpha + p.sum(-1, keepdim=True)
                o = o * alpha
                for j in range(0, sub, 8):
                    o = o + _mma_tf32(p[..., j:j + 8], v[b, :, k0 + j:k0 + j + 8], PV_ORDER,
                                      three)
                m = m_new
            l = torch.where(l == 0, torch.ones(()), l)
            out[b, :, q0:q0 + sub] = o / l
            lse[b, :, q0:q0 + sub] = (m + torch.log(l))[..., 0]
    return out, lse, skipped

TF32_CASES = CASES + [  # T, Dh, block_kv, window, scale, alibi, lengths: Dh 128 (GPT-Neo 1.3B)
    (256, 128, 128, 64, 0.125, True, (20, 219)),
    (512, 128, 256, 0, 1.0, False, (0, 475)),        # a fully padded batch row
]


def _fp32_gate(got, want):
    """|Δ| ≤ 1e-5 + 1e-5·|ref| in every element: the largest excess over the
    1e-5 of the absolute part."""
    return float(((got - want).abs() - 1e-5 * want.abs()).max())


def _tf32_case(case, three=True):
    T, Dh, block_kv, window, scale, alibi, lengths = case
    q, k, v, km, slopes = _inputs(T + Dh + window, T, Dh, lengths, alibi)
    kw = dict(scale=scale, window=window, block_kv=block_kv)
    tt = [torch.from_numpy(x) for x in (q, k, v, km)]
    sl = None if slopes is None else torch.from_numpy(slopes)
    got = _k3_tf32(*tt, sl, three=three, **kw)
    return got, fa.flash_attention_reference(*tt, sl, **kw), (q, k, v, km, slopes, kw)


@pytest.mark.parametrize("case", TF32_CASES, ids=lambda c: "T{}-Dh{}-bkv{}-w{}-s{}-{}".format(
    *c[:5], "alibi" if c[5] else "noalibi"))
def test_3xtf32_walk_holds_the_fp32_gate(case):
    """The CPU witness of K3's fp32 numerics on the card (`flash_fwd_tf32`):
    3xTF32 products on the kernel's sub-tile walk, with its online softmax,
    stay within the fp32 gate of the exact plain version and of the JAX
    kernel in output and lse on every row; fully masked rows keep lse -1e30
    on both sides."""
    (got_o, got_l, skipped), (want_o, want_l), (q, k, v, km, slopes, kw) = _tf32_case(case)
    jax_o, jax_l = _jax(q, k, v, km, slopes, "float32", **kw)
    assert skipped > 0  # the walk does skip sub-tiles
    for ref_o, ref_l in ((want_o, want_l), (torch.tensor(jax_o), torch.tensor(jax_l))):
        dead = ref_l == fa.NEG_INF
        assert torch.equal(got_l == fa.NEG_INF, dead)
        assert _fp32_gate(got_o, ref_o) <= 1e-5
        assert _fp32_gate(got_l[~dead], ref_l[~dead]) <= 1e-5
    T, window, lengths = case[0], case[3], case[6]
    rows = np.arange(T)[None, :]
    no_key = [(n == 0) | ((window > 0) & (rows[0] - window + 1 >= n)) for n in lengths]
    assert np.array_equal((want_l == fa.NEG_INF).numpy(),
                          np.broadcast_to(np.stack(no_key)[:, None], want_l.shape))


def test_single_tf32_product_fails_the_k3_fp32_gate():
    """Why K3's fp32 path splits its operands: one TF32 product per pair (11
    significand bits) misses the fp32 gate in the decoder's global layers."""
    case = (512, 64, 256, 0, 1.0, False, (20, 475))
    (one, _, _), (want, _), _ = _tf32_case(case, three=False)
    assert _fp32_gate(one, want) > 1e-5
    (three, _, _), _, _ = _tf32_case(case)
    assert _fp32_gate(three, want) <= 1e-5
