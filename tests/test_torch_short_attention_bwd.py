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

from test_torch_short_attention import CASES, _inputs  # noqa: E402

ATOL, RTOL = 1e-5, 1e-5


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
