"""Port's `mips_topk` (the plain version, on CPU tensors) == the JAX Pallas
kernel `sgpt_tpu.ops.pallas.mips.mips_topk` in interpret mode, as
tests/test_pallas_mips.py runs it.

The four cases of that file, a bf16 corpus, Q = 1, k = 1 and 16, valid_count
< k (ids compared only in slots above -1e29: the filler's index differs by
design), N with a tail, and k = 17 refused. Values within 1e-5 (the products
are exact on both sides; the sums run in another order); ids equal. A CPU
call launches no kernel.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
os.environ.setdefault("JAX_PLATFORMS", "cpu")
pytest.importorskip("jax").config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

from sgpt_tpu.ops.pallas.mips import mips_topk as jax_mips_topk  # noqa: E402
from sgpt_tpu_torch.ops import mips  # noqa: E402


def _brute(q, c, k):
    scores = q @ c.T
    idx = np.argsort(-scores, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(scores, idx, axis=1), idx


def _run_both(q, c, valid, k, tile_n, dtype=np.float32):
    launches = mips.launches
    if dtype == np.float32:
        got = mips.mips_topk(torch.from_numpy(q), torch.from_numpy(c), valid, k=k)
        want = jax_mips_topk(jnp.asarray(q), jnp.asarray(c), valid, k=k, tile_n=tile_n,
                             interpret=True)
    else:
        got = mips.mips_topk(torch.from_numpy(q).to(torch.bfloat16),
                             torch.from_numpy(c).to(torch.bfloat16), valid, k=k)
        want = jax_mips_topk(jnp.asarray(q, jnp.bfloat16), jnp.asarray(c, jnp.bfloat16),
                             valid, k=k, tile_n=tile_n, interpret=True)
    assert mips.launches == launches, "a CPU call must not count a kernel launch"
    gv, gi = (t.numpy() for t in got)
    wv, wi = (np.asarray(t) for t in want)
    assert gv.dtype == np.float32 and gi.dtype == np.int32 and gv.shape == wv.shape
    real = wv > -1e29
    np.testing.assert_array_equal(gv > -1e29, real)
    np.testing.assert_allclose(gv, wv, atol=1e-5)
    np.testing.assert_array_equal(np.where(real, gi, -1), np.where(real, wi, -1))
    assert (gi[~real] == 0).all()  # the port's filler index
    return gv, gi


def _data(Q, N, D, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(Q, D)).astype(np.float32),
            rng.normal(size=(N, D)).astype(np.float32))


def test_mips_exact():
    q, c = _data(8, 1024, 64, 0)
    vals, idx = _run_both(q, c, 1024, 10, 256)
    wv, wi = _brute(q, c, 10)
    np.testing.assert_allclose(vals, wv, atol=1e-4)
    np.testing.assert_array_equal(idx, wi)


def test_mips_valid_count_masking():
    q, c = _data(4, 512, 32, 1)
    c[400:] = 50.0  # padded region must be invisible
    _, idx = _run_both(q, c, 400, 5, 128)
    assert (idx < 400).all()


def test_mips_single_tile_and_ties():
    q, c = _data(3, 128, 16, 2)
    c[7] = c[3]  # exact tie: lowest index must win first
    q[0] = c[3]
    vals, idx = _run_both(q, c, 128, 4, 128)
    assert idx[0].tolist()[:2] == [3, 7]
    np.testing.assert_array_equal(idx, _brute(q, c, 4)[1])


def test_mips_results_sorted_desc():
    q, c = _data(2, 256, 8, 3)
    vals, _ = _run_both(q, c, 256, 8, 64)
    assert (np.diff(vals, axis=1) <= 1e-6).all()


@pytest.mark.parametrize("Q,N,D,k,valid,tile", [
    (1, 512, 32, 10, 512, 128),     # one query
    (5, 512, 32, 1, 512, 128),      # k = 1
    (5, 768, 32, 16, 768, 256),     # k = 16, the largest
    (4, 512, 32, 10, 6, 128),       # valid_count < k: filler slots
    (4, 512, 32, 10, 0, 128),       # nothing valid
    (3, 1000, 24, 10, 1000, 8)])    # N with a tail no power-of-two tile divides
def test_mips_shapes(Q, N, D, k, valid, tile):
    q, c = _data(Q, N, D, Q + N + k)
    _run_both(q, c, valid, k, tile)


def test_mips_bf16_corpus():
    q, c = _data(6, 1024, 64, 7)
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    c[900:910] = c[10:20]  # duplicate rows: ties in bf16 too
    _run_both(q, c, 1024, 10, 256, dtype="bfloat16")


def test_k_above_16_is_refused():
    q, c = _data(2, 256, 8, 4)
    with pytest.raises(AssertionError):
        jax_mips_topk(jnp.asarray(q), jnp.asarray(c), 256, k=17, tile_n=128, interpret=True)
    with pytest.raises(ValueError, match="k=17"):
        mips.mips_topk(torch.from_numpy(q), torch.from_numpy(c), 256, k=17)


def test_valid_count_is_clamped():
    q, c = _data(2, 256, 8, 5)
    a = mips.mips_topk(torch.from_numpy(q), torch.from_numpy(c), 10**9, k=5)
    b = mips.mips_topk(torch.from_numpy(q), torch.from_numpy(c), 256, k=5)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    v, i = mips.mips_topk(torch.from_numpy(q), torch.from_numpy(c), -3, k=5)
    assert (v == mips.NEG).all() and (i == 0).all()
