"""Port's pooling: the golden values of tests/test_pooling.py, and parity with
`sgpt_tpu.ops.pooling` (including the bf16 double rounding of pool → normalize)."""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the JAX reference runs on the CPU (as tests/conftest.py sets), also under
# --noconftest on a machine whose JAX would otherwise take the GPU
os.environ.setdefault("JAX_PLATFORMS", "cpu")
pytest.importorskip("jax").config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

from sgpt_tpu.ops import pooling as jax_pooling  # noqa: E402
from sgpt_tpu_torch.ops import pooling  # noqa: E402

rng = np.random.default_rng(0)
B, T, D = 4, 9, 8
H = rng.normal(size=(B, T, D)).astype(np.float32)
MASK = np.ones((B, T), dtype=np.int32)
MASK[1, 6:] = 0
MASK[2, 3:] = 0
MASK[3, 1:] = 0


def _np_weightedmean(h, m):
    w = np.arange(1, T + 1, dtype=np.float64)[None, :, None]
    mm = m[:, :, None].astype(np.float64)
    return (h * mm * w).sum(1) / (mm * w).sum(1)


def _t(a):
    return torch.from_numpy(a)


def test_mean():
    m = MASK[:, :, None]
    np.testing.assert_allclose(pooling.mean_pool(_t(H), _t(MASK)).numpy(),
                               (H * m).sum(1) / m.sum(1), rtol=1e-5)


def test_weightedmean():
    np.testing.assert_allclose(pooling.weighted_mean_pool(_t(H), _t(MASK)).numpy(),
                               _np_weightedmean(H, MASK), rtol=1e-5)


def test_lasttoken():
    lengths = MASK.sum(1)
    want = np.stack([H[i, lengths[i] - 1] for i in range(B)])
    np.testing.assert_allclose(pooling.last_token_pool(_t(H), _t(MASK)).numpy(), want,
                               rtol=1e-6)


def test_normalize_unit_norm():
    got = pooling.normalize(_t(H[:, 0])).numpy()
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, rtol=1e-5)


def test_bf16_accumulates_in_fp32():
    got = pooling.weighted_mean_pool(_t(H).to(torch.bfloat16), _t(MASK))
    assert got.dtype == torch.bfloat16
    assert np.abs(got.float().numpy() - _np_weightedmean(H, MASK)).max() < 0.05


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("method", sorted(pooling.POOLERS))
def test_pool_then_normalize_matches_jax(method, dtype):
    """Pool in fp32 → cast to the hidden dtype → normalise in fp32 → cast: in
    bf16 the port rounds where the JAX package rounds, so the results agree
    to within one bf16 rounding of the (fp32-accumulated) pooled value."""
    h = rng.normal(size=(B, T, D)).astype(np.float32)
    ht = _t(h).to(getattr(torch, dtype))
    hj = jnp.asarray(h).astype(getattr(jnp, dtype))
    got = pooling.normalize(pooling.POOLERS[method](ht, _t(MASK))).float().numpy()
    want = np.asarray(jax_pooling.normalize(
        jax_pooling.POOLERS[method](hj, jnp.asarray(MASK))).astype(jnp.float32))
    np.testing.assert_allclose(got, want, atol=1e-6 if dtype == "float32" else 8e-3)
