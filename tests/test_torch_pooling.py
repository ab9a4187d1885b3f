"""Port's pooling: the golden values of tests/test_pooling.py, and parity with
`sgpt_tpu.ops.pooling` (including the bf16 double rounding of pool → normalize),
for every pooler: the single-layer ones, the all-layer (stack) ones and the
ones with trained weights. fp32 parity within 1e-6; bf16 within one bf16
rounding of the pooled value (8e-3 after normalisation)."""
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
L = 3
STACK = rng.normal(size=(L, B, T, D)).astype(np.float32)


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


def test_learned_weightedmean_golden():
    ones = pooling.learned_weighted_mean_pool(_t(H), _t(MASK), torch.ones(T))
    np.testing.assert_allclose(ones.numpy(), pooling.mean_pool(_t(H), _t(MASK)).numpy(),
                               rtol=1e-5)
    pos = pooling.learned_weighted_mean_pool(_t(H), _t(MASK), torch.arange(1.0, T + 1 + 4))
    np.testing.assert_allclose(pos.numpy(), _np_weightedmean(H, MASK), rtol=1e-5)


def test_meanmean_and_lasttokenmean_golden():
    m = MASK[None, :, :, None]
    want = (STACK * m).sum(axis=(0, 2)) / (L * MASK.sum(1))[:, None]
    np.testing.assert_allclose(pooling.mean_mean_pool(_t(STACK), _t(MASK)).numpy(), want,
                               rtol=1e-5)
    lengths = MASK.sum(1)
    want = np.stack([STACK[:, i, lengths[i] - 1].mean(0) for i in range(B)])
    np.testing.assert_allclose(pooling.last_token_mean_pool(_t(STACK), _t(MASK)).numpy(), want,
                               rtol=1e-5)


def test_max_cls_golden():
    masked = np.where(MASK[:, :, None].astype(bool), H, -1e9)
    np.testing.assert_allclose(pooling.max_pool(_t(H), _t(MASK)).numpy(), masked.max(1),
                               rtol=1e-6)
    np.testing.assert_array_equal(pooling.cls_pool(_t(H), _t(MASK)).numpy(), H[:, 0])


def test_token_weighted_mean_golden():
    w = np.abs(rng.normal(size=(B, T))).astype(np.float32)
    m = MASK[:, :, None].astype(np.float64)
    want = (H * w[:, :, None] * m).sum(1) / (m * w[:, :, None]).sum(1)
    np.testing.assert_allclose(
        pooling.token_weighted_mean_pool(_t(H), _t(MASK), _t(w)).numpy(), want, rtol=1e-5)


def test_pool_dispatch():
    np.testing.assert_array_equal(pooling.pool("weightedmean", _t(H), _t(MASK)).numpy(),
                                  pooling.weighted_mean_pool(_t(H), _t(MASK)).numpy())
    np.testing.assert_array_equal(pooling.pool("meanmean", _t(STACK), _t(MASK)).numpy(),
                                  pooling.mean_mean_pool(_t(STACK), _t(MASK)).numpy())
    w = torch.arange(1.0, T + 1)
    np.testing.assert_array_equal(
        pooling.pool("learned_weightedmean", _t(H), _t(MASK), position_weights=w).numpy(),
        pooling.learned_weighted_mean_pool(_t(H), _t(MASK), w).numpy())
    with pytest.raises(ValueError, match="unknown pooling"):
        pooling.pool("nope", _t(H), _t(MASK))


def _jax_and_port(name, dtype, *extra):
    """The pooler `name` of both packages on the same inputs, in `dtype`,
    with `extra` weights (numpy) passed to both."""
    dt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    src = STACK if name in ("mean_mean_pool", "last_token_mean_pool",
                            "weighted_layer_pool") else H
    got = getattr(pooling, name)(_t(src).to(dt), _t(MASK), *map(_t, extra))
    want = getattr(jax_pooling, name)(jnp.asarray(src).astype(jdt), jnp.asarray(MASK),
                                      *map(jnp.asarray, extra))
    assert str(got.dtype).removeprefix("torch.") == str(want.dtype)
    return got.float().numpy(), np.asarray(want.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,extra", [
    ("max_pool", ()), ("cls_pool", ()), ("mean_mean_pool", ()), ("last_token_mean_pool", ()),
    ("learned_weighted_mean_pool", (rng.random(T + 3).astype(np.float32),)),
    ("token_weighted_mean_pool", (rng.random((B, T)).astype(np.float32),)),
    ("weighted_layer_pool", (rng.random(L).astype(np.float32),))])
def test_new_poolers_match_jax(name, extra, dtype):
    """Each pooler the symmetric slice adds against `sgpt_tpu.ops.pooling`:
    fp32 within 1e-6; bf16 (fp32 accumulation, one cast) within one bf16
    rounding, 8e-3 of values of size ~1; max and cls exactly (no
    arithmetic)."""
    got, want = _jax_and_port(name, dtype, *extra)
    if name in ("max_pool", "cls_pool"):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=1e-6 if dtype == "float32" else 8e-3)


@pytest.mark.parametrize("method", sorted(pooling.STACK_POOLERS))
def test_stack_pool_then_normalize_matches_jax(method):
    """The all-layer poolers through `normalize`, fp32: within 1e-6."""
    got = pooling.normalize(pooling.STACK_POOLERS[method](_t(STACK), _t(MASK))).numpy()
    want = np.asarray(jax_pooling.normalize(
        jax_pooling.STACK_POOLERS[method](jnp.asarray(STACK), jnp.asarray(MASK))))
    np.testing.assert_allclose(got, want, atol=1e-6)
