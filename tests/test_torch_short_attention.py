"""Port's fused short-T attention (plain version on the CPU) == the JAX kernel.

The JAX side runs the Pallas kernel in interpret mode on the CPU, as
tests/test_short_attention.py does, and its `_reference_hd` oracle. Inputs
come from a numpy seed. fp32 throughout; tolerance 1e-5 absolute.
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

from sgpt_tpu.ops.pallas.short_attention import _reference_hd  # noqa: E402
from sgpt_tpu.ops.pallas.short_attention import short_attention as jax_short_attention  # noqa: E402
from sgpt_tpu_torch.ops import short_attention as sa  # noqa: E402

ATOL = 1e-5


def _inputs(seed, B, T, H, Dh, pad_at=None, segments=False, alibi=False):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, T, H * Dh)).astype(np.float32) for _ in range(3))
    km = np.ones((B, T), np.int32)
    if pad_at is not None:
        km[-1, pad_at:] = 0
    slopes = (rng.random(H) if alibi else np.zeros(H)).astype(np.float32)
    seg = pos = None
    if segments or alibi:  # three contiguous segments, positions restart in each
        cuts = np.sort(rng.choice(np.arange(4, T - 4), size=2, replace=False))
        seg_row = np.searchsorted(cuts, np.arange(T), side="right").astype(np.int32)
        pos_row = np.arange(T) - np.concatenate([[0], cuts])[seg_row]
        seg = np.tile(seg_row, (B, 1)) if segments else None
        pos = np.tile(pos_row, (B, 1)).astype(np.int32) if alibi else None
    return q, k, v, km, slopes, seg, pos


CASES = {  # name: (T, scale, window, pad_at, alibi, segments)
    "plain": (40, 1.0, 0, None, False, False),
    "scale": (40, 0.25, 0, 30, False, False),
    "window": (40, 1.0, 8, 30, False, False),
    "window-scale": (40, 0.25, 8, 30, False, False),
    # rows 46.. of the last batch row see no valid key: uniform 1/T softmax
    "fully-masked-rows": (60, 1.0, 16, 30, False, False),
    "alibi-positions": (48, 1.0, 0, 40, True, False),
    "segments": (48, 0.25, 0, 42, False, True),
    "segments-alibi-window": (48, 1.0, 8, 42, True, True),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_jax_kernel_and_reference(name):
    T, scale, window, pad_at, alibi, segments = CASES[name]
    B, H, Dh = 2, 4, 16
    q, k, v, km, slopes, seg, pos = _inputs(len(name), B, T, H, Dh, pad_at,
                                            segments, alibi)
    tt = (lambda a: None if a is None else torch.from_numpy(a))
    got = sa.short_attention(tt(q), tt(k), tt(v), tt(km), tt(slopes), scale,
                             window, H, alibi, segments=tt(seg), positions=tt(pos))
    jj = (lambda a: None if a is None else jnp.asarray(a))
    want_kernel = jax_short_attention(jj(q), jj(k), jj(v), jj(km), jj(slopes),
                                      scale, window, H, alibi,
                                      segments=jj(seg), positions=jj(pos))
    want_ref = _reference_hd(jj(q), jj(k), jj(v), jj(km), jj(slopes), scale=scale,
                             window=window, H=H, use_alibi=alibi,
                             segments=jj(seg), positions=jj(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want_kernel), atol=ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_ref), atol=ATOL)


def test_fully_masked_rows_are_uniform():
    """A padded query row that the window leaves with no valid key averages
    V over all T keys (softmax of T equal -1e9 scores), as the TPU kernel does."""
    T, H, Dh, window = 60, 2, 16, 16
    q, k, v, km, slopes, _, _ = _inputs(0, 2, T, H, Dh, pad_at=30)
    got = sa.short_attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(km), None, scale=1.0, window=window, H=H, use_alibi=False)
    np.testing.assert_allclose(got[1, 46:].numpy(),
                               np.broadcast_to(v[1].mean(0), (T - 46, H * Dh)),
                               atol=ATOL)


def test_cpu_tensor_takes_plain_version_without_counting():
    q, k, v, km, _, _, _ = _inputs(1, 2, 24, 2, 8)
    before = sa.launches
    args = [torch.from_numpy(a) for a in (q, k, v, km)]
    got = sa.short_attention(*args, None, 1.0, 0, 2, False)
    want = sa.short_attention_reference(*args, None, scale=1.0, window=0, H=2,
                                        use_alibi=False)
    assert torch.equal(got, want)
    assert sa.launches == before


def test_bf16_plain_version_casts_probabilities():
    """bf16 in → bf16 out, probabilities rounded to bf16 before P·V, as in
    the JAX reference (compared on the same bf16-rounded inputs)."""
    q, k, v, km, slopes, _, _ = _inputs(2, 2, 40, 4, 16, pad_at=30)
    tb = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    got = sa.short_attention(*tb, torch.from_numpy(km), None, 1.0, 8, 4, False)
    assert got.dtype == torch.bfloat16
    jb = [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in tb]
    want = _reference_hd(*jb, jnp.asarray(km), jnp.asarray(slopes), scale=1.0,
                         window=8, H=4, use_alibi=False)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)), atol=2e-2)
