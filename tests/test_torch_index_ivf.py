"""The port's IVFIndex (`sgpt_tpu_torch.index_ivf`) == `sgpt_tpu.index_ivf.IVFIndex`.

A clustered corpus (a Gaussian mixture of 16 unit centres at D 32, spread
0.25: clear margins between clusters, so no assignment sits on a near-tie)
goes into both indexes with the same seed. Held: the same auto-selected K,
the same block layout (`block_ids`), centroids within 1e-5 (fp32 k-means,
only the summation order differs), the same ids at nprobe 1, 4 and K, and
scores within 1e-5, in bf16 and int8 storage; with overflow, pending adds,
deletes, rebuilds and delete-all; `.npz` files loading across packages;
nprobe = K against the port's exact `DenseIndex`.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
os.environ.setdefault("JAX_PLATFORMS", "cpu")
pytest.importorskip("jax").config.update("jax_platforms", "cpu")

from sgpt_tpu.index_ivf import IVFIndex as JaxIVF  # noqa: E402
from sgpt_tpu_torch.index import DenseIndex  # noqa: E402
from sgpt_tpu_torch.index_ivf import IVFIndex  # noqa: E402
from sgpt_tpu_torch.parallel import make_mesh  # noqa: E402

D = 32


def _mixture(n, seed=0, centers=16, spread=0.25):
    rng = np.random.default_rng(seed)
    mu = rng.standard_normal((centers, D))
    mu /= np.linalg.norm(mu, axis=1, keepdims=True)
    x = mu[rng.integers(0, centers, n)] + spread * rng.standard_normal((n, D))
    return x.astype(np.float32), rng


EMB, _RNG = _mixture(3000)
QUERIES = (EMB[_RNG.integers(0, 3000, 24)] + 0.05 * _RNG.standard_normal((24, D))
           ).astype(np.float32)
EXTRA, _ = _mixture(300, seed=5)


def _both(quantize=None, emb=EMB, **kw):
    """The JAX and the port index over the same rows, built."""
    ref = JaxIVF(D, quantize=quantize, **kw)
    port = IVFIndex(D, quantize=quantize, device="cpu", **kw)
    for idx in (ref, port):
        idx.add(emb, ids=[f"d{i}" for i in range(len(emb))])
        idx.build()
    return ref, port


def _same_search(ref, port, nprobes=(4, None), k=10, queries=QUERIES):
    for nprobe in nprobes:
        want_v, want_i = ref.search_embeddings(queries, k=k, nprobe=nprobe)
        got_v, got_i = port.search_embeddings(queries, k=k, nprobe=nprobe)
        assert got_i == want_i, nprobe
        for g, w in zip(got_v, want_v):
            assert g.dtype == np.float32
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)


def _same_layout(ref, port):
    assert port.selected_k == ref.selected_k and port._k_real == ref._k_real
    np.testing.assert_array_equal(port._block_ids.numpy(), np.asarray(ref._block_ids))
    np.testing.assert_allclose(port._centroids.numpy(), np.asarray(ref._centroids),
                               rtol=0, atol=1e-5)
    assert port._overflow_count == ref._overflow_count
    np.testing.assert_array_equal(port._overflow_ids, ref._overflow_ids)


@pytest.mark.parametrize("quantize", [None, "int8"])
@pytest.mark.parametrize("kw", [dict(n_clusters="auto"),
                                dict(n_clusters=16, pad_factor=1.0, max_train_rows=1024)],
                         ids=["auto", "overflow-sampled"])
def test_build_and_search_match_jax(quantize, kw):
    """auto-K (the sweep's draws, then the seed rows, from one generator);
    a fixed K with a small pad_factor (an overflow slab) trained on a
    1,024-row sample."""
    ref, port = _both(quantize, **kw)
    _same_layout(ref, port)
    if kw["n_clusters"] == "auto":
        assert port.selected_k == 32
    else:
        assert port._overflow_count > 0
    assert port._blocks.dtype == (torch.int8 if quantize else torch.bfloat16)
    _same_search(ref, port, nprobes=(1, 4, port.selected_k))


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_pending_delete_rebuild_match_jax(quantize):
    """Adds after build() (pending slab), deletes in blocks, in the overflow
    slab and among the pending rows, a rebuild, then deleting everything."""
    ref, port = _both(quantize, n_clusters=16, pad_factor=1.0)
    extra_ids = [f"e{i}" for i in range(len(EXTRA))]
    for idx in (ref, port):
        idx.add(EXTRA, ids=extra_ids)
        assert idx.pending_docs == len(EXTRA)
    _same_search(ref, port)
    overflow = [f"d{i}" for i in port._overflow_ids[:5]]
    gone = ["d0", "d7", "d100"] + overflow + ["e0", "e9"]
    for idx in (ref, port):
        assert idx.delete(gone) == len(gone)
    assert len(port) == len(ref) == len(EMB) + len(EXTRA) - len(gone)
    _same_search(ref, port)
    hits = port.search_embeddings(EMB[[0, 7, 100]], k=5, nprobe=16)[1]
    assert not set(gone) & {i for row in hits for i in row}
    with pytest.raises(KeyError):
        port.delete(["d0"])
    for idx in (ref, port):
        idx.build()
    _same_layout(ref, port)
    _same_search(ref, port)
    everything = [i for i in port._ids]
    for idx in (ref, port):
        idx.delete(everything)
        idx.build()
    assert len(port) == 0 and not port.is_built
    vals, ids = port.search_embeddings(QUERIES[:2], k=3)
    assert ids == [[], []] and [v.size for v in vals] == [0, 0]
    with pytest.raises(RuntimeError, match="empty"):
        port.build()


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_nprobe_all_equals_the_exact_index(quantize):
    """Probing every cluster (with an overflow slab) gives the exact scan's
    top-k: the port's DenseIndex over the same rows and storage (fp32, so
    that both round the same normalised fp32 queries: a bf16 DenseIndex
    normalises its queries after rounding them)."""
    dtype = "float32"
    port = IVFIndex(D, n_clusters=16, pad_factor=1.0, quantize=quantize, dtype=dtype,
                    device="cpu")
    exact = DenseIndex(D, quantize=quantize, dtype=dtype, device="cpu")
    for idx in (port, exact):
        idx.add(EMB)
        idx.build()
    assert port._overflow_count > 0
    got_v, got_i = port.search_embeddings(QUERIES, k=10, nprobe=16)
    want_v, want_i = exact.search_embeddings(QUERIES, k=10)
    assert got_i == want_i
    np.testing.assert_allclose(np.stack(got_v), np.stack(want_v), rtol=0, atol=1e-5)


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_save_load_across_packages(tmp_path, quantize):
    """Port → JAX and JAX → port, with pending rows and tombstones in the file."""
    ref, port = _both(quantize, n_clusters=16, pad_factor=1.0)
    for idx in (ref, port):
        idx.add(EXTRA[:40], ids=[f"e{i}" for i in range(40)])
        idx.delete(["d3", "e1", f"d{port._overflow_ids[0]}"])
    port.save(str(tmp_path / "port.npz"))
    ref.save(str(tmp_path / "jax.npz"))
    from_port = JaxIVF.load(str(tmp_path / "port.npz"))
    from_jax = IVFIndex.load(str(tmp_path / "jax.npz"), device="cpu")
    assert from_jax.dtype == torch.bfloat16 and from_jax.quantize == quantize
    _same_search(ref, from_jax)
    _same_search(from_port, port)
    assert len(from_jax) == len(ref) and from_jax.pending_docs == ref.pending_docs
    again = IVFIndex.load(str(tmp_path / "port.npz"), device="cpu")
    (got_v, got_i), (want_v, want_i) = (again.search_embeddings(QUERIES, k=10),
                                        port.search_embeddings(QUERIES, k=10))
    assert got_i == want_i   # the round trip: the same results bit for bit
    assert all(np.array_equal(a, b) for a, b in zip(got_v, want_v))


def test_contracts_and_refusals():
    """Empty and pre-build searches, argument checks, and a mesh's device
    (tests/test_torch_mesh_serving.py holds sharded searches to JAX's)."""
    idx = IVFIndex(D, device="cpu")
    assert idx.search_embeddings(np.zeros((0, D), np.float32)) == ([], [])
    assert idx.search_embeddings(QUERIES[:1])[1] == [[]]
    idx.add(EMB[:100])
    with pytest.raises(RuntimeError, match="build"):
        idx.search_embeddings(QUERIES[:1])
    with pytest.raises(ValueError):
        idx.add(EMB[:3, :8])
    with pytest.raises(ValueError, match="n_clusters"):
        IVFIndex(D, n_clusters=0, device="cpu")
    with pytest.raises(ValueError, match="quantize"):
        IVFIndex(D, quantize="int4", device="cpu")
    mesh = make_mesh(dp=2, tp=1, devices=["cpu", "cpu"])
    assert IVFIndex(D, mesh=mesh).device == torch.device("cpu")
    with pytest.raises(ValueError, match="first device"):
        IVFIndex(D, mesh=mesh, device="cuda:1")
    idx.build()
    v, ids = idx.search_embeddings(QUERIES[:3], k=500)
    assert [len(r) for r in ids] == [len(r) for r in v] == [100] * 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            IVFIndex(D)
