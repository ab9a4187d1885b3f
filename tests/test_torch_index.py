"""Port's `DenseIndex` == `sgpt_tpu.index.DenseIndex` on the same embeddings.

Both packages get the same add / build / delete / search sequence; the
results must hold the same ids, in the same order, and scores within 1e-5
(the products are exact on both sides, the sums run in another order). The
JAX "pallas" index runs its Pallas kernel in interpret mode, the port's its
plain version (CPU tensors). Also: the int8 recall bound of
tests/test_index.py, the refusals, `save`/`load` across the two packages
both ways, and `index_corpus` on a tiny GPT-Neo with the same weights.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
os.environ.setdefault("JAX_PLATFORMS", "cpu")
pytest.importorskip("jax").config.update("jax_platforms", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sgpt_tpu.index import DenseIndex as JaxIndex  # noqa: E402
from sgpt_tpu_torch.index import DenseIndex  # noqa: E402
from sgpt_tpu_torch.ops import mips  # noqa: E402
from sgpt_tpu_torch.parallel import make_mesh  # noqa: E402

DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _data(n=1000, d=32, q=7, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, d)).astype(np.float32),
            rng.normal(size=(q, d)).astype(np.float32))


def _pair(dim, dtype="float32", **kw):
    t, j = DTYPES[dtype]
    return DenseIndex(dim, dtype=t, device="cpu", **kw), JaxIndex(dim, dtype=j, **kw)


def _same(a, b, queries, k):
    va, ia = a.search_embeddings(queries, k=k)
    vb, ib = b.search_embeddings(queries, k=k)
    assert ia == ib
    assert len(va) == len(vb)
    for x, y in zip(va, vb):
        assert x.dtype == np.float32 and x.shape == np.asarray(y).shape
        np.testing.assert_allclose(x, np.asarray(y, np.float32), atol=1e-5)
    return ia


def _brute_cosine(queries, corpus, k):
    qn = queries / np.linalg.norm(queries, axis=1, keepdims=True)
    cn = corpus / np.linalg.norm(corpus, axis=1, keepdims=True)
    return np.argsort(-(qn @ cn.T), axis=1)[:, :k]


@pytest.mark.parametrize("kernel", ["blockmax", "pallas"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_single_device_matches_jax(kernel, dtype):
    corpus, queries = _data()
    port, ref = _pair(32, dtype, kernel=kernel)
    for idx in (port, ref):
        idx.add(corpus[:400], ids=[f"a{i}" for i in range(400)])
        idx.add(corpus[400:], ids=[f"b{i}" for i in range(600)])
        idx.build()
    launches = mips.launches
    ids = _same(port, ref, queries, 13)
    assert mips.launches == launches  # CPU tensors: the plain version
    assert len(port) == 1000 and port.is_built and port.pending_docs == 0
    if dtype == "float32":
        all_ids = [f"a{i}" for i in range(400)] + [f"b{i}" for i in range(600)]
        for row, want in zip(ids, _brute_cosine(queries, corpus, 13)):
            assert set(row) == {all_ids[j] for j in want}


def test_multislab_matches_jax():
    corpus, queries = _data(n=1100, d=16, q=4, seed=8)
    port, ref = _pair(16, slab_size=256)
    for idx in (port, ref):
        idx.add(corpus)
        idx.build()
    assert port._corpus.shape[0] == ref._corpus.shape[0] and port._slab_eff == ref._slab_eff
    _same(port, ref, queries, 7)
    whole = DenseIndex(16, dtype=torch.float32, device="cpu")
    whole.add(corpus)
    whole.build()
    _same(port, whole, queries, 7)


def test_dot_mode_matches_jax():
    corpus, queries = _data(n=256, d=8, q=3, seed=2)
    port, ref = _pair(8, normalize_embeddings=False)
    for idx in (port, ref):
        idx.add(corpus)
        idx.build()
    _same(port, ref, queries, 5)


def test_int8_matches_jax_and_recall():
    """quantize='int8': the same ids as the JAX int8 index, and recall@10
    against exact fp32 >= 0.99 (tests/test_index.py's bound)."""
    corpus, queries = _data(n=4096, d=64, q=32, seed=11)
    port, ref = _pair(64, "bfloat16", quantize="int8")
    for idx in (port, ref):
        idx.add(corpus)
        idx.build()
    assert port._corpus.dtype == torch.int8
    ids = _same(port, ref, queries, 10)
    want = _brute_cosine(queries, corpus, 10)
    hits = sum(len({str(j) for j in w} & set(g)) for g, w in zip(ids, want))
    assert hits / want.size >= 0.99


@pytest.mark.parametrize("kernel,quantize", [("blockmax", None), ("pallas", None),
                                             ("blockmax", "int8")])
def test_incremental_add_matches_jax(kernel, quantize):
    corpus, queries = _data(n=600, d=32, q=5, seed=13)
    port, ref = _pair(32, kernel=kernel, quantize=quantize)
    for idx in (port, ref):
        idx.add(corpus[:300], ids=[str(i) for i in range(300)])
        idx.build()
        idx.add(corpus[300:450], ids=[str(i) for i in range(300, 450)])
    assert port.pending_docs == ref.pending_docs == 150
    _same(port, ref, queries, 10)
    for idx in (port, ref):
        idx.add(corpus[450:], ids=[str(i) for i in range(450, 600)])
    before = _same(port, ref, queries, 10)
    for idx in (port, ref):
        idx.build()
    assert port._built_count == 600 and not port._chunks
    assert _same(port, ref, queries, 10) == before


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_delete_then_compact_matches_jax(quantize):
    corpus, queries = _data(n=500, d=24, q=4, seed=21)
    port, ref = _pair(24, quantize=quantize)
    ids_all = [f"d{i}" for i in range(500)]
    for idx in (port, ref):
        idx.add(corpus, ids=ids_all)
        idx.build()
    first = _same(port, ref, queries, 3)
    dele = sorted({first[0][0], "d7", "d499"})
    for idx in (port, ref):
        assert idx.delete(dele) == len(dele)
    assert len(port) == 500 - len(dele) == port.live_count
    got = _same(port, ref, queries, 5)
    assert not ({x for r in got for x in r} & set(dele))
    more, _ = _data(n=20, d=24, q=1, seed=22)
    for idx in (port, ref):
        idx.add(more, ids=[f"p{i}" for i in range(20)])
        idx.delete(["p0", "p19", "d100"])
    assert port.pending_docs == 18
    before = _same(port, ref, queries, 8)
    for idx in (port, ref):
        idx.build()
    assert port._deleted == set() and len(port) == 520 - len(dele) - 3
    assert _same(port, ref, queries, 8) == before
    with pytest.raises(KeyError):
        port.delete(["not-there"])
    with pytest.raises(KeyError):
        port.delete(["p1", "p1"])


def test_delete_all_and_empty_batches():
    corpus, queries = _data(n=64, d=16, q=2, seed=24)
    idx = DenseIndex(16, device="cpu")
    idx.add(corpus[:4], ids=["a", "b", "c", "d"])
    idx.build()
    assert idx.search_embeddings(np.zeros((0, 16), np.float32)) == ([], [])
    assert idx.search_embeddings([]) == ([], [])
    idx.delete(["a", "b", "c", "d"])
    vals, ids = idx.search_embeddings(queries, k=3)
    assert ids == [[], []] and all(v.size == 0 for v in vals)


def test_search_before_build_raises():
    idx = DenseIndex(8, device="cpu")
    idx.add(np.ones((3, 8), np.float32))
    with pytest.raises(RuntimeError, match="build"):
        idx.search_embeddings(np.ones((1, 8), np.float32))


def test_fewer_docs_than_k_and_from_device_embeddings():
    corpus, queries = _data(n=300, d=8, q=3, seed=3)
    port = DenseIndex.from_device_embeddings(torch.from_numpy(corpus))
    ref = JaxIndex.from_device_embeddings(jnp.asarray(corpus))
    assert len(port) == 300 and port._corpus.shape == ref._corpus.shape
    _same(port, ref, queries, 4)
    port, ref = _pair(8, kernel="pallas")
    for idx in (port, ref):
        idx.add(corpus[:3], ids=["x", "y", "z"])
        idx.build()
    ids = _same(port, ref, queries, 10)
    assert all(sorted(r) == ["x", "y", "z"] for r in ids)


def test_refusals():
    with pytest.raises(ValueError, match="pallas"):
        DenseIndex(32, kernel="pallas", quantize="int8", device="cpu")
    idx = DenseIndex(16, kernel="pallas", device="cpu")
    idx.add(np.ones((4, 16), np.float32), ids=list("abcd"))
    with pytest.raises(ValueError, match="blockmax"):
        idx.delete(["a"])
    mesh = make_mesh(dp=2, tp=1, devices=["cpu", "cpu"])
    assert DenseIndex(16, mesh=mesh).device == torch.device("cpu")
    with pytest.raises(ValueError, match="single-device"):
        DenseIndex(16, kernel="pallas", mesh=mesh)
    with pytest.raises(ValueError, match="first device"):
        DenseIndex(16, mesh=mesh, device="cuda:1")
    with pytest.raises(ValueError, match="quantize"):
        DenseIndex(16, quantize="int4", device="cpu")
    with pytest.raises(ValueError, match="kernel"):
        DenseIndex(16, kernel="faiss", device="cpu")


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        DenseIndex(16, device="cuda")


@pytest.mark.parametrize("dtype,quantize", [("float32", None), ("bfloat16", None),
                                            ("bfloat16", "int8")])
def test_save_load_across_packages(tmp_path, dtype, quantize):
    """An index saved by either package loads in the other and answers
    the same; built rows, pending rows and tombstones alike."""
    corpus, queries = _data(n=400, d=16, q=5, seed=31)
    port, ref = _pair(16, dtype, quantize=quantize)
    for idx in (port, ref):
        idx.add(corpus[:300], ids=[f"d{i}" for i in range(300)])
        idx.build()
        idx.add(corpus[300:], ids=[f"d{i}" for i in range(300, 400)])
        idx.delete(["d5", "d350"])
    want = _same(port, ref, queries, 9)
    port.save(str(tmp_path / "port.npz"))
    ref.save(str(tmp_path / "jax.npz"))
    a, b = (np.load(tmp_path / f"{n}.npz") for n in ("port", "jax"))
    assert bytes(a["meta"]) == bytes(b["meta"])
    np.testing.assert_array_equal(a["rows"], b["rows"])
    np.testing.assert_array_equal(a["ids"], b["ids"])
    jax_from_port = JaxIndex.load(str(tmp_path / "port.npz"))
    port_from_jax = DenseIndex.load(str(tmp_path / "jax.npz"), device="cpu")
    assert port_from_jax.dtype == DTYPES[dtype][0] and len(port_from_jax) == 398
    assert _same(port_from_jax, jax_from_port, queries, 9) == want


def test_unbuilt_save_load(tmp_path):
    corpus, _ = _data(n=10, d=8, q=1, seed=4)
    idx = DenseIndex(8, device="cpu")
    idx.add(corpus)
    idx.save(str(tmp_path / "u.npz"))
    back = JaxIndex.load(str(tmp_path / "u.npz"))
    assert not back.is_built and back._count == 10
    back = DenseIndex.load(str(tmp_path / "u.npz"), device="cpu")
    assert not back.is_built and back._count == 10 and back.dtype == torch.bfloat16


def test_index_corpus_matches_jax():
    from sgpt_tpu.encoder import EmbeddingEngine as JaxEngine
    from sgpt_tpu.index import index_corpus as jax_index_corpus
    from sgpt_tpu.models import init_params as jax_init_params
    from sgpt_tpu.models import tiny as jax_tiny
    from sgpt_tpu.tokenization import SimpleTokenizer
    from sgpt_tpu_torch.encoder import EmbeddingEngine
    from sgpt_tpu_torch.index import index_corpus
    from sgpt_tpu_torch.models import Decoder, from_jax_config, params_from_jax

    jcfg = jax_tiny("neo", num_layers=2)
    jparams = jax_init_params(jcfg, jax.random.key(0))
    cfg = from_jax_config(jcfg)
    model = Decoder(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams), cfg))
    tok = SimpleTokenizer(cfg.vocab_size)
    kw = dict(batch_size=4, specb=True, max_seq_len=64)
    engine = EmbeddingEngine(model, cfg, tok, device="cpu", **kw)
    jengine = JaxEngine(jparams, jcfg, tok, **kw)
    corpus = {f"d{i}": {"title": "t" if i % 3 else "", "text": f"unique document {i} "
                        + "words " * (i % 7)} for i in range(12)}
    for kernel in ("blockmax", "pallas"):
        port = index_corpus(engine, corpus, batch_docs=5, kernel=kernel, dtype=torch.float32)
        ref = jax_index_corpus(jengine, corpus, batch_docs=5, kernel=kernel,
                               dtype=jnp.float32)
        assert port._ids == ref._ids and port.device == engine.device
        q = engine.encode(["unique document 3 words words words"], is_query=True)
        ids = _same(port, ref, q, 3)
        assert ids[0][0] == "d3"
