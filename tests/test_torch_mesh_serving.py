"""The port's serving paths on a mesh == the JAX package's on its mesh, on the CPU.

The JAX side runs on the forced 8-device XLA CPU mesh (tests/conftest.py),
its parameters placed by `sgpt_tpu.parallel.shard_params`; the port's
meshes are `["cpu"] * n` device lists of the same (dp, tp) shape, its model
a `Decoder` of the same numpy weights (`params_from_jax`), fp32 at
matmul_precision "highest".

  * `EmbeddingEngine(mesh=)` at (dp, tp) = (4, 1), (1, 2) and (2, 2), and
    BLOOM at (2, 2): embeddings within 1e-5 of the JAX engine's on the same
    mesh shape; int8 at (2, 2) within 2e-2 (tests/test_torch_quant.py's
    rule); `SGPTModel.engine(mesh=)` reaches the engine;
  * `CrossEncoderRanker(mesh=)`, unpacked, `pack_t` and Yes/No, on dp=2 and
    tp=2: scores within rtol 2e-5, atol 1e-4 (tests/test_torch_crossencoder.py);
  * `DenseIndex(mesh=)` on dp=4 against JAX's sharded index: the same ids
    and scores within 1e-5, multi-slab (slab < row block), bf16 and int8,
    adds after build, deletes with tombstones, `index_corpus(mesh=)`,
    `from_device_embeddings(mesh=)`, and files saved on a mesh loading
    without one and the reverse;
  * `IVFIndex(mesh=)` on dp 2 and 4 against JAX's sharded IVF: the same ids
    at nprobe 1 (where the sharded probe differs from the meshless one) and
    K, scores within 1e-5, deletes, and a save on one mesh loaded onto
    another;
  * `SearchService.load_index(mesh=)` serves what the JAX service serves.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
os.environ.setdefault("JAX_PLATFORMS", "cpu")
pytest.importorskip("jax").config.update("jax_platforms", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import sgpt_tpu.crossencoder as jce  # noqa: E402
import sgpt_tpu_torch.crossencoder as pce  # noqa: E402
from sgpt_tpu.encoder import EmbeddingEngine as JaxEngine  # noqa: E402
from sgpt_tpu.index import DenseIndex as JaxIndex  # noqa: E402
from sgpt_tpu.index import index_corpus as jax_index_corpus  # noqa: E402
from sgpt_tpu.index_ivf import IVFIndex as JaxIVF  # noqa: E402
from sgpt_tpu.models import init_params as jax_init_params  # noqa: E402
from sgpt_tpu.models import tiny as jax_tiny  # noqa: E402
from sgpt_tpu.parallel import make_mesh as jax_make_mesh  # noqa: E402
from sgpt_tpu.parallel import shard_params as jax_shard_params  # noqa: E402
from sgpt_tpu.serving import SearchService as JaxService  # noqa: E402
from sgpt_tpu.tokenization import SimpleTokenizer  # noqa: E402
from sgpt_tpu_torch.encoder import EmbeddingEngine  # noqa: E402
from sgpt_tpu_torch.index import DenseIndex, index_corpus  # noqa: E402
from sgpt_tpu_torch.index_ivf import IVFIndex  # noqa: E402
from sgpt_tpu_torch.model import SGPTModel  # noqa: E402
from sgpt_tpu_torch.models import Decoder, from_jax_config, params_from_jax  # noqa: E402
from sgpt_tpu_torch.parallel import RowShards, ShardedDecoder, make_mesh  # noqa: E402
from sgpt_tpu_torch.serving import SearchService  # noqa: E402

VOCAB = 128
RTOL, ATOL = 2e-5, 1e-4   # summed log-probs (tests/test_torch_crossencoder.py)
TOK = SimpleTokenizer(vocab_size=VOCAB)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: beside the other test processes on the host's
    cores, a pool of threads makes many small operations wait."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(family="neo"):
    jcfg = jax_tiny(family, num_layers=2, vocab_size=VOCAB)
    jparams = jax_init_params(jcfg, jax.random.key(0))
    cfg = from_jax_config(jcfg)
    model = Decoder(cfg, device="cpu",
                    weights=params_from_jax(jax.tree.map(np.asarray, jparams), cfg))
    return jcfg, jparams, cfg, model


@pytest.fixture(scope="module")
def neo():
    return _pair("neo")


def _meshes(dp, tp):
    return jax_make_mesh(dp=dp, tp=tp, devices=jax.devices()[:dp * tp]), \
        make_mesh(dp=dp, tp=tp, devices=["cpu"] * (dp * tp))


def _texts(n=23, seed=1):
    rng = np.random.default_rng(seed)
    return [" ".join(f"w{rng.integers(0, 500)}" for _ in range(m))
            for m in rng.integers(1, 80, n)]   # buckets 16, 32, 64 and truncation at 64


# -- the engine ------------------------------------------------------------------

@pytest.mark.parametrize("family,dp,tp", [("neo", 4, 1), ("neo", 1, 2), ("neo", 2, 2),
                                          ("bloom", 2, 2)])
def test_engine_matches_jax_engine_on_the_mesh(family, dp, tp):
    jcfg, jparams, cfg, model = _pair(family)
    jm, mesh = _meshes(dp, tp)
    kw = dict(specb=True, batch_size=3, max_seq_len=64, normalize_embeddings=True)
    texts = _texts()
    want = JaxEngine(jax_shard_params(jparams, jm), jcfg, TOK, mesh=jm, **kw).encode(texts)
    engine = EmbeddingEngine(model, cfg, TOK, mesh=mesh, **kw)
    assert isinstance(engine.model, ShardedDecoder) and engine.batch_size % dp == 0
    assert engine.device == torch.device("cpu")
    got = engine.encode(texts)
    assert got.shape == (len(texts), cfg.hidden_size) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(engine.encode_queries(texts[:7]),
                               JaxEngine(jax_shard_params(jparams, jm), jcfg, TOK, mesh=jm,
                                         **kw).encode_queries(texts[:7]), atol=1e-5)
    engine.warmup([16])


def test_engine_int8_and_sgpt_model_on_the_mesh(neo):
    """quantize="int8" on a (2, 2) mesh (the engine quantizes a copy, then
    shards it) against the JAX engine's int8 on its sharded tree; and
    `SGPTModel.engine(mesh=)` gives the mesh engine's embeddings."""
    jcfg, jparams, cfg, model = neo
    jm, mesh = _meshes(2, 2)
    texts = _texts(seed=3)
    kw = dict(batch_size=4, max_seq_len=64, normalize_embeddings=True)
    want = JaxEngine(jax_shard_params(jparams, jm), jcfg, TOK, mesh=jm, quantize="int8",
                     **kw).encode(texts)
    got = EmbeddingEngine(model, cfg, TOK, mesh=mesh, quantize="int8", **kw).encode(texts)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-2)
    sgpt = SGPTModel(model, cfg, TOK, normalize=True, max_seq_len=64, batch_size=4,
                     device="cpu")
    np.testing.assert_array_equal(sgpt.engine(mesh=mesh).encode(texts),
                                  EmbeddingEngine(model, cfg, TOK, mesh=mesh, **kw).encode(texts))
    with pytest.raises(ValueError, match="not both"):
        EmbeddingEngine(model, cfg, TOK, mesh=mesh, sp_mesh=mesh)
    sharded = EmbeddingEngine(model, cfg, TOK, mesh=mesh).model
    with pytest.raises(ValueError, match="quantize an unsharded model"):
        EmbeddingEngine(sharded, cfg, TOK, mesh=mesh, quantize="int8")


# -- the cross-encoder -----------------------------------------------------------

def _ragged_pairs(n=24, seed=7):
    rng = np.random.default_rng(seed)
    pairs = []
    for i in range(n):
        qlen = int(rng.integers(1, 5))
        dlen = int(rng.integers(2, 30)) if i % 3 else int(rng.integers(40, 70))
        pairs.append((" ".join(f"q{i} t{j}" for j in range(qlen)),
                      " ".join(f"d{i} w{j}" for j in range(dlen))))
    pairs[5] = pairs[2]
    return pairs


@pytest.mark.parametrize("dp,tp", [(2, 1), (1, 2)])
@pytest.mark.parametrize("kind", ["unpacked", "pack_t", "yesno"])
def test_ranker_matches_jax_ranker_on_the_mesh(neo, kind, dp, tp):
    jcfg, jparams, cfg, model = neo
    jm, mesh = _meshes(dp, tp)
    kw = dict(batch_size=4, max_length=128)
    if kind == "pack_t":
        kw["pack_t"] = 64
    jcls, pcls = ((jce.YesNoRanker, pce.YesNoRanker) if kind == "yesno"
                  else (jce.CrossEncoderRanker, pce.CrossEncoderRanker))
    pairs = _ragged_pairs()
    want = jcls(jax_shard_params(jparams, jm), jcfg, TOK, mesh=jm, **kw).predict(pairs)
    ranker = pcls(model, cfg, TOK, mesh=mesh, **kw)
    got = ranker.predict(pairs)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=ATOL)
    # a ranker on the engine's sharded model shares its shards
    shared = pcls(ranker.model, cfg, TOK, mesh=mesh, **kw)
    assert shared.model is ranker.model
    np.testing.assert_array_equal(shared.predict(pairs), got)


# -- the exact index -------------------------------------------------------------

DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _data(n=1000, d=32, q=7, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, d)).astype(np.float32),
            rng.normal(size=(q, d)).astype(np.float32))


def _same(port, ref, queries, k):
    got_v, got_i = port.search_embeddings(queries, k=k)
    want_v, want_i = ref.search_embeddings(queries, k=k)
    assert got_i == want_i
    for g, w in zip(got_v, want_v):
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, np.asarray(w, np.float32), atol=1e-5)
    return got_i


def _dense_pair(dp, dtype="float32", **kw):
    jm, mesh = _meshes(dp, 1)
    t, j = DTYPES[dtype]
    return DenseIndex(32, dtype=t, mesh=mesh, **kw), JaxIndex(32, dtype=j, mesh=jm, **kw)


@pytest.mark.parametrize("quantize", [None, "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_index_dp4_matches_jax(dtype, quantize):
    """Multi-slab: row blocks of 256 rows scanned in slabs of 128."""
    emb, queries = _data()
    port, ref = _dense_pair(4, dtype, slab_size=128, quantize=quantize)
    for idx in (port, ref):
        idx.add(emb, ids=[f"d{i}" for i in range(len(emb))])
        idx.build()
    assert isinstance(port._corpus, RowShards) and len(port._corpus.pieces) == 4
    assert port._corpus.shape[0] == ref._corpus.shape[0] and port._slab_eff == ref._slab_eff
    for k in (1, 10, 300):
        _same(port, ref, queries, k)


def test_dense_index_dp4_adds_deletes_and_rebuilds_match_jax():
    emb, queries = _data(700)
    port, ref = _dense_pair(4)
    for idx in (port, ref):
        idx.add(emb[:500], ids=[f"d{i}" for i in range(500)])
        idx.build()
        idx.add(emb[500:], ids=[f"d{i}" for i in range(500, 700)])   # pending slab
    top = _same(port, ref, queries, 10)
    dead = [top[0][0], top[1][0], "d650", "d3"]
    for idx in (port, ref):
        assert idx.delete(dead) == 4
    assert not any(set(dead) & set(r) for r in _same(port, ref, queries, 10))
    assert isinstance(port._row_mask, RowShards)
    for idx in (port, ref):
        idx.build()
    assert len(port) == len(ref) == 696
    _same(port, ref, queries, 20)


def test_dense_index_saves_load_across_meshes_and_packages(tmp_path):
    """A file saved on a dp=4 mesh loads without a mesh, and one saved
    without loads onto dp=2, in both packages, with JAX's results."""
    emb, queries = _data(600)
    port, ref = _dense_pair(4, quantize="int8")
    for idx in (port, ref):
        idx.add(emb, ids=[f"d{i}" for i in range(600)])
        idx.build()
        idx.delete(["d5", "d7"])
    port.save(str(tmp_path / "p.npz"))
    ref.save(str(tmp_path / "j.npz"))
    flat = DenseIndex.load(str(tmp_path / "p.npz"), device="cpu")
    assert flat.mesh is None and len(flat) == 598
    _same(flat, JaxIndex.load(str(tmp_path / "j.npz")), queries, 10)
    flat.save(str(tmp_path / "flat.npz"))
    jm, mesh = _meshes(2, 1)
    again = DenseIndex.load(str(tmp_path / "flat.npz"), mesh=mesh)
    assert len(again._corpus.pieces) == 2
    _same(again, JaxIndex.load(str(tmp_path / "j.npz"), mesh=jm), queries, 10)


def test_index_corpus_and_device_embeddings_on_the_mesh(neo):
    jcfg, jparams, cfg, model = neo
    jm, mesh = _meshes(2, 1)
    kw = dict(batch_size=4, max_seq_len=64)
    corpus = {f"d{i}": {"title": "", "text": t} for i, t in enumerate(_texts(40, seed=5))}
    port = index_corpus(EmbeddingEngine(model, cfg, TOK, mesh=mesh, **kw), corpus, mesh=mesh,
                        dtype=torch.float32, batch_docs=16)
    ref = jax_index_corpus(JaxEngine(jparams, jcfg, TOK, mesh=jm, **kw), corpus, mesh=jm,
                           dtype=jnp.float32, batch_docs=16)
    queries = EmbeddingEngine(model, cfg, TOK, device="cpu", **kw).encode(_texts(5, seed=9))
    _same(port, ref, queries, 8)
    emb, q = _data(300)
    dev = DenseIndex.from_device_embeddings(torch.from_numpy(emb), mesh=mesh,
                                            normalize_embeddings=True)
    jdev = JaxIndex.from_device_embeddings(jnp.asarray(emb), mesh=jm, normalize_embeddings=True)
    _same(dev, jdev, q, 10)
    with pytest.raises(ValueError, match="single-device"):
        DenseIndex(32, kernel="pallas", mesh=mesh)


# -- the IVF index -----------------------------------------------------------------

def _mixture(n, d=32, seed=0, centers=16, spread=0.25):
    rng = np.random.default_rng(seed)
    mu = rng.standard_normal((centers, d))
    mu /= np.linalg.norm(mu, axis=1, keepdims=True)
    x = mu[rng.integers(0, centers, n)] + spread * rng.standard_normal((n, d))
    return x.astype(np.float32), rng


IVF_EMB, _RNG = _mixture(2000)
IVF_QUERIES = (IVF_EMB[_RNG.integers(0, 2000, 16)] + 0.05 * _RNG.standard_normal((16, 32))
               ).astype(np.float32)


def _ivf_pair(dp, quantize=None, **kw):
    jm, mesh = _meshes(dp, 1)
    ref = JaxIVF(32, quantize=quantize, mesh=jm, **kw)
    port = IVFIndex(32, quantize=quantize, mesh=mesh, **kw)
    for idx in (ref, port):
        idx.add(IVF_EMB, ids=[f"d{i}" for i in range(len(IVF_EMB))])
        idx.build()
    return ref, port


def _same_ivf(ref, port, nprobes, k=10):
    for nprobe in nprobes:
        want_v, want_i = ref.search_embeddings(IVF_QUERIES, k=k, nprobe=nprobe)
        got_v, got_i = port.search_embeddings(IVF_QUERIES, k=k, nprobe=nprobe)
        assert got_i == want_i, nprobe
        for g, w in zip(got_v, want_v):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)


@pytest.mark.parametrize("quantize", [None, "int8"])
@pytest.mark.parametrize("dp", [2, 4])
def test_ivf_sharded_probe_matches_jax(dp, quantize):
    """n_clusters 9 (K pads to a multiple of dp) with overflow (pad_factor
    1.0): the same ids at nprobe 1 and K, scores within 1e-5."""
    ref, port = _ivf_pair(dp, quantize, n_clusters=9, pad_factor=1.0)
    assert port._overflow_count == ref._overflow_count > 0
    assert len(port._blocks.pieces) == dp and port._centroids.shape[0] % dp == 0
    _same_ivf(ref, port, (1, 3, 9))


def test_ivf_sharded_deletes_adds_and_persistence_match_jax(tmp_path):
    ref, port = _ivf_pair(2, "int8", n_clusters=8, pad_factor=1.0)
    top = port.search_embeddings(IVF_QUERIES[:2], k=3, nprobe=8)[1]
    overflow = f"d{port._overflow_ids[0]}"
    for idx in (ref, port):
        idx.add(IVF_EMB[:50] * 1.01, ids=[f"e{i}" for i in range(50)])
        idx.delete([top[0][0], top[1][1], overflow, "e3"])
    _same_ivf(ref, port, (2, 8))
    port.save(str(tmp_path / "p.npz"))
    jm, mesh = _meshes(4, 1)
    again = IVFIndex.load(str(tmp_path / "p.npz"), mesh=mesh)
    assert len(again._blocks.pieces) == 4
    jagain = JaxIVF.load(str(tmp_path / "p.npz"), mesh=jm)
    _same_ivf(jagain, again, (2, 8))
    flat = IVFIndex.load(str(tmp_path / "p.npz"), device="cpu")
    assert flat.mesh is None
    _same_ivf(JaxIVF.load(str(tmp_path / "p.npz")), flat, (8,))
    for idx in (jagain, again):
        idx.build()
    _same_ivf(jagain, again, (8,))


# -- serving ---------------------------------------------------------------------

DOCS = {f"d{i}": t for i, t in enumerate(_texts(30, seed=11))}


@pytest.mark.parametrize("kind", ["dense", "ivf"])
def test_load_index_onto_a_mesh_serves_what_jax_serves(tmp_path, neo, kind):
    jcfg, jparams, cfg, model = neo
    kw = dict(batch_size=4, max_seq_len=64, normalize_embeddings=True)
    jengine = JaxEngine(jparams, jcfg, TOK, **kw)
    index = JaxIVF(jengine.out_dim, n_clusters=3, nprobe=1) if kind == "ivf" else None
    ref = JaxService(jengine, index)
    try:
        ref.add_documents(list(DOCS.values()), ids=list(DOCS), build=True)
        ref.save(str(tmp_path / "s"))
    finally:
        ref.close()
    jm, mesh = _meshes(2, 1)
    jindex, jdocs = JaxService.load_index(str(tmp_path / "s"), mesh=jm)
    index, documents = SearchService.load_index(str(tmp_path / "s"), mesh=mesh)
    assert documents == jdocs == DOCS and index.mesh is mesh
    queries = list(DOCS.values())[:4]
    want_svc = JaxService(jengine, jindex, documents=jdocs)
    svc = SearchService(EmbeddingEngine(model, cfg, TOK, mesh=mesh, **kw), index,
                        documents=documents)
    try:
        want = want_svc.search(queries, k=3, return_documents=True)
        got = svc.search(queries, k=3, return_documents=True)
    finally:
        svc.close()
        want_svc.close()
    assert [[h["id"] for h in r] for r in got] == [[h["id"] for h in r] for r in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose([h["score"] for h in g], [h["score"] for h in w], atol=1e-5)
