"""Port's EmbeddingEngine == `sgpt_tpu.encoder.EmbeddingEngine` on tiny GPT-Neo.

Same weights (JAX `init_params` → `params_from_jax`), same texts across
several length buckets, specb on and off: the same fp32 embeddings in input
order, within 1e-5. Plus the cache (hit and miss), the host-side vocab check,
dispatch chains and forced fused attention on one device, a mesh and an
sp_mesh, and every default of the JAX engine's signature.
"""
import inspect
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the JAX reference runs on the CPU (as tests/conftest.py sets), also under
# --noconftest on a machine whose JAX would otherwise take the GPU
os.environ.setdefault("JAX_PLATFORMS", "cpu")
pytest.importorskip("jax").config.update("jax_platforms", "cpu")

import jax  # noqa: E402
from jax.sharding import Mesh as JaxMesh  # noqa: E402

from sgpt_tpu.encoder import EmbeddingEngine as JaxEngine  # noqa: E402
from sgpt_tpu.models import init_params as jax_init_params  # noqa: E402
from sgpt_tpu.models import tiny as jax_tiny  # noqa: E402
from sgpt_tpu.parallel import make_mesh as jax_make_mesh  # noqa: E402
from sgpt_tpu.parallel import shard_params as jax_shard_params  # noqa: E402
from sgpt_tpu.tokenization import SimpleTokenizer  # noqa: E402
from sgpt_tpu_torch.encoder import EmbeddingEngine  # noqa: E402
from sgpt_tpu_torch.models import Decoder, from_jax_config, params_from_jax, tiny  # noqa: E402
from sgpt_tpu_torch.parallel import make_mesh  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: beside the other test processes on the host's
    cores, a pool of threads makes many small operations wait."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    jcfg = jax_tiny("neo", num_layers=2)
    jparams = jax_init_params(jcfg, jax.random.key(0))
    cfg = from_jax_config(jcfg)
    model = Decoder(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams), cfg))
    return jcfg, jparams, cfg, model


def _texts(n=23, seed=1):
    rng = np.random.default_rng(seed)
    return [" ".join(f"w{rng.integers(0, 500)}" for _ in range(m))
            for m in rng.integers(1, 80, n)]  # buckets 16, 32, 64 and truncation at 64


@pytest.mark.parametrize("specb", [False, True])
@pytest.mark.parametrize("method", ["weightedmean", "mean", "lasttoken"])
def test_embeddings_match_jax_engine(pair, specb, method):
    jcfg, jparams, cfg, model = pair
    tok = SimpleTokenizer(cfg.vocab_size)
    texts = _texts()
    kw = dict(method=method, specb=specb, batch_size=2, max_seq_len=64,
              normalize_embeddings=True)
    want = JaxEngine(jparams, jcfg, tok, **kw).encode(texts)
    engine = EmbeddingEngine(model, cfg, tok, device="cpu", **kw)
    got = engine.encode(texts)
    assert got.shape == (len(texts), cfg.hidden_size) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5)
    if specb:
        np.testing.assert_allclose(engine.encode_queries(texts),
                                   JaxEngine(jparams, jcfg, tok, **kw).encode_queries(texts),
                                   atol=1e-5)


def test_encode_corpus_dicts_and_empty(pair):
    _, _, cfg, model = pair
    engine = EmbeddingEngine(model, cfg, SimpleTokenizer(cfg.vocab_size), device="cpu", batch_size=4)
    corpus = [{"title": "a b", "text": "c d e"}, "f g"]
    np.testing.assert_array_equal(engine.encode_corpus(corpus),
                                  engine.encode(["a b c d e", "f g"]))
    assert engine.encode([]).shape == (0, cfg.hidden_size)


def test_cache_hit_and_miss(pair, tmp_path, monkeypatch):
    _, _, cfg, model = pair
    tok = SimpleTokenizer(cfg.vocab_size)
    engine = EmbeddingEngine(model, cfg, tok, device="cpu", batch_size=4, cache_dir=str(tmp_path))
    texts = _texts(7, seed=2)
    first = engine.encode(texts)
    assert len(list(tmp_path.glob("*.npy"))) == 1

    def no_forward(*a, **k):
        raise AssertionError("cache hit must not run the model")

    monkeypatch.setattr(engine, "_embed", no_forward)
    np.testing.assert_array_equal(engine.encode(texts), first)  # hit
    with pytest.raises(AssertionError, match="cache hit"):
        engine.encode(texts, is_query=True)  # miss: another key
    with pytest.raises(AssertionError, match="cache hit"):
        engine.encode(texts[:-1])
    # other weights → another fingerprint → a miss
    other = Decoder(cfg, device="cpu", generator=torch.Generator().manual_seed(9))
    e2 = EmbeddingEngine(other, cfg, tok, device="cpu", batch_size=4, cache_dir=str(tmp_path))
    assert e2._cache_key(texts, False) != engine._cache_key(texts, False)


def test_out_of_range_ids_raise_on_the_host(pair):
    _, _, cfg, model = pair
    engine = EmbeddingEngine(model, cfg, SimpleTokenizer(10 * cfg.vocab_size), device="cpu")
    with pytest.raises(ValueError, match="vocab"):
        engine.encode(["many different words so that some id lands high"] * 3)


MESH = make_mesh(dp=2, tp=1, devices=["cpu", "cpu"])


def _jax_kw(kw):
    """The same keywords for the JAX engine: MESH becomes a dp=2 mesh of
    two XLA CPU devices (as `mesh=`) or a one-axis mesh of them (as
    `sp_mesh=`)."""
    out = dict(kw)
    if "mesh" in kw:
        out["mesh"] = jax_make_mesh(dp=2, tp=1, devices=jax.devices()[:2])
    if "sp_mesh" in kw:
        out["sp_mesh"] = JaxMesh(np.asarray(jax.devices()[:2]), ("dp",))
    return out


@pytest.mark.parametrize("kw", [dict(sp_mesh=MESH, dispatch_chain=2), dict(dispatch_chain=2),
                                dict(dispatch_chain=8),
                                dict(fused_attention=True), dict(mesh=MESH, dispatch_chain=8)])
def test_unported_options_raise(pair, kw):
    """Dispatch chains and a forced fused kernel, also on a mesh and with
    sequence-parallel encode, run: the embeddings of the port's engine at
    dispatch_chain=1 with the same other keywords, bit for bit, and the
    JAX engine's with the same keywords within 1e-5."""
    jcfg, jparams, cfg, model = pair
    tok = SimpleTokenizer(cfg.vocab_size)
    texts = _texts()
    common = dict(batch_size=2, max_seq_len=64, normalize_embeddings=True,
                  device=None if {"mesh", "sp_mesh"} & set(kw) else "cpu")
    got = EmbeddingEngine(model, cfg, tok, **common, **kw).encode(texts)
    single = EmbeddingEngine(model, cfg, tok, **common,
                             **{**kw, "dispatch_chain": 1}).encode(texts)
    np.testing.assert_array_equal(got, single)
    jkw = _jax_kw(kw)
    jp = jparams if "mesh" not in kw else jax_shard_params(jparams, jkw["mesh"])
    want = JaxEngine(jp, jcfg, tok, batch_size=2, max_seq_len=64, normalize_embeddings=True,
                     **jkw).encode(texts)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_fused_attention_false_raises(pair):
    """JAX's False selects XLA's attention: the port has no such path on
    the card, and says so."""
    _, _, cfg, model = pair
    with pytest.raises(ValueError, match="XLA"):
        EmbeddingEngine(model, cfg, SimpleTokenizer(cfg.vocab_size), device="cpu",
                        fused_attention=False)


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_mesh_options_run(pair, quantize):
    """`mesh=` (dp 2 here; tests/test_torch_mesh_serving.py holds meshes to
    the JAX engine's) with and without int8: the meshless embeddings, bit
    for bit (each dp row runs the same forward on its block of rows)."""
    _, _, cfg, model = pair
    tok = SimpleTokenizer(cfg.vocab_size)
    kw = dict(batch_size=2, max_seq_len=64, quantize=quantize)
    texts = _texts()
    engine = EmbeddingEngine(model, cfg, tok, mesh=MESH, **kw)
    assert engine.mesh is MESH and engine.device == torch.device("cpu")
    np.testing.assert_array_equal(engine.encode(texts),
                                  EmbeddingEngine(model, cfg, tok, device="cpu", **kw).encode(texts))


# every keyword of the JAX engine with its default (dispatch_chain=8 among them)
JAX_DEFAULTS = {k: p.default for k, p in inspect.signature(JaxEngine).parameters.items()
                if p.default is not inspect.Parameter.empty}


def test_jax_engine_defaults_are_accepted(pair):
    """Every default of the JAX engine's signature (no mesh, no sequence
    parallelism, the fused kernel left to the backend, a dispatch chain of
    8, ...) and `encode(show_progress=...)` pass, through the engine and
    `SGPTModel.engine`, with the JAX engine's embeddings."""
    from sgpt_tpu_torch.model import SGPTModel

    jcfg, jparams, cfg, model = pair
    tok = SimpleTokenizer(cfg.vocab_size)
    texts = _texts(9, seed=4)
    assert JAX_DEFAULTS["dispatch_chain"] == 8 and "fused_attention" in JAX_DEFAULTS
    kw = {**JAX_DEFAULTS, **dict(method="mean", batch_size=4, max_seq_len=64)}
    want = JaxEngine(jparams, jcfg, tok, **kw).encode(texts, show_progress=False)
    engine = EmbeddingEngine(model, cfg, tok, device="cpu", **kw)
    assert engine.dispatch_chain == 8
    np.testing.assert_allclose(engine.encode(texts, show_progress=False), want, atol=1e-5)
    np.testing.assert_array_equal(engine.encode(texts, show_progress=True),
                                  engine.encode(texts))
    sgpt = SGPTModel(model, cfg, tok, method="mean", max_seq_len=64, batch_size=4, device="cpu")
    np.testing.assert_allclose(sgpt.engine(**kw).encode(texts), want, atol=1e-5)
    np.testing.assert_allclose(sgpt.encode(texts, show_progress=False), want, atol=1e-5)


def test_unknown_argument_and_config_mismatch(pair):
    _, _, cfg, model = pair
    tok = SimpleTokenizer(cfg.vocab_size)
    with pytest.raises(TypeError):
        EmbeddingEngine(model, cfg, tok, device="cpu", batchsize=4)
    with pytest.raises(ValueError, match="cfg"):
        EmbeddingEngine(model, tiny("neo", num_layers=2, vocab_size=300), tok, device="cpu")


def test_cuda_without_a_card_raises(pair):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    _, _, cfg, model = pair
    with pytest.raises(RuntimeError, match="cuda"):
        EmbeddingEngine(model, cfg, SimpleTokenizer(cfg.vocab_size), device="cuda")
