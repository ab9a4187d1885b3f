"""Port's EmbeddingEngine == `sgpt_tpu.encoder.EmbeddingEngine` on tiny GPT-Neo.

Same weights (JAX `init_params` → `params_from_jax`), same texts across
several length buckets, specb on and off: the same fp32 embeddings in input
order, within 1e-5. Plus the cache (hit and miss), the host-side vocab check
and the arguments that are not ported yet.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the JAX reference runs on the CPU (as tests/conftest.py sets), also under
# --noconftest on a machine whose JAX would otherwise take the GPU
os.environ.setdefault("JAX_PLATFORMS", "cpu")
pytest.importorskip("jax").config.update("jax_platforms", "cpu")

import jax  # noqa: E402

from sgpt_tpu.encoder import EmbeddingEngine as JaxEngine  # noqa: E402
from sgpt_tpu.models import init_params as jax_init_params  # noqa: E402
from sgpt_tpu.models import tiny as jax_tiny  # noqa: E402
from sgpt_tpu.tokenization import SimpleTokenizer  # noqa: E402
from sgpt_tpu_torch.encoder import EmbeddingEngine  # noqa: E402
from sgpt_tpu_torch.models import Decoder, from_jax_config, params_from_jax, tiny  # noqa: E402


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


@pytest.mark.parametrize("kw", [dict(sp_mesh=object()), dict(mesh=object()),
                                dict(quantize="int8"), dict(dispatch_chain=8),
                                dict(fused_attention=True), dict(mesh=object(), quantize="int8")])
def test_unported_options_raise(pair, kw):
    _, _, cfg, model = pair
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        EmbeddingEngine(model, cfg, SimpleTokenizer(cfg.vocab_size), device="cpu", **kw)


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
