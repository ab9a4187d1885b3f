"""The port's long-context path (`use_flash`) == the JAX package's, on the CPU.

A tiny GPT-Neo (2 layers: one global, one local with window 64; fp32; 2048
positions) with the JAX `init_params` converted by `params_from_jax`. The
JAX side runs its flash kernel in interpret mode. Decoder hidden states are
compared at valid positions (tolerance 1e-4, as tests/test_torch_decoder.py),
engine embeddings everywhere (1e-5, normalised). Also: which attention each
shape takes, a trainer step whose gradients flow through the flash backward
(K4's plain version) in every layer, warmup up to 2048, and the cache key's
`use_flash`.
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
import jax.numpy as jnp  # noqa: E402

from sgpt_tpu.encoder import EmbeddingEngine as JaxEngine  # noqa: E402
from sgpt_tpu.models import init_params as jax_init_params  # noqa: E402
from sgpt_tpu.models import tiny as jax_tiny  # noqa: E402
from sgpt_tpu.models.decoder import forward as jax_forward  # noqa: E402
from sgpt_tpu_torch.encoder import EmbeddingEngine  # noqa: E402
from sgpt_tpu_torch.models import Decoder, from_jax_config, params_from_jax  # noqa: E402
from sgpt_tpu_torch.models import decoder as decoder_mod  # noqa: E402
from sgpt_tpu_torch.tokenization import SimpleTokenizer  # noqa: E402


@pytest.fixture(scope="module")
def pair():
    jcfg = jax_tiny("neo", num_layers=2, hidden_size=32, num_heads=2,
                    max_position_embeddings=2048, use_flash=True).replace(local_window=64)
    jparams = jax_init_params(jcfg, jax.random.key(2))
    cfg = from_jax_config(jcfg)
    assert cfg.use_flash and cfg.local_flags() == (False, True)
    model = Decoder(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams), cfg))
    return jcfg, jparams, cfg, model


def _texts(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [" ".join(f"w{rng.integers(0, 5000)}" for _ in range(n)) for n in lengths]


@pytest.mark.parametrize("T", [128, 256, 384])
def test_flash_hidden_states_match_jax(pair, T):
    jcfg, jparams, cfg, model = pair
    rng = np.random.default_rng(T)
    ids = rng.integers(0, cfg.vocab_size, (3, T)).astype(np.int32)
    mask = (np.arange(T)[None] < np.array([[T], [T - 37], [20]])).astype(np.int32)
    want = np.asarray(jax_forward(jparams, jnp.asarray(ids), jnp.asarray(mask), jcfg,
                                  output_hidden_states=True))
    got = model(torch.from_numpy(ids), torch.from_numpy(mask),
                output_hidden_states=True).detach().numpy()
    assert got.shape == want.shape == (cfg.num_layers + 1, 3, T, cfg.hidden_size)
    valid = mask[None, :, :, None].astype(bool)
    np.testing.assert_allclose(np.where(valid, got, 0), np.where(valid, want, 0), atol=1e-4)


def _spy(monkeypatch):
    """Record (attention, T, window, block_kv) for each attention call."""
    calls = []
    flash, short = decoder_mod.flash_attention, decoder_mod.short_attention

    def spy_flash(q, k, v, key_mask, slopes, **kw):
        calls.append(("flash", q.shape[2], kw["window"], kw["block_kv"]))
        return flash(q, k, v, key_mask, slopes, **kw)

    def spy_short(q2, k2, v2, key_mask, slopes, scale, window, H, use_alibi, **kw):
        calls.append(("short", q2.shape[1], window, None))
        return short(q2, k2, v2, key_mask, slopes, scale, window, H, use_alibi, **kw)

    monkeypatch.setattr(decoder_mod, "flash_attention", spy_flash)
    monkeypatch.setattr(decoder_mod, "short_attention", spy_short)
    return calls


@pytest.mark.parametrize("T,packed,use_flash,want", [
    (300, False, True, [("short", 300, 0, None), ("short", 300, 64, None)]),
    (256, False, True, [("flash", 256, 0, 256), ("flash", 256, 64, 256)]),
    (384, False, True, [("flash", 384, 0, 128), ("flash", 384, 64, 128)]),
    (256, True, True, [("short", 256, 0, None), ("short", 256, 64, None)]),
    (256, False, False, [("short", 256, 0, None), ("short", 256, 64, None)]),
])
def test_attention_routing(pair, monkeypatch, T, packed, use_flash, want):
    """As the JAX decoder: use_flash, T % 128 == 0 and no packed rows take
    flash (block_kv 256 where T % 256 == 0, else 128; window 64 on the local
    layer); every other shape takes the short-attention path."""
    _, _, cfg, model = pair
    if not use_flash:
        model = Decoder(cfg.replace(use_flash=False), device="cpu")
    calls = _spy(monkeypatch)
    ids = torch.zeros((2, T), dtype=torch.int64)
    kw = {}
    if packed:
        kw = dict(segment_ids=(torch.arange(T) >= T // 2).int().expand(2, T),
                  position_ids=(torch.arange(T) % (T // 2)).expand(2, T))
    model(ids, torch.ones_like(ids), **kw)
    assert calls == want


@pytest.mark.parametrize("max_seq_len,lengths", [
    (512, (3, 30, 100, 200, 400, 700)),
    (2048, (5, 300, 700, 1500, 2100)),
])
def test_flash_engine_matches_jax_engine(pair, max_seq_len, lengths):
    """Mirrors tests/test_long_context_e2e.py::test_flash_engine_encodes_2k_doc:
    documents and queries in buckets 16 to 2048 (one truncated at 2048)."""
    jcfg, jparams, cfg, model = pair
    tok = SimpleTokenizer(cfg.vocab_size)
    texts = _texts(lengths, seed=max_seq_len)
    kw = dict(specb=True, max_seq_len=max_seq_len, batch_size=1, normalize_embeddings=True)
    jengine = JaxEngine(jparams, jcfg, tok, **kw)
    engine = EmbeddingEngine(model, cfg, tok, device="cpu", **kw)
    for is_query in (False, True):
        want = jengine.encode(texts, is_query=is_query)
        got = engine.encode(texts, is_query=is_query)
        assert got.shape == (len(texts), cfg.hidden_size)
        np.testing.assert_allclose(got, want, atol=1e-5)


def test_warmup_covers_every_bucket_to_2048(pair, monkeypatch):
    _, _, cfg, model = pair
    calls = _spy(monkeypatch)
    engine = EmbeddingEngine(model, cfg, SimpleTokenizer(cfg.vocab_size), device="cpu",
                             max_seq_len=2048, batch_size=1)
    engine.warmup()
    flash = sorted({T for kind, T, _, _ in calls if kind == "flash"})
    short = sorted({T for kind, T, _, _ in calls if kind == "short"})
    assert flash == [128, 256, 512, 1024, 2048] and short == [16, 32, 64, 300]


def test_cache_key_separates_flash_from_plain(pair, tmp_path):
    _, _, cfg, model = pair
    tok = SimpleTokenizer(cfg.vocab_size)
    plain_model = Decoder(cfg.replace(use_flash=False), device="cpu")
    plain_model.load_state_dict(model.state_dict())
    kw = dict(device="cpu", max_seq_len=512, batch_size=1, cache_dir=str(tmp_path))
    flash = EmbeddingEngine(model, cfg, tok, **kw)
    plain = EmbeddingEngine(plain_model, plain_model.cfg, tok, **kw)
    texts = _texts((10, 200))
    assert flash._params_fingerprint() == plain._params_fingerprint()
    assert flash._cache_key(texts, False) != plain._cache_key(texts, False)
    plain.encode(texts)
    assert flash._cache_load(texts, False) is None


def test_trainer_with_use_flash_raises_naming_k4(pair, monkeypatch):
    """Named for the refusal it replaced (the flash backward, K4, is ported
    now): the trainer takes a `use_flash` model at max_seq_len 256, every
    layer of every tower runs flash with a gradient, and one BitFit step's
    gradients reach every bias leaf, the LayerNorm biases in front of each
    attention included (their only path is the flash backward)."""
    from sgpt_tpu_torch.training import ContrastiveTrainer, TrainConfig

    _, _, cfg, model = pair
    model = Decoder(cfg, device="cpu")
    model.load_state_dict(pair[3].state_dict())
    calls = _spy(monkeypatch)
    trainer = ContrastiveTrainer(model, cfg, SimpleTokenizer(cfg.vocab_size),
                                 TrainConfig(batch_size=2, max_seq_len=256, specb=True,
                                             freeze_nonbias=True))
    trainer._opt, trainer._sched = trainer._build_optimizer(1)
    batch = list(zip(_texts((4, 6)), _texts((150, 300), 1), _texts((80, 20), 2)))
    loss = float(trainer._loss_and_grads(trainer._prep_batch(batch)))
    assert np.isfinite(loss)
    assert calls == [("flash", 256, 0, 256), ("flash", 256, 64, 256)] * 3
    trained = {n: p for n, p in model.named_parameters() if p.requires_grad}
    assert trained and all(n.rsplit(".", 1)[-1] in ("bias", "bi", "bo") for n in trained)
    for i in range(cfg.num_layers):
        assert f"layers.{i}.ln1.bias" in trained
    for name, p in trained.items():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
        assert p.grad.abs().max() > 0, name
