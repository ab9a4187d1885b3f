"""The port's encoder families (BERT, T5's encoder) == the JAX package's.

`tiny("bert")`, `tiny("t5")` and T5 v1.1's gated-GELU MLP, at 3 layers, with
the JAX `init_params` perturbed (so that every bias, LayerNorm and RMSNorm
scale, token-type row and relative-bias entry is off its init value) and
carried over by `params_from_jax`: hidden states at valid positions within
1e-4 in fp32 and 5e-2 in bf16 (the tolerances of tests/test_torch_decoder.py);
T5's relative-position bucket map equal to JAX's; random-init HF models
through the port's loader within 2e-4 (tests/test_models_parity.py's
tolerance); the engine and two trainer steps against the JAX engine and
trainer (losses within 1e-5 relative plus 1e-5 of the first loss, the rule
of tests/test_torch_training.py); `build_model`'s choice of preset; and the
routing: no bidirectional or relative-bias config reaches K1 or K3.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
os.environ.setdefault("JAX_PLATFORMS", "cpu")
pytest.importorskip("jax").config.update("jax_platforms", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import sgpt_tpu.models as jax_models  # noqa: E402
from sgpt_tpu.cli import common as jax_common  # noqa: E402
from sgpt_tpu.encoder import EmbeddingEngine as JaxEngine  # noqa: E402
from sgpt_tpu.models import init_params as jax_init_params  # noqa: E402
from sgpt_tpu.models import tiny as jax_tiny  # noqa: E402
from sgpt_tpu.models.decoder import forward as jax_forward  # noqa: E402
from sgpt_tpu.models.decoder import t5_relative_bias as jax_t5_relative_bias  # noqa: E402
from sgpt_tpu.tokenization import SimpleTokenizer  # noqa: E402
from sgpt_tpu.training import ContrastiveTrainer as JaxTrainer  # noqa: E402
from sgpt_tpu.training import TrainConfig as JaxTrainConfig  # noqa: E402
import sgpt_tpu_torch.models as port_models  # noqa: E402
from sgpt_tpu_torch.cli import common as port_common  # noqa: E402
from sgpt_tpu_torch.encoder import EmbeddingEngine  # noqa: E402
from sgpt_tpu_torch.models import (Decoder, bert, from_jax_config, params_from_jax,  # noqa: E402
                                   t5, tiny)
from sgpt_tpu_torch.models import decoder as port_decoder  # noqa: E402
from sgpt_tpu_torch.models.decoder import relative_buckets  # noqa: E402
from sgpt_tpu_torch.models.hf_loader import (config_from_hf, convert_hf_state_dict,  # noqa: E402
                                             load_pretrained, save_safetensors)
from sgpt_tpu_torch.training import ContrastiveTrainer, TrainConfig  # noqa: E402

FAMILIES = {"bert": {}, "t5": {}, "t5_gated": dict(mlp_activation="gated_gelu")}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread, as in tests/test_torch_short_attention.py: beside
    other test processes on the host's cores, a pool of threads makes each
    of this file's many small operations wait on descheduled threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _perturbed(tree, seed):
    """Every leaf plus 0.05·N(0, 1): biases and scales leave their init."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a, np.float32)
        + (0.05 * rng.standard_normal(np.shape(a))).astype(np.float32), tree)


def _pair(case, dtype=jnp.float32, num_layers=3, **kw):
    jcfg = jax_tiny(case.split("_")[0], num_layers=num_layers, **kw).replace(
        dtype=dtype, **FAMILIES[case])
    jparams = _perturbed(jax_init_params(jcfg, jax.random.key(0), dtype=jnp.float32), 1)
    cfg = from_jax_config(jcfg)
    model = Decoder(cfg, device="cpu", weights=params_from_jax(jparams, cfg))
    return jcfg, jax.tree.map(jnp.asarray, jparams), cfg, model


def _batch(T, vocab, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (3, T)).astype(np.int32)
    mask = np.ones((3, T), np.int32)
    mask[1, T - 5:] = 0
    mask[2, 4:] = 0
    return ids, mask


def _valid_close(got, want, mask, atol):
    valid = np.broadcast_to(mask[..., None].astype(bool), got.shape[-3:])
    np.testing.assert_allclose(np.where(valid, got, 0), np.where(valid, want, 0), atol=atol)


@pytest.mark.parametrize("case", sorted(FAMILIES))
def test_hidden_states_match_jax_fp32(case):
    jcfg, jparams, cfg, model = _pair(case)
    ids, mask = _batch(20, cfg.vocab_size)
    want = np.asarray(jax_forward(jparams, jnp.asarray(ids), jnp.asarray(mask), jcfg,
                                  output_hidden_states=True))
    with torch.no_grad():
        got = model(torch.from_numpy(ids), torch.from_numpy(mask),
                    output_hidden_states=True).numpy()
        final = model(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    assert got.shape == want.shape == (cfg.num_layers + 1, 3, 20, cfg.hidden_size)
    for layer in range(cfg.num_layers + 1):
        _valid_close(got[layer], want[layer], mask, 1e-4)
    # the last entry is the final states: ln_f's for T5, the last block's
    # own output for BERT's post-LN stack (no ln_f)
    np.testing.assert_array_equal(final, got[-1])
    assert (model.ln_f is None) == (case == "bert")


@pytest.mark.parametrize("case", sorted(FAMILIES))
def test_hidden_states_match_jax_bf16(case):
    """bf16: the port and the JAX package round in different places (the
    JAX LayerNorm's own fp32 formula, XLA's bf16 GELU and its fusions), so
    the two bf16 forwards differ by up to 4 bf16 ulps at |h| ~ 3 (0.0625;
    each is 0.03-0.047 from the fp32 forward). Each is held, at every valid
    position of every layer, within 5e-2 of the fp32 JAX forward on the
    same bf16-rounded weights: the port's bf16 forward is as close to it as
    the JAX bf16 forward is."""
    jcfg, jparams, cfg, model = _pair(case, dtype=jnp.bfloat16)
    assert cfg.dtype == torch.bfloat16 and model.wte.dtype == torch.bfloat16
    ids, mask = _batch(24, cfg.vocab_size, seed=1)
    run = (lambda p, c: np.asarray(jax_forward(p, jnp.asarray(ids), jnp.asarray(mask), c,
                                               output_hidden_states=True).astype(jnp.float32)))
    rounded = jax.tree.map(lambda a: a.astype(jnp.bfloat16).astype(jnp.float32), jparams)
    fp32 = run(rounded, jcfg.replace(dtype=jnp.float32))
    jax_bf16 = run(jparams, jcfg)
    with torch.no_grad():
        got = model(torch.from_numpy(ids), torch.from_numpy(mask),
                    output_hidden_states=True).float().numpy()
    for layer in range(cfg.num_layers + 1):
        _valid_close(got[layer], fp32[layer], mask, 5e-2)
        _valid_close(jax_bf16[layer], fp32[layer], mask, 5e-2)


def test_token_types_match_jax_and_move_the_output():
    jcfg, jparams, cfg, model = _pair("bert")
    ids, mask = _batch(16, cfg.vocab_size, seed=2)
    tt = np.zeros_like(ids)
    tt[:, 7:] = 1
    with torch.no_grad():
        run = (lambda **kw: model(torch.from_numpy(ids), torch.from_numpy(mask), **kw).numpy())
        default, zeros = run(), run(token_type_ids=torch.zeros(3, 16, dtype=torch.int64))
        mixed = run(token_type_ids=torch.from_numpy(tt))
    np.testing.assert_array_equal(default, zeros)  # token types default to zeros
    want = np.asarray(jax_forward(jparams, jnp.asarray(ids), jnp.asarray(mask), jcfg,
                                  token_type_ids=jnp.asarray(tt)))
    _valid_close(mixed, want, mask, 1e-4)
    assert np.abs(mixed - default).max() > 1e-3


@pytest.mark.parametrize("case", ["bert", "t5"])
def test_inputs_embeds_match_jax(case):
    """input_ids None, B and T from the embeddings: positions, token types
    and the embedding LayerNorm still apply."""
    jcfg, jparams, cfg, model = _pair(case)
    ids, mask = _batch(12, cfg.vocab_size, seed=3)
    embeds = np.random.default_rng(4).normal(size=(3, 12, cfg.hidden_size)).astype(np.float32)
    # the JAX forward takes its default token types from input_ids: pass them
    tt = jnp.zeros((3, 12), jnp.int32) if cfg.token_type_vocab else None
    want = np.asarray(jax_forward(jparams, None, jnp.asarray(mask), jcfg,
                                  inputs_embeds=jnp.asarray(embeds), token_type_ids=tt))
    with torch.no_grad():
        got = model(None, torch.from_numpy(mask), inputs_embeds=torch.from_numpy(embeds))
        from_ids = model(torch.from_numpy(ids), torch.from_numpy(mask))
        via_embeds = model(None, torch.from_numpy(mask),
                           inputs_embeds=model.wte[torch.from_numpy(ids).long()])
    _valid_close(got.numpy(), want, mask, 1e-4)
    np.testing.assert_array_equal(via_embeds.numpy(), from_ids.numpy())
    with pytest.raises(ValueError, match="input_ids or inputs_embeds"):
        model(None, torch.from_numpy(mask))


@pytest.mark.parametrize("buckets,max_distance", [(8, 16), (32, 128)])
def test_t5_bucket_map_equals_jax_for_every_length(buckets, max_distance):
    """The buckets come from an fp32 log truncated to an integer; at bucket
    boundaries one ulp of the log moves a pair to the next bucket. Every T
    up to 512, and the causal map at 512, equal the JAX map exactly (read
    from the JAX bias with the table `arange(buckets)`)."""
    table = jnp.arange(buckets, dtype=jnp.float32)[:, None]
    full = np.asarray(jax_t5_relative_bias(table, 512, buckets, max_distance, True))[0, 0]
    for T in range(1, 513):
        got = relative_buckets(T, buckets, max_distance, True).numpy()
        want = (full[:T, :T] if T < 512 else full).astype(np.int64)
        if T in (1, 77, 128, 256, 300, 511):  # JAX at this length, not a block of 512's
            want = np.asarray(jax_t5_relative_bias(table, T, buckets, max_distance,
                                                   True))[0, 0].astype(np.int64)
        np.testing.assert_array_equal(got, want, err_msg=f"T={T}")
    causal = np.asarray(jax_t5_relative_bias(table, 512, buckets, max_distance, False))[0, 0]
    np.testing.assert_array_equal(relative_buckets(512, buckets, max_distance, False).numpy(),
                                  causal.astype(np.int64))


# ---------------------------------------------------------------------------
# HF parity through the port's loader (random-init transformers models)
# ---------------------------------------------------------------------------

def _hf_batch(vocab):
    rng = np.random.default_rng(0)
    ids = rng.integers(0, vocab, (3, 17)).astype(np.int64)
    mask = np.ones((3, 17), np.int64)
    mask[1, 12:] = 0
    mask[2, 9:] = 0
    return ids, mask


def _hf_check(hf_model, family, tmp_path, **fw):
    hf_model.eval()
    ids, mask = _hf_batch(hf_model.config.vocab_size)
    with torch.no_grad():
        ref = hf_model(input_ids=torch.from_numpy(ids), attention_mask=torch.from_numpy(mask),
                       output_hidden_states=True, **fw).hidden_states
    cfg = config_from_hf(hf_model.config, family)
    sd = convert_hf_state_dict(hf_model.state_dict(), cfg, family)
    # the same checkpoint as a local directory, read by load_pretrained
    save_safetensors(hf_model.state_dict(), str(tmp_path / "model.safetensors"))
    (tmp_path / "config.json").write_text(json.dumps(hf_model.config.to_dict()))
    sd_dir, cfg_dir = load_pretrained(str(tmp_path))
    assert cfg_dir == cfg and set(sd_dir) == set(sd)
    assert all(torch.equal(sd_dir[k], sd[k]) for k in sd)
    model = Decoder(cfg, device="cpu", weights=sd)
    with torch.no_grad():
        ours = model(torch.from_numpy(ids), torch.from_numpy(mask),
                     output_hidden_states=True, **fw).numpy()
    assert ours.shape[0] == len(ref)
    for i, r in enumerate(ref):
        diff = np.abs(ours[i] - r.numpy()) * mask[:, :, None]
        assert diff.max() < 2e-4, f"layer {i}: max diff {diff.max():.2e}"
    return cfg


def test_hf_bert_parity(tmp_path):
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.BertConfig(
        vocab_size=257, hidden_size=64, num_hidden_layers=3, num_attention_heads=4,
        intermediate_size=256, max_position_embeddings=128, type_vocab_size=2,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    torch.manual_seed(0)
    model = transformers.BertModel(hf_cfg)
    tt = torch.zeros(3, 17, dtype=torch.int64)
    tt[:, 9:] = 1
    cfg = _hf_check(model, "bert", tmp_path, token_type_ids=tt)
    assert cfg.post_layernorm and cfg.bidirectional and cfg.token_type_vocab == 2


@pytest.mark.parametrize("ff", ["relu", "gated-gelu"])
def test_hf_t5_encoder_parity(tmp_path, ff):
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.T5Config(
        vocab_size=257, d_model=64, num_layers=3, num_heads=4, d_kv=16, d_ff=256,
        relative_attention_num_buckets=8, relative_attention_max_distance=16,
        dropout_rate=0.0, feed_forward_proj=ff)
    torch.manual_seed(1)
    model = transformers.T5EncoderModel(hf_cfg)
    cfg = _hf_check(model, "t5", tmp_path)
    assert cfg.mlp_activation == ("gated_gelu" if "gated" in ff else "relu")


# ---------------------------------------------------------------------------
# Engine, trainer, build_model
# ---------------------------------------------------------------------------

VOCAB = 512


def _texts(n, seed):
    rng = np.random.default_rng(seed)
    return [" ".join(f"w{rng.integers(0, 300)}" for _ in range(m))
            for m in rng.integers(1, 40, n)]


@pytest.mark.parametrize("case", ["bert", "t5"])
def test_engine_matches_jax_engine(case):
    jcfg, jparams, cfg, model = _pair(case, num_layers=2, vocab_size=VOCAB)
    tok = SimpleTokenizer(VOCAB)
    texts = _texts(11, seed=5)
    kw = dict(method="mean", batch_size=4, max_seq_len=32, normalize_embeddings=True)
    want = JaxEngine(jparams, jcfg, tok, **kw).encode(texts)
    got = EmbeddingEngine(model, cfg, tok, device="cpu", **kw).encode(texts)
    assert got.shape == (11, cfg.hidden_size) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-5)


BATCHES = [[(f"anchor {i} topic{i % 3}", f"positive {i} topic{i % 3}") for i in range(8 * s, 8 * s + 8)]
           for s in range(2)]


@pytest.mark.parametrize("case", ["bert", "t5"])
def test_two_trainer_steps_match_jax(case):
    """Two MNRL steps (warmuplinear: the first at lr 0) of the port's trainer
    against the JAX trainer from the same weights: per-step losses and the
    parameters after."""
    jcfg = jax_tiny(case, num_layers=2, hidden_size=32, num_heads=2, vocab_size=VOCAB)
    jparams = _perturbed(jax_init_params(jcfg, jax.random.key(0)), 2)
    kw = dict(lr=1e-3, epochs=1, batch_size=8, max_seq_len=16, pooling="mean")
    jt = JaxTrainer(jax.tree.map(jnp.asarray, jparams), jcfg, SimpleTokenizer(vocab_size=VOCAB),
                    JaxTrainConfig(**kw))
    cfg = from_jax_config(jcfg)
    model = Decoder(cfg, device="cpu", weights=params_from_jax(jparams, cfg))
    pt = ContrastiveTrainer(model, cfg, SimpleTokenizer(vocab_size=VOCAB), TrainConfig(**kw))
    want = jt.fit(lambda: iter(BATCHES), steps_per_epoch=2)
    got = pt.fit(lambda: iter(BATCHES), steps_per_epoch=2)
    wl = np.array([h["loss"] for h in want["history"]])
    gl = np.array([h["loss"] for h in got["history"]])
    assert len(gl) == len(wl) == 2 and np.isfinite(gl).all()
    np.testing.assert_allclose(gl, wl, rtol=1e-5, atol=1e-5 * wl[0])
    want_params = params_from_jax(jax.tree.map(np.asarray, want["params"]), cfg)
    for name, p in got["params"].items():
        assert np.abs(p.numpy() - want_params[name].numpy()).max() <= 1e-4, name


BUILD_NAMES = ["EleutherAI/gpt-j-6b", "SGPT-5.8B-weightedmean-msmarco", "6.1b",
               "bert-base-uncased", "bert-large-uncased", "roberta-large",
               "bigscience/bloom-1b7", "t5-base", "t5-small", "t5-large",
               "google/t5-v1_1-base", "t5-v1.1-large", "bert-t5", "gpt-neo-1.3b",
               "gpt-neo-2.7b", "gpt-neo-125m", "anything"]


@pytest.mark.parametrize("name", BUILD_NAMES)
def test_build_model_picks_the_jax_preset(monkeypatch, name):
    """`--randominit` picks the preset the JAX `build_model` picks, in its
    order (no weights are drawn: both sides' constructors are stubbed)."""
    monkeypatch.setattr(jax_models, "init_params", lambda cfg, key: {})
    monkeypatch.setattr(jax_models, "cast_params", lambda params, dtype: params)
    monkeypatch.setattr(port_models, "Decoder", lambda cfg, **kw: cfg)
    _, jcfg, _ = jax_common.build_model(name, random_init=True, dtype_str="float32")
    got, cfg, _ = port_common.build_model(name, random_init=True, dtype_str="float32",
                                          device="cpu")
    assert got is cfg
    assert cfg == from_jax_config(jcfg)


def test_presets_equal_jax():
    for size in ("base", "large"):
        assert bert(size) == from_jax_config(jax_models.bert(size))
    for size in ("small", "base", "large"):
        assert t5(size) == from_jax_config(jax_models.t5(size))
    for family in ("bert", "t5"):
        assert tiny(family) == from_jax_config(jax_tiny(family))


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------

@pytest.fixture
def kernel_calls(monkeypatch):
    """Counts the decoder's calls of the K1 and K3 wrappers (their plain
    versions run on the CPU)."""
    calls = {"k1": 0, "k3": 0}

    def count(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(port_decoder, "short_attention", count("k1", port_decoder.short_attention))
    monkeypatch.setattr(port_decoder, "flash_attention", count("k3", port_decoder.flash_attention))
    return calls


@pytest.mark.parametrize("family", ["bert", "t5", "neo", "neo_flash"])
def test_bidirectional_and_relative_configs_never_reach_k1_or_k3(kernel_calls, family):
    """BERT and T5 (with use_flash and T % 128 == 0, where a causal config
    takes K3) take the plain attention in every layer; a causal config
    routes as before: K1 in every layer, or K3 under use_flash."""
    flash = family.endswith("flash")
    cfg = tiny(family.split("_")[0], num_layers=2, use_flash=family != "neo")
    model = Decoder(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    ids = torch.randint(0, cfg.vocab_size, (2, 128), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        model(ids, torch.ones_like(ids))
    if family in ("bert", "t5"):
        assert kernel_calls == {"k1": 0, "k3": 0}
        assert all(layer.attn.plain for layer in model.layers)
    else:
        assert kernel_calls == ({"k1": 0, "k3": 2} if flash else {"k1": 2, "k3": 0})


@pytest.mark.parametrize("family", ["bert", "t5"])
def test_a_bidirectional_config_that_reached_k1_fails_loudly(family):
    """Should the routing ever send a bidirectional layer to K1 or K3, their
    wrappers raise rather than return causal output (here through K1's
    plain version on the CPU)."""
    model = Decoder(tiny(family, num_layers=1, use_flash=True), device="cpu")
    ids = torch.zeros(1, 128, dtype=torch.int64)
    model.layers[0].attn.plain = False
    with torch.no_grad(), pytest.raises(ValueError, match="causal attention only"):
        model(ids, torch.ones_like(ids))
    model.layers[0].attn.use_flash = False
    with torch.no_grad(), pytest.raises(ValueError, match="causal attention only"):
        model(ids, torch.ones_like(ids))
