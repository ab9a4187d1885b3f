"""The port's int8 inference (`sgpt_tpu_torch.ops.quant`) == `sgpt_tpu.ops.quant`.

Same numpy-seeded weights and activations on both sides. The JAX package
runs its quantizer compiled (`quantize_decoder_params` jits it, and
`int8_project` runs inside the jitted forward), where XLA folds the
division by 127 into a product with its reciprocal; the JAX side of these
tests is jitted the same way. Tolerances:

  * weights, scales and activation int8 values: equal bit for bit;
  * `int8_project` outputs: within 1 ulp of the output dtype (fp32, bf16);
  * whole forwards, engine embeddings and CE scores: the int8 steps equal
    JAX's, but an activation whose float value differs from JAX's in its
    last bits (summation order upstream) can round to the next int8 value,
    which moves its row's product by one quantization step and what
    follows by as much as a flipped bf16 rounding moves the bf16 tests: 2 %
    of the reference's largest |value| (hidden states, CE scores), 2e-2 on
    unit embeddings; CE rankings then agree up to such near-ties (Spearman
    ≥ 0.99 for each query).
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
import sgpt_tpu.models.decoder as jdec  # noqa: E402
import sgpt_tpu_torch.crossencoder as pce  # noqa: E402
from sgpt_tpu.encoder import EmbeddingEngine as JaxEngine  # noqa: E402
from sgpt_tpu.models import init_params as jax_init_params  # noqa: E402
from sgpt_tpu.models import tiny as jax_tiny  # noqa: E402
from sgpt_tpu.ops import quant as jq  # noqa: E402
from sgpt_tpu.tokenization import SimpleTokenizer  # noqa: E402
from sgpt_tpu_torch.encoder import EmbeddingEngine  # noqa: E402
from sgpt_tpu_torch.evaluation import spearman  # noqa: E402
from sgpt_tpu_torch.models import Decoder, from_jax_config, params_from_jax  # noqa: E402
from sgpt_tpu_torch.ops import quant as pq  # noqa: E402
from sgpt_tpu_torch.training import ContrastiveTrainer, TrainConfig  # noqa: E402

jax_quantize_weight = jax.jit(jq.quantize_weight, static_argnames="contract_axis")
jax_int8_project = jax.jit(jq.int8_project)
PROJECTIONS = {"attn": ("wq", "wk", "wv", "wo"), "mlp": ("wi", "wo")}
FAMILIES = ["neo", "gptj", "bloom"]


def _bits(a: np.ndarray) -> np.ndarray:
    """Bit patterns as signed integers of the same width (fp32 or bf16)."""
    return a.view(np.int32 if a.dtype == np.float32 else np.int16).astype(np.int64)


def _pair(family, dtype=jnp.float32, **kw):
    """(JAX config, JAX params in the model's dtype, port config, port model)."""
    kw.setdefault("num_layers", 2)
    jcfg = jax_tiny(family, **kw).replace(dtype=dtype)
    jparams = jax.tree.map(lambda a: a.astype(dtype),
                           jax_init_params(jcfg, jax.random.key(0), dtype=jnp.float32))
    cfg = from_jax_config(jcfg)
    model = Decoder(cfg, device="cpu",
                    weights=params_from_jax(jax.tree.map(np.asarray, jparams), cfg))
    return jcfg, jparams, cfg, model


def _close_to_scale(got, want, frac=2e-2):
    np.testing.assert_allclose(got, want, rtol=0, atol=frac * np.abs(want).max())


@pytest.mark.parametrize("shape,axis", [((48, 40), 0), ((3, 48, 40), 1)])
def test_quantize_weight_matches_jax(shape, axis):
    """A JAX (D, F) weight and a stacked (L, D, F) kernel: the same int8
    values and scales; and the port's [out, in] weight gives the transpose."""
    w = (0.02 * np.random.default_rng(0).standard_normal(shape)).astype(np.float32)
    w[..., 3] = 0.0   # an all-zero channel: the scale floor 1e-8
    want = jax_quantize_weight(jnp.asarray(w), contract_axis=axis)
    got = pq.quantize_weight(torch.from_numpy(w), contract_axis=axis)
    for key in ("q", "s"):
        assert got[key].dtype == (torch.int8 if key == "q" else torch.float32)
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    np.testing.assert_array_equal(np.asarray(want["s"])[..., 0, 3], np.float32(1e-8))
    mine = pq.quantize_weight(torch.from_numpy(np.ascontiguousarray(np.swapaxes(w, -1, -2))))
    np.testing.assert_array_equal(mine["q"].numpy(), np.swapaxes(np.asarray(want["q"]), -1, -2))
    np.testing.assert_array_equal(mine["s"].numpy(), np.swapaxes(np.asarray(want["s"]), -1, -2))
    np.testing.assert_allclose(pq.dequantize_weight(mine), np.swapaxes(w, -1, -2),
                               atol=float(np.abs(w).max()) / 254 + 1e-7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_project_matches_jax(dtype):
    """Activation int8 values equal JAX's; the output within 1 ulp."""
    rng = np.random.default_rng(1)
    w = (0.02 * rng.standard_normal((64, 40))).astype(np.float32)
    x = rng.standard_normal((2, 7, 64)).astype(np.float32)
    x[0, 2] = 0.0   # an all-zero token: the scale floor
    jw = jax_quantize_weight(jnp.asarray(w), contract_axis=0)
    qw = pq.quantize_weight(torch.from_numpy(np.ascontiguousarray(w.T)))
    jx = jnp.asarray(x, dtype)
    px = torch.from_numpy(x).to(getattr(torch, dtype))

    @jax.jit
    def jax_activations(x):   # the first lines of the JAX int8_project
        x32 = x.astype(jnp.float32)
        sx = jnp.maximum(jnp.max(jnp.abs(x32), axis=-1, keepdims=True) / 127.0, 1e-8)
        return jnp.round(x32 / sx).astype(jnp.int8), sx

    want_q, want_s = jax_activations(jx)
    got_q, got_s = pq.quantize_activations(px.reshape(-1, 64))
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q).reshape(-1, 64))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s).reshape(-1, 1))
    want = np.asarray(jax_int8_project(jx, jw))
    got = pq.int8_project(px, qw)
    assert got.dtype == px.dtype and tuple(got.shape) == (2, 7, 40)
    got = got.view(torch.int16).numpy().view(want.dtype) if dtype == "bfloat16" else got.numpy()
    assert np.abs(_bits(got) - _bits(want)).max() <= 1
    assert np.array_equal(np.sign(got), np.sign(want))


def test_int8_matmul_plain_version_is_exact():
    """The CPU product (fp64) equals the int64 product at GPT-J's widest
    contraction, and a short batch goes through unpadded."""
    rng = np.random.default_rng(2)
    a = rng.integers(-127, 128, (5, 16384)).astype(np.int8)
    q = rng.integers(-127, 128, (24, 16384)).astype(np.int8)
    got = pq.int8_matmul(torch.from_numpy(a), torch.from_numpy(q))
    assert got.dtype == torch.int32 and tuple(got.shape) == (5, 24)
    np.testing.assert_array_equal(got.numpy(), a.astype(np.int64) @ q.astype(np.int64).T)


def test_quantize_decoder_params_copies_or_frees():
    """Which weights become int8; the default leaves the source intact and
    shares its float tensors; free_source replaces in place. The int8
    weights equal the JAX quantizer's leaf for leaf."""
    jcfg, jparams, cfg, model = _pair("bloom", num_layers=2)
    before = {n: p.clone() for n, p in model.named_parameters()}
    qm = pq.quantize_decoder_params(model)
    assert qm is not model and pq.is_quantized_model(qm) and not pq.is_quantized_model(model)
    for n, p in model.named_parameters():
        assert torch.equal(p, before[n]), n
    float_left = {n for n, _ in qm.named_parameters()}
    assert float_left == {n for n in before if n.rsplit(".", 1)[-1] not in
                          ("wq", "wk", "wv", "wo", "wi")}
    shared = dict(model.named_parameters())
    assert all(p is shared[n] for n, p in qm.named_parameters())
    jqp = jq.quantize_decoder_params(jparams)
    for i, layer in enumerate(qm.layers):
        for group, names in PROJECTIONS.items():
            for name in names:
                w = getattr(getattr(layer, group), name)
                assert isinstance(w, pq.QuantizedWeight) and w["q"].dtype == torch.int8
                leaf = jqp["layers"][group][name]
                np.testing.assert_array_equal(w["q"].numpy(), np.asarray(leaf["q"])[i].T)
                np.testing.assert_array_equal(w["s"].numpy(), np.asarray(leaf["s"])[i].T)
    inplace = pq.quantize_decoder_params(model, free_source=True)
    assert inplace is model and {n for n, _ in model.named_parameters()} == float_left
    for a, b in zip(model.state_dict().items(), qm.state_dict().items()):
        assert a[0] == b[0] and torch.equal(a[1], b[1]), a[0]


@pytest.mark.parametrize("family", FAMILIES)
def test_carried_int8_leaves_equal_the_ports_quantization(family):
    """JAX's quantized tree through `params_from_jax` gives the same int8
    weights and scales as the port quantizing the carried float weights,
    and the same forward bit for bit."""
    jcfg, jparams, cfg, model = _pair(family, dtype=jnp.bfloat16)
    tree = jax.tree.map(np.asarray, jq.quantize_decoder_params(jparams))
    carried = Decoder(cfg, device="cpu", weights=params_from_jax(tree, cfg))
    mine = pq.quantize_decoder_params(model)
    want = mine.state_dict()
    got = carried.state_dict()
    assert list(got) == list(want) and any(k.endswith(".q") for k in got)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    ids = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 9)))
    mask = torch.ones_like(ids)
    with torch.no_grad():
        assert torch.equal(carried(ids, mask), mine(ids, mask))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("family", FAMILIES)
def test_quantized_forward_matches_jax(family, dtype):
    jcfg, jparams, cfg, model = _pair(family, dtype=dtype)
    qm = pq.quantize_decoder_params(model)
    rng = np.random.default_rng(4)
    T = 20
    ids = rng.integers(0, cfg.vocab_size, (3, T)).astype(np.int32)
    mask = (np.arange(T)[None] < np.array([T, 15, 3])[:, None]).astype(np.int32)
    want = np.asarray(jdec.forward(jq.quantize_decoder_params(jparams), jnp.asarray(ids),
                                   jnp.asarray(mask), jcfg).astype(jnp.float32))
    with torch.no_grad():
        got = qm(torch.from_numpy(ids), torch.from_numpy(mask)).float().numpy()
    valid = mask[..., None].astype(bool)
    _close_to_scale(np.where(valid, got, 0), np.where(valid, want, 0))


def _texts(n=23, seed=1):
    rng = np.random.default_rng(seed)
    return [" ".join(f"w{rng.integers(0, 500)}" for _ in range(m))
            for m in rng.integers(1, 80, n)]


@pytest.mark.parametrize("family", ["neo", "gptj"])
def test_engine_int8_matches_jax(family):
    """EmbeddingEngine(quantize="int8") against the JAX engine's: the
    caller's model stays float, the engine's copy is int8."""
    jcfg, jparams, cfg, model = _pair(family)
    tok = SimpleTokenizer(cfg.vocab_size)
    kw = dict(method="weightedmean", specb=True, batch_size=2, max_seq_len=64,
              normalize_embeddings=True, quantize="int8")
    texts = _texts()
    engine = EmbeddingEngine(model, cfg, tok, device="cpu", **kw)
    assert engine.quantize == "int8" and pq.is_quantized_model(engine.model)
    assert not pq.is_quantized_model(model)
    got = engine.encode(texts)
    want = JaxEngine(jparams, jcfg, tok, **kw).encode(texts)
    assert got.shape == (len(texts), cfg.hidden_size)
    np.testing.assert_allclose(got, want, atol=2e-2)
    floats = EmbeddingEngine(model, cfg, tok, device="cpu",
                             **{**kw, "quantize": None}).encode(texts)
    assert np.abs(got - floats).max() > 0   # the int8 path really ran


def _pairs(n=30, seed=7):
    rng = np.random.default_rng(seed)
    return [(" ".join(f"q{i % 3} t{j}" for j in range(int(rng.integers(1, 5)))),
             " ".join(f"d{i} w{j}" for j in range(int(rng.integers(2, 60)))))
            for i in range(n)]


@pytest.mark.parametrize("family", ["neo", "bloom"])
def test_ranker_int8_matches_jax(family):
    """CrossEncoderRanker(quantize="int8") against JAX's: scores, and each
    query's ranking of its documents."""
    jcfg, jparams, cfg, model = _pair(family, vocab_size=512)
    tok = SimpleTokenizer(512)
    kw = dict(batch_size=4, max_length=128, quantize="int8")
    pairs = _pairs()
    ranker = pce.CrossEncoderRanker(model, cfg, tok, device="cpu", **kw)
    assert pq.is_quantized_model(ranker.model) and not pq.is_quantized_model(model)
    got = np.asarray(ranker.predict(pairs))
    want = np.asarray(jce.CrossEncoderRanker(jparams, jcfg, tok, **kw).predict(pairs))
    _close_to_scale(got, want)
    for q in range(3):
        rows = [i for i in range(len(pairs)) if i % 3 == q]
        assert spearman(got[rows], want[rows]) >= 0.99, q


def test_quantize_refusals():
    """An unknown mode raises ValueError (as in JAX); a quantized model does
    not train."""
    _, _, cfg, model = _pair("neo")
    tok = SimpleTokenizer(cfg.vocab_size)
    with pytest.raises(ValueError, match="quantize"):
        EmbeddingEngine(model, cfg, tok, device="cpu", quantize="int4")
    with pytest.raises(ValueError, match="quantize"):
        pce.CrossEncoderRanker(model, cfg, tok, device="cpu", quantize="fp8")
    with pytest.raises(ValueError, match="inference only"):
        ContrastiveTrainer(pq.quantize_decoder_params(model), cfg, tok,
                           TrainConfig(max_seq_len=32))
