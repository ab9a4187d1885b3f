"""GPT-J and BLOOM in the port == `sgpt_tpu.models.decoder` on the same weights.

`tiny("gptj")` (rotary on the leading 8 of each head's 16 dims, the parallel
residual, 1/sqrt(Dh) scores) and `tiny("bloom")` (ALiBi with BLOOM's slopes,
the embedding LayerNorm, q/k/v biases), with the JAX `init_params`
converted by `params_from_jax`, as `tests/test_torch_decoder.py` holds
GPT-Neo. The JAX side runs its XLA attention (ALiBi as slope × (cumsum(mask)
− 1)), or its flash kernel in interpret mode where `use_flash` is on; the
port runs K1's and K3's plain versions. Compared at valid (unpadded)
positions. Tolerances: fp32 1e-5 relative and 1e-5 absolute (only the
summation order differs; the scores and the rotary tables round as JAX
rounds them), bf16 5e-2 absolute (as GPT-Neo's bf16 test: a flipped
rounding of an activation), engine embeddings 1e-5 (normalised), CE scores
2e-5 relative and 1e-4 absolute (as `tests/test_torch_crossencoder.py`).
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

import sgpt_tpu.crossencoder as jce  # noqa: E402
import sgpt_tpu.models.decoder as jdec  # noqa: E402
import sgpt_tpu_torch.crossencoder as pce  # noqa: E402
from sgpt_tpu.encoder import EmbeddingEngine as JaxEngine  # noqa: E402
from sgpt_tpu.models import init_params as jax_init_params  # noqa: E402
from sgpt_tpu.models import tiny as jax_tiny  # noqa: E402
from sgpt_tpu.tokenization import SimpleTokenizer  # noqa: E402
from sgpt_tpu_torch.encoder import EmbeddingEngine  # noqa: E402
from sgpt_tpu_torch.models import (Decoder, bloom, from_jax_config, gpt_j_6b,  # noqa: E402
                                   params_from_jax, tiny)
from sgpt_tpu_torch.models import decoder as decoder_mod  # noqa: E402
from sgpt_tpu_torch.models.params import init_params_, param_shapes  # noqa: E402

FAMILIES = ["gptj", "bloom"]
RTOL = ATOL = 1e-5


def _pair(family, dtype=jnp.float32, lm_head=None, **kw):
    """(JAX config, JAX params, port config, port model) on the same weights;
    lm_head: None (tied), "w" or "wb" — a random separate head added to the tree."""
    kw.setdefault("num_layers", 3)
    jcfg = jax_tiny(family, **kw).replace(dtype=dtype)
    jparams = jax_init_params(jcfg, jax.random.key(0), dtype=jnp.float32)
    if lm_head:
        rng = np.random.default_rng(5)
        head = {"w": jnp.asarray(0.3 * rng.normal(size=(jcfg.hidden_size, jcfg.vocab_size)),
                                 jnp.float32)}
        if "b" in lm_head:
            head["b"] = jnp.asarray(rng.normal(size=(jcfg.vocab_size,)), jnp.float32)
        jparams = {**jparams, "lm_head": head}
    cfg = from_jax_config(jcfg)
    model = Decoder(cfg, device="cpu",
                    weights=params_from_jax(jax.tree.map(np.asarray, jparams), cfg))
    return jcfg, jparams, cfg, model


def _batch(T, vocab, seed=0, B=3):
    """Right-padded rows: one full, one short of 5, one of 3 tokens."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (B, T)).astype(np.int32)
    lengths = np.array([T, T - 5, 3] + [T] * (B - 3))
    mask = (np.arange(T)[None] < lengths[:, None]).astype(np.int32)
    return ids, mask


def _run(model, ids, mask, **kw):
    with torch.no_grad():
        return model(torch.from_numpy(ids), torch.from_numpy(mask),
                     **{k: torch.from_numpy(v) for k, v in kw.items()}).float().numpy()


def _close_valid(got, want, mask, rtol=RTOL, atol=ATOL):
    valid = np.broadcast_to(mask[..., None].astype(bool), got.shape)
    np.testing.assert_allclose(np.where(valid, got, 0), np.where(valid, want, 0),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("T", [6, 37])
@pytest.mark.parametrize("family", FAMILIES)
def test_hidden_states_match_jax_fp32(family, T):
    jcfg, jparams, cfg, model = _pair(family)
    ids, mask = _batch(T, cfg.vocab_size)
    want = np.asarray(jdec.forward(jparams, jnp.asarray(ids), jnp.asarray(mask), jcfg,
                                   output_hidden_states=True))
    with torch.no_grad():
        got = model(torch.from_numpy(ids), torch.from_numpy(mask),
                    output_hidden_states=True).numpy()
    assert got.shape == want.shape == (cfg.num_layers + 1, 3, T, cfg.hidden_size)
    _close_valid(got, want, mask[None])
    np.testing.assert_array_equal(_run(model, ids, mask), got[-1])


@pytest.mark.parametrize("family", FAMILIES)
def test_hidden_states_match_jax_bf16(family):
    jcfg, jparams, cfg, model = _pair(family, dtype=jnp.bfloat16)
    assert model.wte.dtype == torch.bfloat16
    ids, mask = _batch(20, cfg.vocab_size, seed=1)
    want = np.asarray(jdec.forward(jparams, jnp.asarray(ids), jnp.asarray(mask),
                                   jcfg).astype(jnp.float32))
    _close_valid(_run(model, ids, mask), want, mask, rtol=0, atol=5e-2)


@pytest.mark.parametrize("head", [None, "w", "wb"])
@pytest.mark.parametrize("family", FAMILIES)
def test_logits_match_jax(family, head):
    """Tied to wte, or a separate head (GPT-J's carries a bias)."""
    jcfg, jparams, cfg, model = _pair(family, lm_head=head)
    assert (model.lm_head is None) == (head is None)
    h = np.random.default_rng(2).normal(size=(2, 5, cfg.hidden_size)).astype(np.float32)
    want = np.asarray(jdec.logits(jparams, jnp.asarray(h), jcfg))
    with torch.no_grad():
        got = model.logits(torch.from_numpy(h)).numpy()
    assert got.shape == (2, 5, cfg.vocab_size)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("T", [128, 256])
@pytest.mark.parametrize("family", FAMILIES)
def test_flash_matches_jax_flash(family, T):
    """use_flash at T % 128 == 0: JAX's flash kernel (interpret mode; BLOOM's
    slopes, GPT-J's rotary q and k) against K3's plain version."""
    jcfg, jparams, cfg, model = _pair(family, num_layers=2, max_position_embeddings=512,
                                      use_flash=True)
    ids, mask = _batch(T, cfg.vocab_size, seed=T)
    calls = []
    flash = decoder_mod.flash_attention

    def spy(*a, **kw):
        calls.append(a[4] is not None)
        return flash(*a, **kw)

    decoder_mod.flash_attention = spy
    try:
        got = _run(model, ids, mask)
    finally:
        decoder_mod.flash_attention = flash
    assert calls == [family == "bloom"] * cfg.num_layers  # slopes for BLOOM only
    want = np.asarray(jdec.forward(jparams, jnp.asarray(ids), jnp.asarray(mask), jcfg))
    _close_valid(got, want, mask)


def _packed(T=24, cut=10):
    """Two segments a row: positions restart at `cut`; row 1 pads its tail."""
    seg = np.zeros((2, T), np.int32)
    seg[:, cut:] = 1
    pos = np.tile(np.concatenate([np.arange(cut), np.arange(T - cut)]), (2, 1)).astype(np.int32)
    mask = np.ones((2, T), np.int32)
    mask[1, T - 4:] = 0
    return seg, pos, mask


@pytest.mark.parametrize("family", FAMILIES)
def test_packed_rows_match_unpacked_segments_and_jax(family):
    """Packed rows (block-diagonal attention, positions and ALiBi key
    positions restarting per segment) == each segment run alone, and == the
    JAX decoder's packed forward."""
    jcfg, jparams, cfg, model = _pair(family)
    T, cut = 24, 10
    ids = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, T)).astype(np.int32)
    seg, pos, mask = _packed(T, cut)
    got = _run(model, ids, mask, segment_ids=seg, position_ids=pos)
    want = np.asarray(jdec.forward(jparams, jnp.asarray(ids), jnp.asarray(mask), jcfg,
                                   segment_ids=jnp.asarray(seg), position_ids=jnp.asarray(pos)))
    _close_valid(got, want, mask)
    first = _run(model, ids[:, :cut].copy(), mask[:, :cut].copy())
    second = _run(model, ids[:, cut:].copy(), mask[:, cut:].copy())
    _close_valid(got, np.concatenate([first, second], axis=1), mask)


def test_packed_alibi_key_positions_reach_k1():
    """Under packing, BLOOM's K1 call gets the per-segment positions as its
    ALiBi key positions; unpacked, none (the key index)."""
    _, _, cfg, model = _pair("bloom", num_layers=1)
    seg, pos, mask = _packed()
    ids = np.zeros_like(seg)
    seen = []
    short = decoder_mod.short_attention

    def spy(*a, **kw):
        seen.append((a[8], kw["positions"]))
        return short(*a, **kw)

    decoder_mod.short_attention = spy
    try:
        _run(model, ids, mask, segment_ids=seg, position_ids=pos)
        _run(model, ids, mask)
    finally:
        decoder_mod.short_attention = short
    (alibi_p, kpos_p), (alibi_u, kpos_u) = seen
    assert alibi_p and alibi_u and kpos_u is None
    np.testing.assert_array_equal(kpos_p.numpy(), pos)


def test_unpacked_alibi_equals_jax_cumsum_positions_under_right_padding():
    """Unpacked rows: the port gives K1 the key index as the ALiBi position,
    the JAX XLA path slope × (cumsum(mask) − 1)·mask. Under right padding
    the two agree on every valid key, so the outputs agree at valid rows."""
    jcfg, jparams, cfg, model = _pair("bloom")
    ids, mask = _batch(30, cfg.vocab_size, seed=4)
    cum = (np.cumsum(mask, -1) - 1) * mask
    idx = np.broadcast_to(np.arange(30), mask.shape)
    assert np.array_equal(np.where(mask > 0, cum, 0), np.where(mask > 0, idx, 0))
    bias = np.asarray(jdec.build_alibi_bias(jnp.asarray(mask), cfg.num_heads))
    slopes = decoder_mod.alibi_slopes(cfg.num_heads).numpy()
    np.testing.assert_array_equal(
        np.where(mask[:, None, None, :] > 0, bias, 0),
        np.where(mask[:, None, None, :] > 0,
                 slopes[None, :, None, None] * idx[:, None, None, :].astype(np.float32), 0))
    want = np.asarray(jdec.forward(jparams, jnp.asarray(ids), jnp.asarray(mask), jcfg))
    _close_valid(_run(model, ids, mask), want, mask)


@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("family", FAMILIES)
def test_head_size_256(family, use_flash):
    """Dh 256 (GPT-J's head: hidden 512, 2 heads) through K1's plain version
    (T=40) and K3's (use_flash, T=128)."""
    jcfg, jparams, cfg, model = _pair(family, num_layers=2, hidden_size=512, num_heads=2,
                                      max_position_embeddings=256, use_flash=use_flash)
    assert cfg.head_size == 256
    T = 128 if use_flash else 40
    ids, mask = _batch(T, cfg.vocab_size, seed=6)
    want = np.asarray(jdec.forward(jparams, jnp.asarray(ids), jnp.asarray(mask), jcfg))
    _close_valid(_run(model, ids, mask), want, mask, atol=2e-5)


def test_rotary_and_slopes_match_jax():
    rng = np.random.default_rng(7)
    for positions in (np.arange(11), rng.integers(0, 300, (3, 11))):
        jsin, jcos = jdec.rope_sincos(jnp.asarray(positions), 16)
        sin, cos = decoder_mod.rope_sincos(torch.from_numpy(positions), 16)
        np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), rtol=1e-6, atol=1e-6)
        x = rng.normal(size=(3, 11, 2, 24)).astype(np.float32)
        got = decoder_mod.apply_rotary(torch.from_numpy(x), sin, cos, 16).numpy()
        want = np.asarray(jdec.apply_rotary(jnp.asarray(x), jsin, jcos, 16))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(got[..., 16:], x[..., 16:])
    for H in (1, 4, 12, 16, 20, 32, 112):
        np.testing.assert_array_equal(decoder_mod.alibi_slopes(H).numpy(),
                                      np.asarray(jdec.alibi_slopes(H)))


def _texts(n=19, seed=1):
    rng = np.random.default_rng(seed)
    return [" ".join(f"w{rng.integers(0, 500)}" for _ in range(m))
            for m in rng.integers(1, 80, n)]


@pytest.mark.parametrize("specb", [False, True])
@pytest.mark.parametrize("family", FAMILIES)
def test_engine_embeddings_match_jax(family, specb):
    jcfg, jparams, cfg, model = _pair(family, num_layers=2)
    tok = SimpleTokenizer(cfg.vocab_size)
    kw = dict(method="weightedmean", specb=specb, batch_size=2, max_seq_len=64,
              normalize_embeddings=True)
    texts = _texts()
    got = EmbeddingEngine(model, cfg, tok, device="cpu", **kw).encode(texts)
    want = JaxEngine(jparams, jcfg, tok, **kw).encode(texts)
    assert got.shape == (len(texts), cfg.hidden_size)
    np.testing.assert_allclose(got, want, atol=1e-5)


def _pairs(n=20, seed=7):
    rng = np.random.default_rng(seed)
    return [(" ".join(f"q{i} t{j}" for j in range(int(rng.integers(1, 5)))),
             " ".join(f"d{i} w{j}" for j in range(int(rng.integers(2, 40) if i % 3
                                                       else rng.integers(60, 90)))))
            for i in range(n)]


@pytest.mark.parametrize("pack_t", [None, 64])
@pytest.mark.parametrize("family", FAMILIES)
def test_crossencoder_scores_match_jax(family, pack_t):
    """SGPT-CE on GPT-J (its separate, biased head) and BLOOM (tied head,
    ALiBi key positions restarting in each packed segment)."""
    jcfg, jparams, cfg, model = _pair(family, num_layers=2, vocab_size=512,
                                      lm_head="wb" if family == "gptj" else None)
    tok = SimpleTokenizer(512)
    kw = dict(batch_size=4, max_length=128, pack_t=pack_t)
    pairs = _pairs()
    got = pce.CrossEncoderRanker(model, cfg, tok, device="cpu", **kw).predict(pairs)
    want = jce.CrossEncoderRanker(jparams, jcfg, tok, **kw).predict(pairs)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-4)


def test_crossencoder_max_length_bound_only_with_learned_positions():
    """A position past GPT-Neo's `wpe` is a device assert on the card; GPT-J's
    rotary and BLOOM's ALiBi have no table, and the JAX ranker takes any
    max_length for them."""
    tok = SimpleTokenizer(257)
    for family in FAMILIES:
        m = Decoder(tiny(family, num_layers=1), device="cpu")
        assert pce.CrossEncoderRanker(m, m.cfg, tok, device="cpu",
                                      max_length=512).max_length == 512
    neo = Decoder(tiny("neo", num_layers=1), device="cpu")
    with pytest.raises(ValueError, match="positions"):
        pce.CrossEncoderRanker(neo, neo.cfg, tok, device="cpu", max_length=512)


def test_presets_mirror_jax():
    from sgpt_tpu.models import bloom as jax_bloom
    from sgpt_tpu.models import gpt_j_6b as jax_gpt_j_6b
    assert from_jax_config(jax_gpt_j_6b()) == gpt_j_6b()
    for size in ("560m", "1b7", "3b", "7b1"):
        assert from_jax_config(jax_bloom(size)) == bloom(size)
    for family in ("neo", "gptj", "bloom"):
        assert from_jax_config(jax_tiny(family)) == tiny(family)
    assert gpt_j_6b().head_size == 256 and bloom("7b1").head_size == 128
    n = sum(int(np.prod(s)) for s in param_shapes(gpt_j_6b(), ("w", "b")).values())
    assert 6.0e9 < n < 6.1e9  # "6B" with its biased head


def test_device_init_fills_in_place():
    """`init_params_`: the JAX distribution drawn into existing tensors in
    their dtype (the card's 6B path; exercised here on CPU tensors)."""
    cfg = tiny("gptj", num_layers=1, hidden_size=64, vocab_size=4000)
    params = {n: torch.empty(s, dtype=torch.bfloat16)
              for n, s in param_shapes(cfg, ("w", "b")).items()}
    ptrs = {n: t.data_ptr() for n, t in params.items()}
    init_params_(params, torch.Generator().manual_seed(0))
    assert all(params[n].data_ptr() == p for n, p in ptrs.items())
    assert params["wte"].dtype == torch.bfloat16
    assert abs(params["wte"].float().std().item() - 0.02) < 1e-3
    assert torch.all(params["layers.0.ln1.scale"] == 1)
    assert torch.all(params["lm_head.b"] == 0) and torch.all(params["layers.0.mlp.bi"] == 0)
    assert "layers.0.ln2.scale" not in params and "wpe" not in params
