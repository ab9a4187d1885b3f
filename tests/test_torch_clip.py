"""The port's CLIP dual tower == the JAX package's, and == HF `CLIPModel`.

`clip_tiny()` with the JAX `init_clip_params` perturbed (every bias, scale
and the class embedding off its init value) and carried over by
`clip_from_jax`: `encode_text` and `encode_image` within 1e-4 in fp32, and
the mixed-batch `CLIPEncoder` against the JAX `CLIPEncoder`. A random-init
HF `CLIPModel` through `convert_hf_clip` within 2e-4 (the JAX test's
tolerance). The host preprocessing is a copy, pinned equal to the JAX one.
The text tower is causal and goes through the fused short-T attention (K1,
its plain version on the CPU) in every layer; the vision tower is
bidirectional and never does.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
os.environ.setdefault("JAX_PLATFORMS", "cpu")
pytest.importorskip("jax").config.update("jax_platforms", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sgpt_tpu.models import clip as jclip  # noqa: E402
from sgpt_tpu.tokenization import SimpleTokenizer  # noqa: E402
from sgpt_tpu_torch.models import clip  # noqa: E402
from sgpt_tpu_torch.models import decoder as port_decoder  # noqa: E402
from sgpt_tpu_torch.models.config import from_jax_config  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread, as in tests/test_torch_short_attention.py: beside
    other test processes on the host's cores, a pool of threads makes each
    of this file's many small operations wait on descheduled threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_cfg(jcfg):
    return clip.CLIPConfig(text=from_jax_config(jcfg.text), vision=from_jax_config(jcfg.vision),
                           image_size=jcfg.image_size, patch_size=jcfg.patch_size,
                           projection_dim=jcfg.projection_dim)


def _pair(seed=0):
    jcfg = jclip.clip_tiny()
    rng = np.random.default_rng(seed + 1)
    jparams = jax.tree.map(
        lambda a: np.asarray(a, np.float32)
        + (0.05 * rng.standard_normal(np.shape(a))).astype(np.float32),
        jclip.init_clip_params(jcfg, jax.random.key(seed)))
    cfg = _port_cfg(jcfg)
    model = clip.CLIP(cfg, device="cpu", weights=clip.clip_from_jax(jparams, cfg))
    return jcfg, jax.tree.map(jnp.asarray, jparams), cfg, model


def _texts_batch(B=3, T=11, lens=(11, 8, 5), vocab=99, seed=0):
    """Rows closed by EOT, the top vocab id, as CLIP's tokenizer closes them."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, vocab - 1, size=(B, T)).astype(np.int32)
    mask = np.zeros((B, T), np.int32)
    for i, n in enumerate(lens):
        ids[i, n - 1] = vocab - 1
        ids[i, n:] = 0
        mask[i, :n] = 1
    return ids, mask


def test_configs_and_shapes_equal_jax():
    assert clip.clip_vit_b_32() == _port_cfg(jclip.clip_vit_b_32())
    assert clip.clip_tiny() == _port_cfg(jclip.clip_tiny())
    jcfg, _, cfg, model = _pair()
    want = jclip.clip_param_shapes(jcfg)
    shapes = clip.clip_param_shapes(cfg)
    assert shapes["patch_w"] == tuple(want["patch_w"])[::-1]
    assert shapes["text_proj"] == tuple(want["text_proj"])[::-1]
    assert shapes["vision.wte"] == (1, cfg.vision.hidden_size)  # the class embedding
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == shapes
    assert cfg.num_patches == jcfg.num_patches == 9


def test_encode_text_and_image_match_jax():
    jcfg, jparams, cfg, model = _pair()
    ids, mask = _texts_batch()
    pixels = np.random.default_rng(2).standard_normal((3, 3, 12, 12)).astype(np.float32)
    want_t = np.asarray(jclip.encode_text(jparams, jnp.asarray(ids), jnp.asarray(mask), jcfg))
    want_v = np.asarray(jclip.encode_image(jparams, jnp.asarray(pixels), jcfg))
    with torch.no_grad():
        got_t = clip.encode_text(model, torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
        got_v = clip.encode_image(model, torch.from_numpy(pixels)).numpy()
    assert got_t.shape == got_v.shape == (3, cfg.projection_dim)
    np.testing.assert_allclose(got_t, want_t, atol=1e-4)
    np.testing.assert_allclose(got_v, want_v, atol=1e-4)
    np.testing.assert_array_equal(
        clip.patchify(torch.from_numpy(pixels), 4).numpy(),
        np.asarray(jclip.patchify(jnp.asarray(pixels), 4)))


def test_hf_clip_parity():
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.CLIPConfig(
        projection_dim=24,
        text_config=transformers.CLIPTextConfig(
            vocab_size=99, hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
            intermediate_size=128, max_position_embeddings=16, projection_dim=24,
            # EOT must be the top vocab id (real CLIP: 49407): HF pools at
            # the eos position it searches for, the port at argmax(ids)
            eos_token_id=98, attention_dropout=0.0).to_dict(),
        vision_config=transformers.CLIPVisionConfig(
            hidden_size=48, num_hidden_layers=2, num_attention_heads=2,
            intermediate_size=192, image_size=12, patch_size=4, projection_dim=24,
            attention_dropout=0.0).to_dict())
    torch.manual_seed(0)
    hf = transformers.CLIPModel(hf_cfg).eval()
    cfg = clip.clip_config_from_hf(hf_cfg)
    assert clip.clip_config_from_hf(hf_cfg.to_dict()) == cfg  # a config.json dict too
    model = clip.CLIP(cfg, device="cpu", weights=clip.convert_hf_clip(hf.state_dict(), cfg))
    ids, mask = _texts_batch()
    pixels = np.random.default_rng(0).standard_normal((3, 3, 12, 12)).astype(np.float32)
    with torch.no_grad():
        ref_t = hf.get_text_features(input_ids=torch.from_numpy(ids).long(),
                                     attention_mask=torch.from_numpy(mask).long())
        ref_v = hf.get_image_features(pixel_values=torch.from_numpy(pixels))
        got_t = clip.encode_text(model, torch.from_numpy(ids), torch.from_numpy(mask))
        got_v = clip.encode_image(model, torch.from_numpy(pixels))
    assert float((got_t - ref_t).abs().max()) < 2e-4
    assert float((got_v - ref_v).abs().max()) < 2e-4


def test_preprocessing_is_the_jax_copy():
    rng = np.random.default_rng(3)
    images = [rng.integers(0, 255, (20, 30, 3)).astype(np.uint8),
              rng.integers(0, 255, (17, 9)).astype(np.uint8),          # grey
              rng.integers(0, 255, (12, 12, 3)).astype(np.uint8)]      # no resize
    for size in (12, 8):
        np.testing.assert_array_equal(clip.preprocess_images(images, size),
                                      jclip.preprocess_images(images, size))
    img = rng.random((7, 5, 3)).astype(np.float32)
    np.testing.assert_array_equal(clip._bilinear_resize(img, 11, 4),
                                  jclip._bilinear_resize(img, 11, 4))


def test_clip_encoder_mixed_batch_matches_jax():
    """ST CLIPModel runtime: a mixed text/image list embeds in input order;
    the same image at two places gives the same embedding."""
    jcfg, jparams, cfg, model = _pair()
    tok = SimpleTokenizer(vocab_size=99)
    rng = np.random.default_rng(1)
    img = rng.integers(0, 255, (20, 30, 3)).astype(np.uint8)
    pre = jclip.preprocess_images([rng.integers(0, 255, (12, 12, 3)).astype(np.uint8)], 12)[0]
    items = ["a cat photo", img, "a dog", img, pre, "a much longer caption " * 6]
    got = clip.CLIPEncoder(model, cfg, tok, normalize_embeddings=True, batch_size=2).encode(items)
    want = jclip.CLIPEncoder(jparams, jcfg, tok, normalize_embeddings=True,
                             batch_size=2).encode(items)
    assert got.shape == (6, cfg.projection_dim) and got.dtype == np.float32
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)
    np.testing.assert_allclose(got, want, atol=1e-4)
    np.testing.assert_array_equal(got[1], got[3])
    assert not np.allclose(got[0], got[2])
    with pytest.raises(ValueError, match="cfg"):
        clip.CLIPEncoder(model, clip.clip_vit_b_32(), tok)


def test_text_tower_takes_k1_and_the_vision_tower_does_not(monkeypatch):
    _, _, cfg, model = _pair()
    calls = []
    k1 = port_decoder.short_attention

    def counted(*a, **kw):
        calls.append(a[0].shape)
        return k1(*a, **kw)

    monkeypatch.setattr(port_decoder, "short_attention", counted)
    enc = clip.CLIPEncoder(model, cfg, SimpleTokenizer(vocab_size=99), batch_size=2)
    rng = np.random.default_rng(0)
    enc.encode([rng.integers(0, 255, (12, 12, 3)).astype(np.uint8) for _ in range(3)])
    assert calls == []
    enc.encode(["one", "two words", "three more words"])  # 2 text batches
    assert len(calls) == 2 * cfg.text.num_layers
    assert all(not layer.attn.plain for layer in model.text.layers)
    assert all(layer.attn.plain for layer in model.vision.layers)


def test_clip_from_jax_refuses_leftover_leaves_and_random_init_builds():
    jcfg = jclip.clip_tiny()
    tree = jax.tree.map(np.asarray, jclip.init_clip_params(jcfg, jax.random.key(0)))
    cfg = _port_cfg(jcfg)
    tree["extra"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="extra"):
        clip.clip_from_jax(tree, cfg)
    del tree["extra"]
    tree["vision"]["wtt"] = np.zeros((2, cfg.vision.hidden_size), np.float32)
    with pytest.raises(ValueError, match="wtt"):
        clip.clip_from_jax(tree, cfg)
    model = clip.CLIP(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    assert float(model.logit_scale.detach()) == pytest.approx(2.6592)
    with torch.no_grad():
        out = clip.encode_image(model, torch.zeros(2, 3, 12, 12))
    assert out.shape == (2, cfg.projection_dim) and torch.isfinite(out).all()
