"""GPT-J and BLOOM contrastive training in the port == the JAX trainer's.

Both trainers start from the same weights (the JAX `init_params`, carried
over by `params_from_jax`), fp32, SPECB and BitFit at max_seq_len 128
(every tower pads to it): `tiny("gptj")` (rotary, the parallel residual,
1/sqrt(Dh) scores) and `tiny("bloom")` (ALiBi with BLOOM's slopes, the
embedding LayerNorm, q/k/v biases) at 2 layers, hidden 32, 2 heads, and
GPT-J at its real head size 256 (hidden 512, 2 heads, rotary on 64 of the
256 dims, its separate biased LM head). Each with `use_flash` off (K1 and
K2's plain versions on the CPU) and on (K3's and K4a/K4b's plain versions;
the JAX side runs its Pallas forward in interpret mode and `_flash_bwd_scan`
backward). Batches of 4 triplets whose documents of 20-300 words truncate at
128 tokens. Tolerances as tests/test_torch_training.py:
  * step-1 loss within 1e-5 relative, bias gradients within 1e-5 of each
    leaf's norm (fp32; the sums run in another order);
  * a 3-step fit's losses within 1e-5 relative plus 1e-5 of the first loss,
    its parameters within 1e-4, and only biases move;
  * GradCache (chunks of 2) gives the direct step's loss within 1e-6
    relative and its gradients within 1e-5 of each leaf's norm;
  * the BitFit mask equals the JAX one leaf for leaf (BLOOM's bq/bk/bv
    train, GPT-J has no attention biases, its head's bias stays frozen).
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
os.environ.setdefault("JAX_PLATFORMS", "cpu")
pytest.importorskip("jax").config.update("jax_platforms", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sgpt_tpu.losses import mnrl_loss as jax_mnrl_loss  # noqa: E402
from sgpt_tpu.models import init_params as jax_init_params  # noqa: E402
from sgpt_tpu.models import tiny as jax_tiny  # noqa: E402
from sgpt_tpu.tokenization import SimpleTokenizer as JaxTokenizer  # noqa: E402
from sgpt_tpu.training import ContrastiveTrainer as JaxTrainer  # noqa: E402
from sgpt_tpu.training import TrainConfig as JaxTrainConfig  # noqa: E402
from sgpt_tpu.training.bitfit import bitfit_mask as jax_bitfit_mask  # noqa: E402
from sgpt_tpu.training.gradcache import gradcache_value_and_grad  # noqa: E402
from sgpt_tpu_torch.models import Decoder, from_jax_config, params_from_jax  # noqa: E402
from sgpt_tpu_torch.models import decoder as decoder_mod  # noqa: E402
from sgpt_tpu_torch.tokenization import SimpleTokenizer  # noqa: E402
from sgpt_tpu_torch.training import (BIAS_NAMES, ContrastiveTrainer, TrainConfig,  # noqa: E402
                                     bitfit_mask)

VOCAB = 512
STEPS = 3
B = 4
T = 128
# name: (family, config overrides, with GPT-J's separate biased LM head)
MODELS = {
    "gptj": ("gptj", dict(hidden_size=32, num_heads=2), False),
    "bloom": ("bloom", dict(hidden_size=32, num_heads=2), False),
    "gptj-dh256": ("gptj", dict(hidden_size=512, num_heads=2), True),
}
CONFIGS = [(m, flash) for m in MODELS for flash in (False, True)]


def _ids(c):
    return f"{c[0]}-{'flash' if c[1] else 'short'}"


def _triplets(n, seed):
    """(query, positive, negative): queries of 3-8 words, documents of 20-300
    words, so that some truncate at max_seq_len."""
    rng = np.random.default_rng(seed)

    def text(lo, hi):
        return " ".join(f"w{rng.integers(0, 400)}" for _ in range(int(rng.integers(lo, hi))))

    return [(text(3, 9), text(20, 301), text(20, 301)) for _ in range(n)]


def _batches(seed):
    rows = _triplets(B * STEPS, seed)
    return [rows[i * B:(i + 1) * B] for i in range(STEPS)]


def _jax_params(model: str, use_flash: bool):
    family, kw, head = MODELS[model]
    jcfg = jax_tiny(family, num_layers=2, vocab_size=VOCAB, max_position_embeddings=T,
                    use_flash=use_flash, **kw)
    if jcfg.head_size == 256:
        jcfg = jcfg.replace(rotary_dim=64)  # GPT-J-6B's rotary share of a head
    jparams = jax_init_params(jcfg, jax.random.key(len(model)))
    if head:  # GPT-J's LM head: a weight and a bias, not tied to wte
        rng = np.random.default_rng(7)
        jparams = {**jparams, "lm_head": {
            "w": jnp.asarray(0.02 * rng.normal(size=(jcfg.hidden_size, VOCAB)), jnp.float32),
            "b": jnp.asarray(rng.normal(size=(VOCAB,)), jnp.float32)}}
    return jcfg, jparams


def _pair(model: str, use_flash: bool, **overrides):
    jcfg, jparams = _jax_params(model, use_flash)
    kw = dict(lr=1e-3, epochs=1, batch_size=B, max_seq_len=T, specb=True,
              freeze_nonbias=True, **overrides)
    jt = JaxTrainer(jparams, jcfg, JaxTokenizer(vocab_size=VOCAB), JaxTrainConfig(**kw))
    cfg = from_jax_config(jcfg)
    net = Decoder(cfg, device="cpu",
                  weights=params_from_jax(jax.tree.map(np.asarray, jparams), cfg))
    assert (net.lm_head is not None) == MODELS[model][2]
    pt = ContrastiveTrainer(net, cfg, SimpleTokenizer(vocab_size=VOCAB), TrainConfig(**kw))
    return jt, pt, cfg


def _jax_loss_and_grads(jt, batch):
    encode = jt._encode_fn()
    towers = jt._prep_batch(batch)
    tree = {"model": jt.params, "aux": jt.aux}

    def loss_fn(*reps):
        return jax_mnrl_loss(*reps, scale=jt.tc.scale)

    if jt.tc.use_gradcache:
        loss, grads = gradcache_value_and_grad(encode, loss_fn)(tree, *towers)
    else:
        loss, grads = jax.value_and_grad(
            lambda t: loss_fn(*[encode(t, tw) for tw in towers]))(tree)
    return float(loss), jax.tree.map(np.asarray, grads["model"])


def _port_step(pt, batch, monkeypatch=None):
    """One step's loss, the gradients of the trainable leaves, and the
    attention calls made with a gradient (flash: T, window; short: T)."""
    calls = []
    if monkeypatch is not None:
        flash, short = decoder_mod.flash_attention, decoder_mod.short_attention

        def flash_spy(q, k, v, key_mask, slopes, **kw):
            if q.requires_grad and torch.is_grad_enabled():
                calls.append(("flash", q.shape[2], q.shape[3], slopes is not None))
            return flash(q, k, v, key_mask, slopes, **kw)

        def short_spy(q, k, v, key_mask, slopes, scale, window, H, *a, **kw):
            if q.requires_grad and torch.is_grad_enabled():
                calls.append(("short", q.shape[1], q.shape[2] // H, slopes is not None))
            return short(q, k, v, key_mask, slopes, scale, window, H, *a, **kw)

        monkeypatch.setattr(decoder_mod, "flash_attention", flash_spy)
        monkeypatch.setattr(decoder_mod, "short_attention", short_spy)
    pt._opt, pt._sched = pt._build_optimizer(STEPS)
    pt._opt.zero_grad(set_to_none=True)
    loss = float(pt._loss_and_grads(pt._prep_batch(batch)))
    grads = {n: p.grad.clone() for n, p in pt.model.named_parameters() if p.requires_grad}
    return loss, grads, calls


@pytest.mark.parametrize("config", CONFIGS, ids=_ids)
def test_first_step_matches_jax(monkeypatch, config):
    model, use_flash = config
    jt, pt, cfg = _pair(model, use_flash)
    batch = _batches(1)[0]
    want_loss, want = _jax_loss_and_grads(jt, batch)
    want = params_from_jax(want, cfg)  # the port's state-dict layout
    loss, grads, calls = _port_step(pt, batch, monkeypatch)
    # every layer of every tower took the attention with a gradient: flash
    # (K4a/K4b on the card) or short (K2), at the family's head size, with
    # BLOOM's slopes
    kind = "flash" if use_flash else "short"
    want_calls = [(kind, T, cfg.head_size, cfg.position_embedding == "alibi")]
    assert calls == want_calls * (cfg.num_layers * 3)
    assert abs(loss - want_loss) <= 1e-5 * abs(want_loss)
    scale = max(np.linalg.norm(want[n].numpy()) for n in grads)
    for name, p in pt.model.named_parameters():
        if name.rsplit(".", 1)[-1] not in BIAS_NAMES:
            assert p.grad is None and not p.requires_grad, name
            continue
        w = want[name].numpy()
        if name.endswith("attn.bk"):
            # BLOOM's key bias adds q·bk to every score of a query row: the
            # softmax does not see it, so its gradient is 0 and both sides
            # hold rounding noise only
            for g in (grads[name].numpy(), w):
                assert np.abs(g).max() <= 1e-6 * scale, (name, np.abs(g).max(), scale)
            continue
        tol = 1e-5 * max(np.linalg.norm(w), 1e-12)
        np.testing.assert_allclose(grads[name].numpy(), w, atol=tol, rtol=0, err_msg=name)


@pytest.mark.parametrize("config", CONFIGS, ids=_ids)
def test_fit_matches_jax(config):
    jt, pt, cfg = _pair(*config)
    before = {k: v.clone() for k, v in pt.model.state_dict().items()}
    batches = _batches(2)
    want = jt.fit(lambda: iter(batches), steps_per_epoch=STEPS)
    got = pt.fit(lambda: iter(batches), steps_per_epoch=STEPS)
    wl = np.array([h["loss"] for h in want["history"]])
    gl = np.array([h["loss"] for h in got["history"]])
    assert len(gl) == len(wl) == STEPS and np.isfinite(gl).all()
    np.testing.assert_allclose(gl, wl, rtol=1e-5, atol=1e-5 * wl[0])
    want_params = params_from_jax(jax.tree.map(np.asarray, want["params"]), cfg)
    assert set(got["params"]) == set(want_params)
    for name, p in got["params"].items():
        d = np.abs(p.numpy() - want_params[name].numpy())
        assert d.max() <= 1e-4, (name, d.max())
        moved = not torch.equal(p, before[name])
        assert moved == (name.rsplit(".", 1)[-1] in BIAS_NAMES), name


@pytest.mark.parametrize("config", CONFIGS, ids=_ids)
def test_gradcache_equals_direct_step(config):
    """GradCache runs the towers without a graph (pass 1), then again with
    one and the backward per chunk of 2 (pass 2): the direct step's loss and
    gradients."""
    _, direct, _ = _pair(*config)
    _, cached, _ = _pair(*config, use_gradcache=True, chunk_size=2)
    batch = _batches(3)[1]
    loss_d, grads_d, _ = _port_step(direct, batch)
    loss_c, grads_c, _ = _port_step(cached, batch)
    assert abs(loss_c - loss_d) <= 1e-6 * abs(loss_d)
    assert grads_d and set(grads_d) == set(grads_c)
    for name, w in grads_d.items():
        tol = 1e-5 * max(w.norm().item(), 1e-12)
        assert (grads_c[name] - w).abs().max().item() <= tol, name


@pytest.mark.parametrize("model", sorted(MODELS))
def test_bitfit_mask_equals_jax_leaf_for_leaf(model):
    """The port's trainable set is the JAX BitFit mask: each JAX leaf's mask
    value, carried through `params_from_jax` as an array of that value, is
    the port's mask of that parameter, and the trainer freezes exactly the
    rest."""
    jcfg, jparams = _jax_params(model, False)
    jmask = jax_bitfit_mask(jparams)
    cfg = from_jax_config(jcfg)
    as_arrays = jax.tree.map(lambda m, p: np.full(np.shape(p), m, np.float32), jmask, jparams)
    want = {name: bool(t.all()) for name, t in params_from_jax(as_arrays, cfg).items()}
    assert all(bool(t.all()) == bool(t.any())
               for t in params_from_jax(as_arrays, cfg).values())
    net = Decoder(cfg, device="cpu",
                  weights=params_from_jax(jax.tree.map(np.asarray, jparams), cfg))
    got = bitfit_mask(net)
    assert got == want
    family = MODELS[model][0]
    trainable = {n.split(".", 2)[-1] for n, m in got.items() if m}
    if family == "bloom":
        assert {"attn.bq", "attn.bk", "attn.bv", "attn.bo"} <= trainable
    else:
        assert not any(n.startswith("attn.") for n in trainable)  # bias-free attention
    if MODELS[model][2]:
        assert got["lm_head.b"] is False and got["lm_head.w"] is False
    trainer = ContrastiveTrainer(net, cfg, SimpleTokenizer(vocab_size=VOCAB),
                                 TrainConfig(batch_size=B, max_seq_len=T, freeze_nonbias=True))
    trainer._build_optimizer(1)  # marks the frozen parameters
    assert {n: p.requires_grad for n, p in net.named_parameters()} == want
