"""The port's long-context training step (`use_flash`) == the JAX trainer's.

Both trainers start from the same weights (the JAX `init_params`, carried
over by `params_from_jax`): `tiny("neo", num_layers=2, hidden_size=32,
num_heads=2)` with `use_flash=True` (one global layer, one local with window
8), fp32, SPECB and BitFit, at max_seq_len 128 (block_kv 128) and 256 (the
block_kv 256 route). Every tower pads to max_seq_len, so every layer takes
the flash attention: the JAX side runs its Pallas forward in interpret mode
and `_flash_bwd_scan` for the backward; the port the plain versions of K3
and of K4a/K4b. Batches of 4 triplets whose documents of 20-300 words
truncate at max_seq_len. Tolerances as tests/test_torch_training.py:
  * step-1 loss within 1e-5 relative, bias gradients within 1e-5 of each
    leaf's norm (fp32; the sums run in another order);
  * a 3-step fit's losses within 1e-5 relative plus 1e-5 of the first loss,
    its parameters within 1e-4, and only biases move;
  * GradCache (chunks of 2) gives the direct step's loss within 1e-6
    relative and its gradients within 1e-5 of each leaf's norm.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
os.environ.setdefault("JAX_PLATFORMS", "cpu")
pytest.importorskip("jax").config.update("jax_platforms", "cpu")

import jax  # noqa: E402

from sgpt_tpu.losses import mnrl_loss as jax_mnrl_loss  # noqa: E402
from sgpt_tpu.models import init_params as jax_init_params  # noqa: E402
from sgpt_tpu.models import tiny as jax_tiny  # noqa: E402
from sgpt_tpu.tokenization import SimpleTokenizer as JaxTokenizer  # noqa: E402
from sgpt_tpu.training import ContrastiveTrainer as JaxTrainer  # noqa: E402
from sgpt_tpu.training import TrainConfig as JaxTrainConfig  # noqa: E402
from sgpt_tpu.training.gradcache import gradcache_value_and_grad  # noqa: E402
from sgpt_tpu_torch.models import Decoder, from_jax_config, params_from_jax  # noqa: E402
from sgpt_tpu_torch.models import decoder as decoder_mod  # noqa: E402
from sgpt_tpu_torch.tokenization import SimpleTokenizer  # noqa: E402
from sgpt_tpu_torch.training import BIAS_NAMES, ContrastiveTrainer, TrainConfig  # noqa: E402

VOCAB = 512
STEPS = 3
B = 4


def _triplets(n, seed):
    """(query, positive, negative): queries of 3-8 words, documents of 20-300
    words, so that some truncate at max_seq_len."""
    rng = np.random.default_rng(seed)

    def text(lo, hi):
        return " ".join(f"w{rng.integers(0, 400)}" for _ in range(int(rng.integers(lo, hi))))

    return [(text(3, 9), text(20, 301), text(20, 301)) for _ in range(n)]


def _batches(T):
    rows = _triplets(B * STEPS, seed=T)
    return [rows[i * B:(i + 1) * B] for i in range(STEPS)]


def _pair(T, **overrides):
    jcfg = jax_tiny("neo", num_layers=2, hidden_size=32, num_heads=2, vocab_size=VOCAB,
                    max_position_embeddings=T, use_flash=True)
    jparams = jax_init_params(jcfg, jax.random.key(T))
    kw = dict(lr=1e-3, epochs=1, batch_size=B, max_seq_len=T, specb=True,
              freeze_nonbias=True, **overrides)
    jt = JaxTrainer(jparams, jcfg, JaxTokenizer(vocab_size=VOCAB), JaxTrainConfig(**kw))
    cfg = from_jax_config(jcfg)
    assert cfg.use_flash and cfg.local_flags() == (False, True)
    model = Decoder(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams), cfg))
    pt = ContrastiveTrainer(model, cfg, SimpleTokenizer(vocab_size=VOCAB), TrainConfig(**kw))
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
    """One step's loss, the gradients of the trainable leaves, and the flash
    calls made with a gradient (T, window, block_kv)."""
    calls = []
    if monkeypatch is not None:
        flash = decoder_mod.flash_attention

        def spy(q, k, v, key_mask, slopes, **kw):
            if q.requires_grad and torch.is_grad_enabled():
                calls.append((q.shape[2], kw["window"], kw["block_kv"]))
            return flash(q, k, v, key_mask, slopes, **kw)

        monkeypatch.setattr(decoder_mod, "flash_attention", spy)
    pt._opt, pt._sched = pt._build_optimizer(STEPS)
    pt._opt.zero_grad(set_to_none=True)
    loss = float(pt._loss_and_grads(pt._prep_batch(batch)))
    grads = {n: p.grad.clone() for n, p in pt.model.named_parameters() if p.requires_grad}
    return loss, grads, calls


@pytest.mark.parametrize("T", [128, 256])
def test_first_step_matches_jax(monkeypatch, T):
    jt, pt, cfg = _pair(T)
    batch = _batches(T)[0]
    want_loss, want = _jax_loss_and_grads(jt, batch)
    want = params_from_jax(want, cfg)  # the port's state-dict layout
    loss, grads, calls = _port_step(pt, batch, monkeypatch)
    # every layer of every tower took flash with a gradient (K4 on the card)
    block_kv = 256 if T % 256 == 0 else 128
    assert calls == [(T, 0, block_kv), (T, cfg.local_window, block_kv)] * 3
    assert abs(loss - want_loss) <= 1e-5 * abs(want_loss)
    for name, p in pt.model.named_parameters():
        if name.rsplit(".", 1)[-1] not in BIAS_NAMES:
            assert p.grad is None and not p.requires_grad, name
            continue
        w = want[name].numpy()
        tol = 1e-5 * max(np.linalg.norm(w), 1e-12)
        np.testing.assert_allclose(grads[name].numpy(), w, atol=tol, rtol=0, err_msg=name)


@pytest.mark.parametrize("T", [128, 256])
def test_fit_matches_jax(T):
    jt, pt, cfg = _pair(T)
    before = {k: v.clone() for k, v in pt.model.state_dict().items()}
    batches = _batches(T)
    want = jt.fit(lambda: iter(batches), steps_per_epoch=STEPS)
    got = pt.fit(lambda: iter(batches), steps_per_epoch=STEPS)
    wl = np.array([h["loss"] for h in want["history"]])
    gl = np.array([h["loss"] for h in got["history"]])
    assert len(gl) == len(wl) == STEPS and np.isfinite(gl).all()
    np.testing.assert_allclose(gl, wl, rtol=1e-5, atol=1e-5 * wl[0])
    want_params = params_from_jax(jax.tree.map(np.asarray, want["params"]), cfg)
    for name, p in got["params"].items():
        d = np.abs(p.numpy() - want_params[name].numpy())
        assert d.max() <= 1e-4, (name, d.max())
        moved = not torch.equal(p, before[name])
        assert moved == (name.rsplit(".", 1)[-1] in BIAS_NAMES), name


@pytest.mark.parametrize("T", [128, 256])
def test_gradcache_equals_direct_step(T):
    """GradCache runs the flash forward without a graph (pass 1), then again
    with one and its backward per chunk (pass 2): the same loss and
    gradients as one direct step."""
    _, direct, _ = _pair(T)
    _, cached, _ = _pair(T, use_gradcache=True, chunk_size=2)
    batch = _batches(T)[1]
    loss_d, grads_d, _ = _port_step(direct, batch)
    loss_c, grads_c, _ = _port_step(cached, batch)
    assert abs(loss_c - loss_d) <= 1e-6 * abs(loss_d)
    assert grads_d and set(grads_d) == set(grads_c)
    for name, w in grads_d.items():
        tol = 1e-5 * max(w.norm().item(), 1e-12)
        assert (grads_c[name] - w).abs().max().item() <= tol, name
