"""The port's contrastive training step == the JAX `ContrastiveTrainer` step.

Both trainers start from the same weights (the JAX `init_params`, carried
over by `params_from_jax`): `tiny("neo", num_layers=2, hidden_size=32,
num_heads=2, vocab_size=512)` in fp32, max_seq_len 16, batches of 8 of the
toy triplets of tests/test_training.py, lr 1e-3, the warmuplinear schedule.
On the CPU the port's attention backward is the plain formula of K2; the JAX
side differentiates its XLA attention. Checked with BitFit on and off, with
GradCache (chunk 4) and with gradient accumulation over 2 micro-steps:
  * step-1 gradients within 1e-5 of each leaf's gradient norm;
  * per-step losses within 1e-5 relative plus 1e-5 of the first step's
    loss: the two forwards agree to 2e-7 of the embeddings' scale (the fp32
    floor), and the loss's rounding error is set by the logits (20 × the
    cosine), not by the loss's size, which falls 4× over the run;
  * parameters after the run within 1e-4 absolute. (Adam's m/√v could
    blow a rounding-level gradient element up to an update of ±lr; no such
    element occurs in this run: the largest difference is below 1e-6.)
  * under BitFit only biases change.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
os.environ.setdefault("JAX_PLATFORMS", "cpu")
pytest.importorskip("jax").config.update("jax_platforms", "cpu")

import jax  # noqa: E402

from sgpt_tpu.data import InputExample  # noqa: E402
from sgpt_tpu.losses import mnrl_loss as jax_mnrl_loss  # noqa: E402
from sgpt_tpu.models import init_params as jax_init_params  # noqa: E402
from sgpt_tpu.models import tiny as jax_tiny  # noqa: E402
from sgpt_tpu.tokenization import SimpleTokenizer  # noqa: E402
from sgpt_tpu.training import ContrastiveTrainer as JaxTrainer  # noqa: E402
from sgpt_tpu.training import TrainConfig as JaxTrainConfig  # noqa: E402
from sgpt_tpu.training.gradcache import gradcache_value_and_grad  # noqa: E402
from sgpt_tpu_torch.models import Decoder, from_jax_config, params_from_jax  # noqa: E402
from sgpt_tpu_torch.training import BIAS_NAMES, ContrastiveTrainer, TrainConfig  # noqa: E402

VOCAB = 512
LR = 1e-3
STEPS = 4  # warmuplinear: step 1 runs at lr 0, so 3 updates


def _toy_triplets(n=64, seed=0):
    """Paraphrase-style triplets: anchor and positive share words (as
    tests/test_training.py makes them)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        a, b, c = rng.integers(0, 50, 3)
        out.append(InputExample(texts=(f"topic{i % 8} word{a} word{b}",
                                       f"topic{i % 8} word{a} word{c}",
                                       f"topic{(i + 3) % 8} other{c} other{b}")))
    return out


BATCHES = [[ex.texts for ex in _toy_triplets(8 * STEPS)[8 * i: 8 * i + 8]]
           for i in range(STEPS)]

VARIANTS = {
    "full": {},
    "bitfit": dict(freeze_nonbias=True),
    "gradcache": dict(use_gradcache=True, chunk_size=4),
    "accum2": dict(grad_accum=2),  # optax.MultiSteps: 2 updates of 2 averaged micro-steps
}


def _pair(**overrides):
    jcfg = jax_tiny("neo", num_layers=2, hidden_size=32, num_heads=2, vocab_size=VOCAB)
    jparams = jax_init_params(jcfg, jax.random.key(0))
    kw = dict(lr=LR, epochs=1, batch_size=8, max_seq_len=16, **overrides)
    jt = JaxTrainer(jparams, jcfg, SimpleTokenizer(vocab_size=VOCAB), JaxTrainConfig(**kw))
    cfg = from_jax_config(jcfg)
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


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_first_step_gradients_match_jax(variant):
    jt, pt, cfg = _pair(**VARIANTS[variant])
    want_loss, want = _jax_loss_and_grads(jt, BATCHES[0])
    want = params_from_jax(want, cfg)  # same layout as the port's state dict
    pt._opt, pt._sched = pt._build_optimizer(STEPS)
    got_loss = float(pt._loss_and_grads(pt._prep_batch(BATCHES[0])))
    assert abs(got_loss - want_loss) <= 1e-5 * abs(want_loss)
    frozen = VARIANTS[variant].get("freeze_nonbias", False)
    for name, p in pt.model.named_parameters():
        if frozen and name.rsplit(".", 1)[-1] not in BIAS_NAMES:
            assert p.grad is None and not p.requires_grad, name
            continue
        w = want[name].numpy()
        tol = 1e-5 * max(np.linalg.norm(w), 1e-12)
        np.testing.assert_allclose(p.grad.numpy(), w, atol=tol, rtol=0, err_msg=name)


def _fit(trainer):
    return trainer.fit(lambda: iter(BATCHES), steps_per_epoch=STEPS)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_training_run_matches_jax(variant):
    jt, pt, cfg = _pair(**VARIANTS[variant])
    before = {k: v.clone() for k, v in pt.model.state_dict().items()}
    want = _fit(jt)
    got = _fit(pt)
    wl = np.array([h["loss"] for h in want["history"]])
    gl = np.array([h["loss"] for h in got["history"]])
    assert len(gl) == len(wl) == STEPS
    np.testing.assert_allclose(gl, wl, rtol=1e-5, atol=1e-5 * wl[0])
    want_params = params_from_jax(jax.tree.map(np.asarray, want["params"]), cfg)
    frozen = VARIANTS[variant].get("freeze_nonbias", False)
    for name, p in got["params"].items():
        w = want_params[name].numpy()
        d = np.abs(p.numpy() - w)
        assert d.max() <= 1e-4, (name, d.max())
        moved = not torch.equal(p, before[name])
        if frozen:
            assert moved == (name.rsplit(".", 1)[-1] in BIAS_NAMES), name
        else:
            assert moved, name
