"""The port's trainable cross-encoder == the JAX package's.

Both sides start from the same weights (the JAX `init_params` and the JAX
class's head, carried over by `params_from_jax` and `head_from_jax`) on
`tiny("neo", num_layers=2, hidden_size=32, num_heads=2, vocab_size=512)` in
fp32 at "highest", with max_length 24 so that pairs truncate. Checked:
  * the longest-first truncation: token rows and masks equal exactly, over
    pairs where one side, the other or both exceed half the budget;
  * `fit` over 10 samples in batches of 4 (3 steps, the last padded with
    repeats; one and three labels): per-step losses within 1e-5 relative
    plus 1e-5 of the first loss, the model's parameters and the head within
    1e-4 after the run (the standing floors of tests/test_torch_training.py);
  * `predict` afterwards (a short last batch included) within 1e-5, and the
    five evaluators' scores equal (the predictions hold no near-ties).
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
os.environ.setdefault("JAX_PLATFORMS", "cpu")
pytest.importorskip("jax").config.update("jax_platforms", "cpu")

import jax  # noqa: E402

import sgpt_tpu.cross_encoder_trainable as jce  # noqa: E402
import sgpt_tpu_torch.cross_encoder_trainable as pce  # noqa: E402
from sgpt_tpu.data import InputExample  # noqa: E402
from sgpt_tpu.models import init_params as jax_init_params  # noqa: E402
from sgpt_tpu.models import tiny as jax_tiny  # noqa: E402
from sgpt_tpu.tokenization import SimpleTokenizer as JaxTokenizer  # noqa: E402
from sgpt_tpu_torch.models import (Decoder, from_jax_config, head_from_jax,  # noqa: E402
                                   params_from_jax)
from sgpt_tpu_torch.tokenization import SimpleTokenizer  # noqa: E402

VOCAB = 512
MAX_LEN = 24


def _words(rng, n):
    return " ".join(f"w{rng.integers(0, 400)}" for _ in range(n))


def _pairs(seed, n):
    rng = np.random.default_rng(seed)
    lengths = [(2, 3), (30, 2), (2, 30), (15, 16), (16, 15), (11, 11), (40, 40), (0, 5)]
    return [(_words(rng, a), _words(rng, b))
            for a, b in (lengths[i % len(lengths)] if i < len(lengths)
                         else rng.integers(1, 14, 2) for i in range(n))]


def _pair(num_labels):
    jcfg = jax_tiny("neo", num_layers=2, hidden_size=32, num_heads=2, vocab_size=VOCAB)
    jparams = jax_init_params(jcfg, jax.random.key(0))
    kw = dict(num_labels=num_labels, max_length=MAX_LEN, batch_size=4, seed=0)
    jt = jce.CrossEncoderTrainable(jparams, jcfg, JaxTokenizer(vocab_size=VOCAB), **kw)
    cfg = from_jax_config(jcfg)
    model = Decoder(cfg, device="cpu",
                    weights=params_from_jax(jax.tree.map(np.asarray, jparams), cfg))
    pt = pce.CrossEncoderTrainable(model, cfg, SimpleTokenizer(vocab_size=VOCAB), **kw)
    pt.head_w, pt.head_b = head_from_jax(jt.head_w, jt.head_b)
    return jt, pt, cfg


def test_longest_first_truncation_matches_jax():
    jt, pt, _ = _pair(1)
    pairs = _pairs(0, 8)
    for pad_to in (None, MAX_LEN):
        j_ids, j_mask = jt._tokenize_pairs(pairs, pad_to=pad_to)
        p_ids, p_mask = pt._tokenize_pairs(pairs, pad_to=pad_to)
        np.testing.assert_array_equal(p_ids.numpy(), np.asarray(j_ids))
        np.testing.assert_array_equal(p_mask.numpy(), np.asarray(j_mask))
    assert (p_mask.numpy().sum(1) == MAX_LEN).sum() >= 5  # these pairs truncated


@pytest.mark.parametrize("num_labels", [1, 3])
def test_fit_predict_and_evaluators_match_jax(num_labels):
    jt, pt, cfg = _pair(num_labels)
    rng = np.random.default_rng(num_labels)
    pairs = _pairs(1, 10)
    labels = (rng.random(10).round(3).tolist() if num_labels == 1
              else rng.integers(0, 3, 10).tolist())
    samples = [InputExample(texts=p, label=lab) for p, lab in zip(pairs, labels)]
    want = jt.fit(samples, epochs=1, lr=1e-3, shuffle_seed=3)
    got = pt.fit(samples, epochs=1, lr=1e-3, shuffle_seed=3)
    wl = np.array([h["loss"] for h in want])
    gl = np.array([h["loss"] for h in got])
    assert len(gl) == len(wl) == 3
    np.testing.assert_allclose(gl, wl, rtol=1e-5, atol=1e-5 * wl[0])
    want_params = params_from_jax(jax.tree.map(np.asarray, jt.params), cfg)
    for name, p in pt.model.state_dict().items():
        assert np.abs(p.numpy() - want_params[name].numpy()).max() <= 1e-4, name
    for got_t, want_t in zip((pt.head_w, pt.head_b), head_from_jax(jt.head_w, jt.head_b)):
        assert np.abs(got_t.detach().numpy() - want_t.numpy()).max() <= 1e-4

    test = _pairs(2, 7)  # a short last batch of 3
    np.testing.assert_allclose(pt.predict(test), jt.predict(test), rtol=1e-5, atol=1e-5)
    if num_labels == 3:
        np.testing.assert_allclose(pt.predict(test, apply_softmax=True),
                                   jt.predict(test, apply_softmax=True), atol=1e-5)
    gold = rng.random(7).tolist()
    binary = [1, 0, 1, 1, 0, 0, 1]
    samples = [{"query": "w1 w2", "positive": [test[i][1]], "negative": [test[j][1] for j in
                                                                       range(7) if j != i]}
               for i in range(3)] + [{"query": "none", "positive": [], "negative": ["x"]}]
    evaluators = [("CECorrelationEvaluator", (test, gold)),
                  ("CEBinaryClassificationEvaluator", (test, binary)),
                  ("CEBinaryAccuracyEvaluator", (test, binary)),
                  ("CERerankingEvaluator", (samples,))]
    if num_labels == 3:
        evaluators.append(("CESoftmaxAccuracyEvaluator", (test, rng.integers(0, 3, 7))))
    for name, args in evaluators:
        assert getattr(pce, name)(*args)(pt) == getattr(jce, name)(*args)(jt), name
    assert pt.predict([]).shape == jt.predict([]).shape


def test_fit_runs_the_evaluator_each_epoch():
    _, pt, _ = _pair(1)
    samples = [InputExample(texts=p, label=float(i % 2)) for i, p in enumerate(_pairs(4, 6))]
    scores = []
    history = pt.fit(samples, epochs=2, lr=1e-3,
                     evaluator=lambda m: scores.append(len(scores)) or 0.5)
    assert [h["eval_score"] for h in history if "eval_score" in h] == [0.5, 0.5]
    assert sum("loss" in h for h in history) == 4
