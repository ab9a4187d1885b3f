"""The port's losses == the JAX package's, value and gradients.

Each case runs the same fp32 inputs, drawn with numpy from a seed, through
the JAX loss (gradients by `jax.grad`) and the port's (gradients by
autograd), and holds the value and every input's gradient to rtol 1e-5,
atol 1e-6: the two sides differ only in summation order (the fp32 floor).
The inputs are continuous normals, so that no max, min or argmax of a
mining loss is tied and both sides pick the same element. The labels of the
batch-triplet family give every class two or more members, and one case an
anchor with no negative at all (semi-hard's fallback).
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
os.environ.setdefault("JAX_PLATFORMS", "cpu")
pytest.importorskip("jax").config.update("jax_platforms", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import sgpt_tpu.losses as jl  # noqa: E402
import sgpt_tpu_torch.losses as pl  # noqa: E402

B, D = 8, 16
RNG = np.random.default_rng(20)
U, V, W = (RNG.normal(size=(B, D)).astype(np.float32) for _ in range(3))
BIN = np.array([1, 0, 1, 1, 0, 0, 1, 0], np.int32)
CLS = np.array([2, 0, 1, 2, 0, 3, 1, 3], np.int32)
ONE_CLASS_AND_ALONE = np.array([0, 0, 0, 0, 0, 0, 0, 1], np.int32)
GOLD = RNG.normal(size=B).astype(np.float32)
STS = RNG.random(B).astype(np.float32)
HEAD = (0.1 * RNG.normal(size=(3 * D, 3))).astype(np.float32)
HEAD_B = RNG.normal(size=3).astype(np.float32)
NLI = np.array([0, 1, 2, 0, 1, 2, 0, 1], np.int32)
CT = np.array([1, 0, 0, 0, 1, 0, 0, 0], np.int32)
SCALE = np.array(np.log(20.0), np.float32)

# name: (function name, float inputs (differentiated), fixed inputs, keywords);
# a fixed input stands after the float ones in the call, except where the
# loss takes labels first (the batch-triplet family: "labels_first")
CASES = {
    "mnrl": ("mnrl_loss", (U, V), (), {}),
    "mnrl_neg_dot": ("mnrl_loss", (U, V, W), (), dict(similarity="dot", scale=1.0)),
    "softmax": ("softmax_loss", (U, V, HEAD), (NLI, HEAD_B), {}),
    "triplet": ("triplet_loss", (U, V, W), (), {}),
    "triplet_cosine": ("triplet_loss", (U, V, W), (), dict(distance="cosine", margin=0.5)),
    "contrastive": ("contrastive_loss", (U, V), (BIN,), {}),
    "contrastive_euclidean": ("contrastive_loss", (U, V), (BIN,),
                              dict(distance="euclidean", margin=6.0)),
    "online_contrastive": ("online_contrastive_loss", (U, V), (BIN,), dict(margin=1.0)),
    "online_contrastive_one_positive": (
        "online_contrastive_loss", (U, V), (np.eye(B, dtype=np.int32)[2],),
        dict(margin=1.0)),
    "online_contrastive_euclidean": ("online_contrastive_loss", (U, V), (BIN,),
                                     dict(distance="euclidean", margin=6.0)),
    "margin_mse": ("margin_mse_loss", (U, V, W, GOLD), (), {}),
    "mse": ("mse_loss", (U, V), (), {}),
    "cosine_similarity": ("cosine_similarity_loss", (U, V), (STS,), {}),
    "mnrl_symmetric": ("mnrl_symmetric_loss", (U, V), (), {}),
    "mnrl_symmetric_neg": ("mnrl_symmetric_loss", (U, V, W), (), {}),
    "contrastive_tension": ("contrastive_tension_loss", (0.3 * U, 0.3 * V), (CT,), {}),
    "ct_in_batch": ("contrastive_tension_in_batch_negatives_loss", (U, V, SCALE), (), {}),
    "batch_hard": ("batch_hard_triplet_loss", (U,), (CLS,), "labels_first"),
    "batch_hard_cosine": ("batch_hard_triplet_loss", (U,), (CLS,),
                          ("labels_first", dict(metric="cosine", margin=0.5))),
    "batch_hard_soft_margin": ("batch_hard_soft_margin_triplet_loss", (U,), (CLS,),
                               "labels_first"),
    "batch_all": ("batch_all_triplet_loss", (U,), (CLS,), "labels_first"),
    "batch_all_cosine": ("batch_all_triplet_loss", (U,), (CLS,),
                         ("labels_first", dict(metric="cosine", margin=0.5))),
    "batch_semi_hard": ("batch_semi_hard_triplet_loss", (U,), (CLS,), "labels_first"),
    "batch_semi_hard_no_negative": ("batch_semi_hard_triplet_loss", (U,),
                                    (ONE_CLASS_AND_ALONE,), "labels_first"),
    "megabatch_margin": ("megabatch_margin_loss", (U, V), (), {}),
}


def _call(mod, name, floats, fixed, kw, to):
    fn = getattr(mod, name)
    if isinstance(kw, tuple):
        order, kw = kw
    elif kw == "labels_first":
        order, kw = kw, {}
    else:
        order = "floats_first"
    fixed = [to(x) for x in fixed]
    if name == "contrastive_tension_in_batch_negatives_loss":
        return fn(floats[0], floats[1], logit_scale=floats[2], **kw)
    if name == "softmax_loss":
        return fn(*floats, fixed[0], classifier_b=fixed[1], **kw)
    if order == "labels_first":
        return fn(*fixed, *floats, **kw)
    return fn(*floats, *fixed, **kw)


@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_and_gradients_match_jax(case):
    name, floats, fixed, kw = CASES[case]
    argnums = tuple(range(len(floats)))
    want, want_grads = jax.value_and_grad(
        lambda *xs: _call(jl, name, xs, fixed, kw, jnp.asarray), argnums=argnums)(
        *[jnp.asarray(x) for x in floats])
    xs = [torch.tensor(x, requires_grad=True) for x in floats]
    got = _call(pl, name, xs, fixed, kw, torch.from_numpy)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5, atol=1e-6)
    for i, (x, g) in enumerate(zip(xs, want_grads)):
        assert x.grad is not None and torch.isfinite(x.grad).all(), (case, i)
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(g), rtol=1e-5, atol=1e-6,
                                   err_msg=f"{case}: gradient of input {i}")


@pytest.mark.parametrize("metric,squared", [("euclidean", False), ("euclidean", True),
                                            ("cosine", False)])
def test_pairwise_distances_match_jax(metric, squared):
    """The distance matrix and the gradient of a weighted sum of it: finite
    on the diagonal, where the euclidean distance is exactly 0 and the
    guard keeps sqrt's infinite derivative out."""
    weights = RNG.normal(size=(B, B)).astype(np.float32)
    kw = dict(metric=metric, squared=squared)
    want, want_grad = jax.value_and_grad(
        lambda e: jnp.sum(jl.pairwise_distances(e, **kw) * weights))(jnp.asarray(U))
    x = torch.tensor(U, requires_grad=True)
    d = pl.pairwise_distances(x, **kw)
    (d * torch.from_numpy(weights)).sum().backward()
    np.testing.assert_allclose(d.detach().numpy(), np.asarray(jl.pairwise_distances(
        jnp.asarray(U), **kw)), rtol=1e-5, atol=1e-6)
    if metric == "euclidean":
        assert (torch.diagonal(d) == 0).all()
    assert torch.isfinite(x.grad).all()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_grad), rtol=1e-5, atol=1e-6)


def test_mnrl_loss_dp_names_its_roadmap_item():
    """`mnrl_loss_dp` is ported (ROADMAP Queue 1 item 12;
    tests/test_torch_mesh_training.py holds it to JAX's shard_map): on two
    rows it is `mnrl_loss` of the whole batch, one copy a row."""
    g = torch.Generator().manual_seed(0)
    a, p, n = (torch.randn(4, 8, generator=g) for _ in range(3))
    rows = pl.mnrl_loss_dp([a[:2], a[2:]], [p[:2], p[2:]], [n[:2], n[2:]])
    assert len(rows) == 2 and torch.equal(rows[0], rows[1])
    assert abs(float(rows[0]) - float(pl.mnrl_loss(a, p, n))) <= 1e-6
