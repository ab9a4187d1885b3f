"""The port's small training modules == their JAX counterparts.

Schedules (every step 0..N against optax), the BitFit mask, the MNRL loss
and the similarity functions, and the torch-native checkpoint format (bf16
bit for bit, retention). Inputs from numpy seeds; fp32.
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

from sgpt_tpu import losses as jax_losses  # noqa: E402
from sgpt_tpu.models import init_params as jax_init_params  # noqa: E402
from sgpt_tpu.models import tiny as jax_tiny  # noqa: E402
from sgpt_tpu.ops import similarity as jax_sim  # noqa: E402
from sgpt_tpu.training import bitfit as jax_bitfit  # noqa: E402
from sgpt_tpu.training.schedules import make_schedule as jax_make_schedule  # noqa: E402
from sgpt_tpu_torch import losses  # noqa: E402
from sgpt_tpu_torch.models import Decoder, from_jax_config, tiny  # noqa: E402
from sgpt_tpu_torch.ops import similarity  # noqa: E402
from sgpt_tpu_torch.training import (bitfit_mask, chunk_tree, load_checkpoint,  # noqa: E402
                                     make_schedule, prune_checkpoints, save_checkpoint,
                                     trainable_count)

SCHEDULES = ["constantlr", "warmupconstant", "warmuplinear", "warmupcosine",
             "warmupcosinewithhardrestarts"]


@pytest.mark.parametrize("name", SCHEDULES)
@pytest.mark.parametrize("warmup,total", [(0, 1), (1, 10), (3, 30), (10, 100)])
def test_schedule_matches_optax_at_every_step(name, warmup, total):
    try:
        want = jax_make_schedule(name, 2e-4, warmup, total)
    except ValueError:  # warmupcosine at warmup 0, total 1: no decay step left
        with pytest.raises(ValueError):
            make_schedule(name, 2e-4, warmup, total)
        return
    got = make_schedule(name, 2e-4, warmup, total)
    steps = range(total + 5)  # past the horizon too
    np.testing.assert_allclose([got(s) for s in steps],
                               [float(want(jnp.asarray(s))) for s in steps],
                               rtol=1e-6, atol=1e-6 * 2e-4)  # optax evaluates in fp32


def test_warmuplinear_first_step_is_zero():
    assert make_schedule("warmuplinear", 1e-3, 2, 20)(0) == 0.0


@pytest.mark.parametrize("train_wte", [False, True])
def test_bitfit_mask_selects_the_jax_leaves(train_wte):
    jcfg = jax_tiny("neo", num_layers=2, hidden_size=32, num_heads=2, vocab_size=64)
    jmask = jax_bitfit.bitfit_mask(jax_init_params(jcfg, jax.random.key(0)),
                                   train_wte=train_wte)
    flat = {".".join(str(k.key) for k in path): bool(v)
            for path, v in jax.tree_util.tree_flatten_with_path(jmask)[0]}
    model = Decoder(from_jax_config(jcfg), device="cpu")
    mask = bitfit_mask(model, train_wte=train_wte)
    assert set(mask) == {n for n, _ in model.named_parameters()}
    for name, trainable in mask.items():
        parts = name.split(".")
        jname = ".".join(parts[:1] + parts[2:]) if parts[0] == "layers" else name
        assert trainable == flat[jname], name
    want = sum(p.numel() for n, p in model.named_parameters() if mask[n])
    assert trainable_count(model, train_wte=train_wte) == want
    extra = bitfit_mask(model, extra_trainable=lambda keys: keys[-1] == "wpe")
    assert extra["wpe"] and not extra["wte"]


def _embeddings(seed, n=6, d=16):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(n, d)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("similarity_name", ["cos_sim", "dot"])
@pytest.mark.parametrize("with_negatives", [False, True])
def test_mnrl_loss_matches_jax(similarity_name, with_negatives):
    a, p, n = _embeddings(3)
    reps = [a, p] + ([n] if with_negatives else [])
    want = jax_losses.mnrl_loss(*map(jnp.asarray, reps), scale=20.0,
                                similarity=similarity_name)
    got = losses.mnrl_loss(*map(torch.from_numpy, reps), scale=20.0,
                           similarity=similarity_name)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("fn", ["dot_score", "cos_sim", "pairwise_cos_sim"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_similarity_matches_jax(fn, dtype):
    a, b, _ = _embeddings(4)
    got = getattr(similarity, fn)(*(torch.from_numpy(x).to(getattr(torch, dtype))
                                    for x in (a, b)))
    want = getattr(jax_sim, fn)(*(jnp.asarray(x).astype(dtype) for x in (a, b)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_chunk_tree_reshapes_every_leaf():
    tree = {"ids": torch.arange(24).reshape(8, 3), "mask": np.ones((8, 3), np.int32)}
    out = chunk_tree(tree, 4)
    assert out["ids"].shape == (2, 4, 3) and out["mask"].shape == (2, 4, 3)
    assert torch.equal(out["ids"][1, 0], tree["ids"][4])
    with pytest.raises(ValueError, match="not divisible"):
        chunk_tree(tree, 3)


def test_checkpoint_round_trips_bf16_bit_for_bit(tmp_path):
    model = Decoder(tiny("neo", num_layers=1, hidden_size=32, num_heads=2,
                         vocab_size=64).replace(dtype=torch.bfloat16),
                    device="cpu", generator=torch.Generator().manual_seed(1))
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3)
    sum(p.float().sum() for p in model.parameters()).backward()
    opt.step()
    path = str(tmp_path / "ck")
    save_checkpoint(path, {"model": model.state_dict(), "aux": {}},
                    opt_state=opt.state_dict(), step=7)
    assert json.load(open(os.path.join(path, "meta.json")))["step"] == 7
    tree = load_checkpoint(path)
    for name, t in model.state_dict().items():
        got = tree["model"][name]
        assert got.dtype == torch.bfloat16
        assert torch.equal(got.view(torch.int16), t.view(torch.int16)), name
    state = torch.load(os.path.join(path, "opt_state.pt"), weights_only=True)
    assert state["state"][0]["exp_avg"].dtype == torch.bfloat16
    fresh = torch.optim.AdamW(model.parameters(), lr=1e-3)
    fresh.load_state_dict(state)


def test_load_refuses_a_jax_checkpoint(tmp_path):
    (tmp_path / "meta.json").write_text(json.dumps({"step": 1, "backend": "npz"}))
    with pytest.raises(ValueError, match="JAX"):
        load_checkpoint(str(tmp_path))


def test_retention_keeps_the_newest(tmp_path):
    for step in (3, 10, 7, 1):
        save_checkpoint(str(tmp_path / str(step)), {"x": torch.zeros(1)}, step=step)
    (tmp_path / "best").mkdir()
    prune_checkpoints(str(tmp_path), 2)
    assert sorted(os.listdir(tmp_path)) == ["10", "7", "best"]
