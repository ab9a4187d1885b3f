"""TSDAE in the port == the JAX package's.

Both sides start from the same weights: the JAX `init_params` and
`init_tsdae_params`, carried over by `params_from_jax` and `tsdae_from_jax`,
on `tiny(num_layers=2, hidden_size=32, num_heads=2, vocab_size=256)` in fp32
at matmul precision "highest". Checked:
  * the conditioned decoder forward (GPT-Neo's pre-LN block and GPT-J's
    parallel residual) against JAX's `forward(cond=, cond_params=)`, within
    1e-5 (fp32 summation order); with a zero projection, the unconditioned
    forward bit for bit;
  * 3 `TSDAETrainer` steps (lr 1e-3, max_seq_len 16, batches of 4 pairs from
    `DenoisingBatcher`), full and `freeze_nonbias`: losses within 1e-5
    relative plus 1e-5 of the first loss, parameters and projections within
    1e-4 after the run (the standing floors of tests/test_torch_training.py),
    and under BitFit only the biases and the projections move;
  * `cli.train_tsdae` on a tmp sentence file, with `build_model` patched to
    the tiny model: its checkpoint holds the trained tree.
"""
import os
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
os.environ.setdefault("JAX_PLATFORMS", "cpu")
pytest.importorskip("jax").config.update("jax_platforms", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sgpt_tpu.models import init_params as jax_init_params  # noqa: E402
from sgpt_tpu.models import tiny as jax_tiny  # noqa: E402
from sgpt_tpu.models.decoder import forward as jax_forward  # noqa: E402
from sgpt_tpu.tokenization import SimpleTokenizer as JaxTokenizer  # noqa: E402
from sgpt_tpu.training import TSDAETrainer as JaxTSDAETrainer  # noqa: E402
from sgpt_tpu.training import init_tsdae_params as jax_init_tsdae  # noqa: E402
from sgpt_tpu_torch.data import DenoisingBatcher  # noqa: E402
from sgpt_tpu_torch.models import (Decoder, from_jax_config, params_from_jax,  # noqa: E402
                                   tsdae_from_jax)
from sgpt_tpu_torch.tokenization import SimpleTokenizer  # noqa: E402
from sgpt_tpu_torch.training import BIAS_NAMES, TSDAETrainer  # noqa: E402

VOCAB = 256
KW = dict(num_layers=2, hidden_size=32, num_heads=2, vocab_size=VOCAB)


def _models(family="neo"):
    jcfg = jax_tiny(family, **KW)
    jparams = jax_init_params(jcfg, jax.random.key(0))
    cfg = from_jax_config(jcfg)
    model = Decoder(cfg, device="cpu",
                    weights=params_from_jax(jax.tree.map(np.asarray, jparams), cfg))
    return jcfg, jparams, cfg, model


@pytest.mark.parametrize("family", ["neo", "gptj"])
def test_cond_forward_matches_jax(family):
    jcfg, jparams, cfg, model = _models(family)
    rng = np.random.default_rng(1)
    ids = rng.integers(0, VOCAB, (3, 12)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, 7:] = 0
    rep = rng.normal(size=(3, 32)).astype(np.float32)
    cp = jax_init_tsdae(jcfg, jax.random.key(1))
    cp = {"w": cp["w"], "b": jnp.asarray(rng.normal(size=(2, 32)).astype(np.float32))}
    want = np.asarray(jax_forward(jparams, jnp.asarray(ids), jnp.asarray(mask), jcfg,
                                  cond=jnp.asarray(rep), cond_params=cp))
    t_ids, t_mask = torch.from_numpy(ids).long(), torch.from_numpy(mask)
    with torch.no_grad():
        got = model(t_ids, t_mask, cond=torch.from_numpy(rep),
                    cond_params=tsdae_from_jax(jax.tree.map(np.asarray, cp))).numpy()
        plain = model(t_ids, t_mask).numpy()
        zero = model(t_ids, t_mask, cond=torch.from_numpy(rep),
                     cond_params={"w": torch.zeros(2, 32, 32), "b": torch.zeros(2, 32)}).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    assert np.abs(got - plain).max() > 1e-3  # the conditioning changes the output
    np.testing.assert_array_equal(zero, plain)
    with pytest.raises(ValueError, match="cond_params"):
        model(t_ids, t_mask, cond=torch.from_numpy(rep))


def _batches(n_batches=3, size=4):
    sentences = [f"the quick brown animal number {i} jumps over fence {i % 3} twice"
                 for i in range(n_batches * size)]
    return [[ex.texts for ex in b] for b in DenoisingBatcher(sentences, size, seed=0)]


@pytest.mark.parametrize("freeze", [False, True])
def test_tsdae_steps_match_jax(freeze):
    jcfg, jparams, cfg, model = _models()
    batches = _batches()
    kw = dict(max_seq_len=16, lr=1e-3, freeze_nonbias=freeze, seed=0)
    jt = JaxTSDAETrainer(jparams, jcfg, JaxTokenizer(vocab_size=VOCAB), **kw)
    pt = TSDAETrainer(model, cfg, SimpleTokenizer(vocab_size=VOCAB), **kw)
    carried = tsdae_from_jax(jax.tree.map(np.asarray, jt.tree["tsdae"]))
    with torch.no_grad():  # in place: the optimizer holds these tensors
        for k, t in pt.tsdae.items():
            t.copy_(carried[k])
    before = {k: v.clone() for k, v in model.state_dict().items()}
    want = jt.fit(batches)
    got = pt.fit(batches)
    wl = np.array([h["loss"] for h in want])
    gl = np.array([h["loss"] for h in got])
    assert len(gl) == len(wl) == 3
    np.testing.assert_allclose(gl, wl, rtol=1e-5, atol=1e-5 * wl[0])
    want_params = params_from_jax(jax.tree.map(np.asarray, jt.params), cfg)
    for name, p in pt.params.items():
        assert np.abs(p.numpy() - want_params[name].numpy()).max() <= 1e-4, name
        moved = not torch.equal(p, before[name])
        assert moved == (not freeze or name.rsplit(".", 1)[-1] in BIAS_NAMES), name
    want_cp = tsdae_from_jax(jax.tree.map(np.asarray, jt.tree["tsdae"]))
    for k in ("w", "b"):
        assert np.abs(pt.tsdae[k].detach().numpy() - want_cp[k].numpy()).max() <= 1e-4, k
        assert not torch.equal(pt.tsdae[k].detach(), carried[k]), k


def test_fit_materialises_a_one_shot_iterator_for_several_epochs():
    _, _, cfg, model = _models()
    pt = TSDAETrainer(model, cfg, SimpleTokenizer(vocab_size=VOCAB), max_seq_len=16)
    assert len(pt.fit(iter(_batches(2)), epochs=2)) == 4
    with pytest.raises(ValueError, match="'dp' axis"):  # sp TSDAE: test_torch_ring_attention.py
        TSDAETrainer(model, cfg, SimpleTokenizer(vocab_size=VOCAB),
                     sp_mesh=types.SimpleNamespace(shape={"tp": 2}))


def test_train_tsdae_cli(tmp_path, monkeypatch):
    from sgpt_tpu_torch.cli import train_tsdae
    from sgpt_tpu_torch.training import load_checkpoint

    def fake_build(model_name, random_init=False, dtype_str="float32", device="cuda",
                   seed=0):
        assert (random_init, dtype_str, device) == (True, "float32", "cpu")
        _, _, cfg, model = _models()
        return model, cfg, SimpleTokenizer(vocab_size=VOCAB)

    monkeypatch.setattr(train_tsdae, "build_model", fake_build)
    path = tmp_path / "sents.txt"
    path.write_text("\n".join(f"many different words in line {i}" for i in range(8)) + "\n\n")
    out = tmp_path / "out"
    res = train_tsdae.main(train_tsdae.parse_args([
        "--model_name", "tiny", "--randominit", "--sentences_path", str(path),
        "--train_batch_size", "4", "--max_seq_length", "16", "--num_epochs", "2",
        "--lr", "1e-3", "--freezenonbias", "--model_save_path", str(out), "--device", "cpu"]))
    assert len(res["history"]) == 4 and all(np.isfinite(h["loss"]) for h in res["history"])
    tree = load_checkpoint(str(out))
    assert set(tree) == {"model", "tsdae"}
    for name, t in res["trainer"].tree["model"].items():
        assert torch.equal(tree["model"][name], t), name
    assert torch.equal(tree["tsdae"]["w"], res["trainer"].tsdae["w"].detach())
    with pytest.raises(SystemExit, match="at least"):
        train_tsdae.main(train_tsdae.parse_args([
            "--randominit", "--sentences_path", str(path), "--train_batch_size", "64",
            "--device", "cpu"]))
