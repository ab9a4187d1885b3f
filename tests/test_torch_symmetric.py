"""The symmetric-search slice of SGPT-BE on the port against the JAX package.

Tiny GPT-Neo (2 layers, D 64), weights from the JAX `init_params` carried
over by `params_from_jax`, fp32 at matmul precision "highest", on the CPU
(K1's and K2's plain versions). Tolerances, stated per test:
  * the engine with `layeridx`, the stack poolers, learnt position weights,
    pre- and post-pool dense heads and `text_prefix` against the JAX
    `EmbeddingEngine`: embeddings within 1e-5 (abs and rel);
  * one trainer step with the learnt mean and dense heads under BitFit, the
    JAX trainer's aux carried over by `aux_from_jax`: loss within 1e-5
    relative, each bias and aux gradient within 1e-5 of its leaf's norm; a
    3-step run: losses within 1e-5 relative plus 1e-5 of the first, aux
    after it within 1e-4 (Adam's m/√v, as tests/test_torch_training.py);
  * `export_model` encodes as the JAX trainer's export, within 1e-5;
  * `SGPTModel` save/load, and `train_nli`'s best model reloaded (with the
    hash tokenizer, and with a named HF tokenizer), bit for bit;
  * `train_nli` against the JAX CLI: losses within 1e-5 relative plus 1e-5
    of the first, STS-B dev scores (Spearman, ranks) within 1e-6;
  * `useb_retriever` against the JAX CLI: USEB main scores (×100, rounded to
    2 decimals by both) within 0.01, one step of the rounding;
  * the best-model snapshot is a copy of the aux, not the live tensors.
"""
import gzip
import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
os.environ.setdefault("JAX_PLATFORMS", "cpu")
pytest.importorskip("jax").config.update("jax_platforms", "cpu")

import jax  # noqa: E402

import sgpt_tpu.training as jtraining  # noqa: E402
from sgpt_tpu.cli import train_nli as jax_train_nli  # noqa: E402
from sgpt_tpu.cli import useb_retriever as jax_useb  # noqa: E402
from sgpt_tpu.encoder import EmbeddingEngine as JaxEngine  # noqa: E402
from sgpt_tpu.losses import mnrl_loss as jax_mnrl_loss  # noqa: E402
from sgpt_tpu.models import init_params as jax_init_params  # noqa: E402
from sgpt_tpu.models import tiny as jax_tiny  # noqa: E402
from sgpt_tpu.tokenization import SimpleTokenizer  # noqa: E402
from sgpt_tpu.training import ContrastiveTrainer as JaxTrainer  # noqa: E402
from sgpt_tpu.training import TrainConfig as JaxTrainConfig  # noqa: E402
from sgpt_tpu_torch.cli import train_nli, useb_retriever  # noqa: E402
from sgpt_tpu_torch.encoder import EmbeddingEngine  # noqa: E402
from sgpt_tpu_torch.model import AsymModel, SGPTModel  # noqa: E402
from sgpt_tpu_torch.tokenization import SimpleTokenizer as PortTokenizer  # noqa: E402
from sgpt_tpu_torch.models import (Decoder, aux_from_jax, from_jax_config,  # noqa: E402
                                   params_from_jax)
from sgpt_tpu_torch.training import BIAS_NAMES, ContrastiveTrainer, TrainConfig  # noqa: E402
from sgpt_tpu_torch.training.trainer import aux_leaves  # noqa: E402

VOCAB = 512
JCFG = jax_tiny("neo", num_layers=2, hidden_size=64, num_heads=4, vocab_size=VOCAB)
JPARAMS = jax_init_params(JCFG, jax.random.key(0))
CFG = from_jax_config(JCFG)
D = CFG.hidden_size


def _model():
    model = Decoder(CFG, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, JPARAMS), CFG))
    return model


def _texts(n=13, seed=1):
    rng = np.random.default_rng(seed)
    return [" ".join(f"w{rng.integers(0, 300)}" for _ in range(m))
            for m in rng.integers(1, 50, n)]  # buckets 16, 32, 64


def _heads(rng, spec):
    """Dense heads from (in, out, bias, activation, location) rows, w in the
    JAX (in, out) layout."""
    out = []
    for n_in, n_out, bias, act, loc in spec:
        h = {"w": (0.2 * rng.normal(size=(n_in, n_out))).astype(np.float32),
             "activation": act, "location": loc}
        if bias:
            h["b"] = (0.1 * rng.normal(size=n_out)).astype(np.float32)
        out.append(h)
    return out


_RNG = np.random.default_rng(7)
ENGINE_CASES = {
    "layer0": dict(layeridx=0),
    "layer1": dict(layeridx=1, normalize_embeddings=True),
    "layerL": dict(layeridx=2, method="mean"),
    "meanmean": dict(method="meanmean"),
    "lasttokenmean": dict(method="lasttokenmean", normalize_embeddings=True),
    "max": dict(method="max", layeridx=1),
    "cls": dict(method="cls"),
    "learnt-weightedmean": dict(learned_weights=_RNG.random(64).astype(np.float32) + 0.5),
    "learned_weightedmean-layer1": dict(method="learned_weightedmean", layeridx=1,
                                        learned_weights=_RNG.random(64).astype(np.float32)),
    "post-heads": dict(dense_heads=_heads(_RNG, [(D, 32, True, "gelu", "post_pool"),
                                                 (32, 16, False, "tanh", "post_pool")])),
    "pre-and-post-heads": dict(layeridx=1, dense_heads=_heads(_RNG, [
        (16, 8, True, "identity", "post_pool"), (D, 16, True, "gelu", "pre_pool")])),
    "stack-post-head": dict(method="meanmean", dense_heads=_heads(
        _RNG, [(D, 8, True, "gelu", "post_pool")])),
    "text-prefix": dict(text_prefix="stsb sentence1: ", specb=True),
}


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_engine_matches_jax(case):
    """Embeddings within 1e-5 of the JAX engine's, the width in application
    order (the last post-pool head, else the last pre-pool one)."""
    kw = dict(batch_size=2, max_seq_len=64, **ENGINE_CASES[case])
    tok = SimpleTokenizer(VOCAB)
    texts = _texts()
    want = JaxEngine(JPARAMS, JCFG, tok, **kw).encode(texts)
    engine = EmbeddingEngine(_model(), CFG, tok, device="cpu", **kw)
    got = engine.encode(texts)
    assert got.shape == want.shape and engine.out_dim == want.shape[1]
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_engine_refuses_pre_pool_heads_under_a_stack_pooler():
    heads = _heads(np.random.default_rng(0), [(D, 8, True, "identity", "pre_pool")])
    tok = SimpleTokenizer(VOCAB)
    for engine, args in ((JaxEngine, (JPARAMS, JCFG, tok)), (EmbeddingEngine, (_model(), CFG, tok))):
        kw = {"device": "cpu"} if engine is EmbeddingEngine else {}
        with pytest.raises(ValueError, match="pre_pool"):
            engine(*args, method="lasttokenmean", dense_heads=heads, **kw)


def test_engine_cache_key_covers_the_new_settings(tmp_path):
    """Engines differing only in layeridx, prefix, heads or learnt weights
    write separate cache entries; the same settings hit the cache."""
    tok = SimpleTokenizer(VOCAB)
    model = _model()
    texts = _texts(5)
    heads = _heads(np.random.default_rng(1), [(D, 8, True, "gelu", "post_pool")])
    variants = [{}, {"layeridx": 1}, {"text_prefix": "p: "}, {"dense_heads": heads},
                {"dense_heads": [{**heads[0], "activation": "tanh"}]},
                {"learned_weights": np.full(64, 2.0, np.float32)}]
    outs = []
    for kw in variants:
        outs.append(EmbeddingEngine(model, CFG, tok, device="cpu", max_seq_len=64,
                                    cache_dir=str(tmp_path), **kw).encode(texts))
    assert len(list(tmp_path.glob("*.npy"))) == len(variants)
    again = EmbeddingEngine(model, CFG, tok, device="cpu", max_seq_len=64,
                            cache_dir=str(tmp_path), layeridx=1).encode(texts)
    np.testing.assert_array_equal(again, outs[1])
    assert len(list(tmp_path.glob("*.npy"))) == len(variants)


# ---------------------------------------------------------------------------
# training: learnt mean and dense heads

def _triplets(n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        a, b, c = rng.integers(0, 50, 3)
        out.append((f"topic{i % 8} word{a} word{b}", f"topic{i % 8} word{a} word{c}",
                    f"topic{(i + 3) % 8} other{c} other{b}"))
    return out


STEPS = 3
BATCHES = [_triplets(8 * STEPS)[8 * i: 8 * i + 8] for i in range(STEPS)]
HEADS = {
    "post": [dict(in_features=D, out_features=32, bias=True, activation="gelu",
                  location="post_pool")],
    "pre+post": [dict(in_features=D, out_features=D, bias=True, activation="gelu",
                      location="pre_pool"),
                 dict(in_features=D, out_features=16, bias=False, activation="tanh",
                      location="post_pool")],
}


def _pair(heads, **overrides):
    """The JAX and the port trainer on the same weights and aux (JAX's head
    draws carried over: the port draws its own from seed + 1)."""
    kw = dict(lr=1e-3, epochs=1, batch_size=8, max_seq_len=16, freeze_nonbias=True,
              pooling="learned_weightedmean", dense_heads=HEADS[heads], **overrides)
    tok = SimpleTokenizer(vocab_size=VOCAB)
    jt = JaxTrainer(JPARAMS, JCFG, tok, JaxTrainConfig(**kw))
    pt = ContrastiveTrainer(_model(), CFG, tok, TrainConfig(**kw))
    carried = aux_leaves(aux_from_jax(jax.tree.map(np.asarray, jt.aux)))
    live = aux_leaves(pt.aux)
    assert set(carried) == set(live)
    with torch.no_grad():
        for name, t in live.items():
            assert t.shape == carried[name].shape, name
            t.copy_(carried[name])
    return jt, pt


@pytest.mark.parametrize("heads", sorted(HEADS))
def test_first_step_with_aux_matches_jax(heads):
    """Loss within 1e-5 relative; each bias and aux gradient within 1e-5 of
    its leaf's norm; frozen weights get no gradient."""
    jt, pt = _pair(heads)
    encode = jt._encode_fn()
    towers = jt._prep_batch(BATCHES[0])
    loss, grads = jax.value_and_grad(lambda t: jax_mnrl_loss(
        *[encode(t, tw) for tw in towers], scale=20.0))({"model": jt.params, "aux": jt.aux})
    want = params_from_jax(jax.tree.map(np.asarray, grads["model"]), CFG)
    want_aux = aux_leaves(aux_from_jax(jax.tree.map(np.asarray, grads["aux"])))
    pt._opt, pt._sched = pt._build_optimizer(STEPS)
    got = float(pt._loss_and_grads(pt._prep_batch(BATCHES[0])))
    assert abs(got - float(loss)) <= 1e-5 * abs(float(loss))
    pairs = [(f"aux.{n}", t.grad, want_aux[n]) for n, t in aux_leaves(pt.aux).items()]
    for name, p in pt.model.named_parameters():
        if name.rsplit(".", 1)[-1] in BIAS_NAMES:
            pairs.append((name, p.grad, want[name]))
        else:
            assert p.grad is None and not p.requires_grad, name
    assert len(pairs) > len(aux_leaves(pt.aux))
    for name, g, w in pairs:
        w = w.numpy()
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5 * max(np.linalg.norm(w), 1e-12),
                                   rtol=0, err_msg=name)


def test_training_run_with_aux_matches_jax():
    """3 steps (warmuplinear, decay on the heads' w only): losses within
    1e-5 relative plus 1e-5 of the first, aux and biases after the run within
    1e-4; export_model encodes as the JAX export within 1e-5."""
    jt, pt = _pair("pre+post")
    want = jt.fit(lambda: iter(BATCHES), steps_per_epoch=STEPS)
    got = pt.fit(lambda: iter(BATCHES), steps_per_epoch=STEPS)
    wl = np.array([h["loss"] for h in want["history"]])
    gl = np.array([h["loss"] for h in got["history"]])
    np.testing.assert_allclose(gl, wl, rtol=1e-5, atol=1e-5 * wl[0])
    want_aux = aux_leaves(aux_from_jax(jax.tree.map(np.asarray, want["aux"])))
    for name, t in aux_leaves(got["aux"]).items():
        assert np.abs(t.detach().numpy() - want_aux[name].numpy()).max() <= 1e-4, name
    want_params = params_from_jax(jax.tree.map(np.asarray, want["params"]), CFG)
    for name, p in got["params"].items():
        assert np.abs(p.numpy() - want_params[name].numpy()).max() <= 1e-4, name
    texts = _texts(7, seed=3)
    np.testing.assert_allclose(pt.export_model().encode(texts),
                               jt.export_model().encode(texts), atol=1e-5, rtol=1e-5)


def test_best_aux_is_a_copy_not_the_live_tensors():
    """The first evaluation is the best (scores fall): after two more
    updates the live aux has moved, the snapshot kept the first evaluation's
    values, nested head lists included. Under BitFit the snapshot clones the
    trainable leaves and keeps the frozen ones as the live tensors."""
    pt = ContrastiveTrainer(_model(), CFG, SimpleTokenizer(VOCAB), TrainConfig(
        lr=1e-2, batch_size=8, max_seq_len=16, freeze_nonbias=True, eval_steps=1,
        scheduler="constantlr", pooling="learned_weightedmean", dense_heads=HEADS["pre+post"]))
    seen = []

    def evaluator(model, aux):
        seen.append({k: v.detach().clone() for k, v in aux_leaves(aux).items()})
        return -float(len(seen))

    out = pt.fit(lambda: iter(BATCHES), steps_per_epoch=STEPS, evaluator=evaluator)
    assert out["best_score"] == -1.0 and len(seen) == STEPS
    best, live = aux_leaves(out["best_aux"]), aux_leaves(pt.aux)
    assert out["best_aux"]["heads"] is not pt.aux["heads"]
    for name, t in live.items():
        assert best[name] is not t, name
        assert torch.equal(best[name], seen[0][name]), name
        assert not torch.equal(best[name], t.detach()), name
    live_params = dict(pt.model.named_parameters())
    for name, t in out["best_params"].items():
        shares = t.data_ptr() == live_params[name].data_ptr()
        assert shares == (not live_params[name].requires_grad), name


# ---------------------------------------------------------------------------
# SGPTModel

def test_sgpt_model_save_load_bit_for_bit(tmp_path):
    rng = np.random.default_rng(4)
    texts = _texts(9, seed=5)
    model = SGPTModel(_model(), CFG, PortTokenizer(VOCAB), method="weightedmean",
                      specb=True, layeridx=1, normalize=True, max_seq_len=64,
                      dense_heads=[{k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
                                    for k, v in h.items()} for h in _heads(rng, [
                                        (D, 16, True, "gelu", "pre_pool"),
                                        (16, 8, False, "tanh", "post_pool")])],
                      learned_weights=torch.rand(64), device="cpu")
    want = model.encode(texts)
    model.save(str(tmp_path / "m"))
    manifest = json.loads((tmp_path / "m" / "manifest.json").read_text())
    assert manifest["format"] == "sgpt_tpu_torch.v1" and manifest["cfg"]["dtype"] == "float32"
    loaded = SGPTModel.load(str(tmp_path / "m"), device="cpu")
    np.testing.assert_array_equal(loaded.encode(texts), want)
    np.testing.assert_array_equal(loaded.encode_queries(texts), model.encode_queries(texts))
    bf16 = SGPTModel(Decoder(CFG.replace(dtype=torch.bfloat16), device="cpu",
                             generator=torch.Generator().manual_seed(0)),
                     CFG.replace(dtype=torch.bfloat16), PortTokenizer(VOCAB), device="cpu")
    bf16.save(str(tmp_path / "b"))
    again = SGPTModel.load(str(tmp_path / "b"), device="cpu")
    assert again.cfg.dtype == torch.bfloat16
    np.testing.assert_array_equal(again.encode(texts), bf16.encode(texts))
    asym = AsymModel(model, bf16)
    asym.save(str(tmp_path / "a"))
    back = AsymModel.load(str(tmp_path / "a"), device="cpu")
    np.testing.assert_array_equal(back.encode(texts, is_query=True),
                                  model.encode(texts, is_query=True))
    np.testing.assert_array_equal(back.encode_corpus(texts), bf16.encode_corpus(texts))
    (tmp_path / "j").mkdir()
    (tmp_path / "j" / "manifest.json").write_text(json.dumps({"format": "sgpt_tpu.v1"}))
    with pytest.raises(ValueError, match="sgpt_tpu.v1"):
        SGPTModel.load(str(tmp_path / "j"), device="cpu")


# ---------------------------------------------------------------------------
# the CLIs against the JAX CLIs on local fixtures

def _jax_build(model_name, random_init=False, dtype_str="bfloat16"):
    # a fresh tree each call: `--quantize` quantizes it in place (free_source)
    return jax.tree.map(lambda a: a, JPARAMS), JCFG, SimpleTokenizer(vocab_size=VOCAB)


def _port_build(model_name, random_init=False, dtype_str="float32", device="cpu", seed=0):
    return _model(), CFG, PortTokenizer(vocab_size=VOCAB)


def _write_nli(tmp_path):
    rng = np.random.default_rng(2)
    with gzip.open(tmp_path / "AllNLI.tsv.gz", "wt") as f:
        f.write("split\tsentence1\tsentence2\tlabel\n")
        for i in range(40):
            words = " ".join(f"w{rng.integers(0, 60)}" for _ in range(int(rng.integers(3, 9))))
            f.write(f"train\tpremise {words}\tentailed {words} e{i}\tentailment\n")
            f.write(f"train\tpremise {words}\tcontra {i} c{rng.integers(0, 9)}\tcontradiction\n")
            f.write(f"train\tpremise {words}\tneutral {i}\tneutral\n")
    # no pair of identical sentences: their cosines would all round to about
    # 1, and rounding alone would decide their ranks in the Spearman score
    with gzip.open(tmp_path / "stsb.tsv.gz", "wt") as f:
        f.write("split\tsentence1\tsentence2\tscore\n")
        for i in range(16):
            a = " ".join(f"w{rng.integers(0, 60)}" for _ in range(5))
            b = " ".join(f"w{rng.integers(0, 60)}" for _ in range(int(rng.integers(2, 9))))
            f.write(f"{'dev' if i < 12 else 'test'}\t{a}\t{b}\t{(i * 7) % 5}.{i % 10}\n")


def test_train_nli_matches_jax_cli(tmp_path, monkeypatch):
    """`--learntmean --freezenonbias` (no heads: the two CLIs draw heads
    from different generators), STS-B dev evaluation every 10 % of the
    epoch: the same losses and dev scores; the best model reloads bit for
    bit."""
    _write_nli(tmp_path)
    flags = ["--model_name", "tiny", "--randominit", "--nli_path",
             str(tmp_path / "AllNLI.tsv.gz"), "--stsb_path", str(tmp_path / "stsb.tsv.gz"),
             "--train_batch_size", "8", "--max_seq_length", "16", "--lr", "1e-3",
             "--freezenonbias", "--learntmean"]
    runs = []

    class Recording(jtraining.ContrastiveTrainer):
        def fit(self, *a, **kw):
            runs.append(super().fit(*a, **kw))
            return runs[-1]

    monkeypatch.setattr(jtraining, "ContrastiveTrainer", Recording)
    monkeypatch.setattr(jax_train_nli, "build_model", _jax_build)
    monkeypatch.setattr(sys, "argv", ["x", *flags, "--model_save_path", str(tmp_path / "jax"),
                                      "--dp", "1", "--tp", "1"])
    jax_train_nli.main()
    monkeypatch.setattr(train_nli, "build_model", _port_build)
    out = train_nli.main(train_nli.parse_args(
        [*flags, "--model_save_path", str(tmp_path / "port"), "--device", "cpu"]))

    def split(history):
        return ([h["loss"] for h in history if "loss" in h],
                [h["eval_score"] for h in history if "eval_score" in h])

    (wl, ws), (gl, gs) = split(runs[0]["history"]), split(out["history"])
    assert len(gl) == len(wl) == 5 and len(gs) == len(ws) == 5
    np.testing.assert_allclose(gl, wl, rtol=1e-5, atol=1e-5 * wl[0])
    np.testing.assert_allclose(gs, ws, atol=1e-6)
    assert out["best_score"] == pytest.approx(runs[0]["best_score"], abs=1e-6)
    texts = _texts(6, seed=9)
    loaded = SGPTModel.load(str(tmp_path / "port" / "best_model"), device="cpu")
    assert loaded.method == "learned_weightedmean" and loaded.max_seq_len == 16
    np.testing.assert_array_equal(loaded.encode(texts), out["model"].encode(texts))


def test_train_nli_heads_and_outfeats(tmp_path, monkeypatch):
    """`--addxlinear 2 --linearthenpool --useact` trains two pre-pool GELU
    heads without bias under BitFit (the JAX rules); `--outfeats` with more
    than one head raises before anything is built; `--outfeats 16` with one
    head exports a 16-wide model."""
    _write_nli(tmp_path)
    monkeypatch.setattr(train_nli, "build_model", _port_build)
    base = ["--randominit", "--nli_path", str(tmp_path / "AllNLI.tsv.gz"),
            "--train_batch_size", "8", "--max_seq_length", "16", "--freezenonbias",
            "--device", "cpu"]
    out = train_nli.main(train_nli.parse_args(
        [*base, "--addxlinear", "2", "--linearthenpool", "--useact",
         "--model_save_path", str(tmp_path / "a")]))
    heads = out["model"].dense_heads
    assert [(h["location"], h["activation"], h.get("b")) for h in heads] == \
        [("pre_pool", "gelu", None)] * 2
    with pytest.raises(ValueError, match="exactly one"):
        train_nli.main(train_nli.parse_args([*base, "--addxlinear", "2", "--outfeats", "8"]))
    out = train_nli.main(train_nli.parse_args(
        [*base, "--addxlinear", "1", "--outfeats", "16", "--model_save_path",
         str(tmp_path / "b")]))
    emb = SGPTModel.load(str(tmp_path / "b" / "best_model"), device="cpu").encode(["a b c"])
    assert emb.shape == (1, 16)


def _hf_tokenizer_dir(path):
    """A local HF tokenizer (word level, 512 ids at most) over the words of
    `_write_nli`'s and `_texts`' fixtures."""
    from tokenizers import Tokenizer as RustTokenizer
    from tokenizers import models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast

    words = ["<unk>", "<|endoftext|>", "[", "]", "{", "}", ".", "premise", "entailed",
             "contra", "neutral", *(f"w{i}" for i in range(300)), *(f"e{i}" for i in range(40)),
             *(f"c{i}" for i in range(9)), *(str(i) for i in range(40))]
    rust = RustTokenizer(models.WordLevel({w: i for i, w in enumerate(words)}, unk_token="<unk>"))
    rust.pre_tokenizer = pre_tokenizers.Whitespace()
    PreTrainedTokenizerFast(tokenizer_object=rust, unk_token="<unk>",
                            eos_token="<|endoftext|>").save_pretrained(str(path))
    return str(path)


def test_train_nli_best_model_names_its_tokenizer(tmp_path, monkeypatch):
    """A checkpoint with its own HF tokenizer (no `--randominit`): the best
    model's manifest names that tokenizer, and `SGPTModel.load` reads it
    back (not the hash tokenizer), so the reloaded model embeds bit for bit
    as the trained one. An `SGPTModel` with an HF tokenizer and no name
    refuses to save; a manifest that records no tokenizer refuses to load."""
    from sgpt_tpu_torch.tokenization import HFTokenizer, get_tokenizer

    _write_nli(tmp_path)
    ckpt = _hf_tokenizer_dir(tmp_path / "ckpt")
    monkeypatch.setattr(train_nli, "build_model", lambda name, **kw: (
        _model(), CFG, get_tokenizer(name, fallback=False)))
    out = train_nli.main(train_nli.parse_args(
        ["--model_name", ckpt, "--nli_path", str(tmp_path / "AllNLI.tsv.gz"),
         "--stsb_path", str(tmp_path / "stsb.tsv.gz"), "--train_batch_size", "8",
         "--max_seq_length", "16", "--freezenonbias", "--device", "cpu",
         "--model_save_path", str(tmp_path / "out")]))
    saved = tmp_path / "out" / "best_model"
    manifest = json.loads((saved / "manifest.json").read_text())
    assert manifest["tokenizer_name"] == ckpt and manifest["hash_tokenizer_vocab"] is None
    loaded = SGPTModel.load(str(saved), device="cpu")
    assert isinstance(loaded.tokenizer, HFTokenizer)
    texts = _texts(6, seed=9)
    np.testing.assert_array_equal(loaded.encode(texts), out["model"].encode(texts))
    unnamed = SGPTModel(_model(), CFG, loaded.tokenizer, device="cpu")
    with pytest.raises(ValueError, match="tokenizer_name"):
        unnamed.save(str(tmp_path / "unnamed"))
    manifest["tokenizer_name"] = None
    (saved / "manifest.json").write_text(json.dumps(manifest))
    with pytest.raises(ValueError, match="names no tokenizer"):
        SGPTModel.load(str(saved), device="cpu")


def _write_useb(root, rng, n=18):
    """The four USEB tasks in the formats of tests/test_useb.py's fixtures."""
    def text():
        return " ".join(f"w{rng.integers(0, 40)}" for _ in range(int(rng.integers(2, 12))))

    d = root / "askubuntu"
    d.mkdir(parents=True)
    (d / "text_tokenized.txt").write_text("".join(f"q{i}\t{text()}\t{text()}\n"
                                                  for i in range(n)))
    rows = []
    for i in range(n // 3):
        cands = rng.choice(n, 6, replace=False)
        rows.append(f"q{i}\tq{cands[0]} q{cands[1]}\t{' '.join(f'q{c}' for c in cands)}\t"
                    + " ".join(f"{x:.2f}" for x in rng.random(6)) + "\n")
    (d / "test.txt").write_text("".join(rows))
    (d / "dev.txt").write_text("".join(rows))
    d = root / "cqadupstack"
    d.mkdir()
    corpus = {f: {f"d{i}": text() for i in range(n)} for f in ("android", "gis")}
    split = {s: {f: {f"d{i}": [f"d{i + 1}", f"d{i + 3}"] for i in range(0, n - 3, 4)}
                 for f in corpus} for s in ("test", "valid")}
    (d / "corpus.json").write_text(json.dumps(corpus))
    (d / "retrieval_split.json").write_text(json.dumps(split))
    d = root / "twitterpara"
    d.mkdir()
    (d / "Twitter_URL_Corpus_test.txt").write_text("".join(
        f"{text()}\t{text()}\t({rng.integers(0, 7)}, 6)\n" for _ in range(n)))
    (d / "test.data").write_text("".join(
        f"id\ttopic\t{text()}\t{text()}\t{rng.integers(0, 6)}\n" for _ in range(n)))
    d = root / "scidocs"
    d.mkdir()
    data = {"corpus": {f"p{i}": {"title": None if i == 3 else text()} for i in range(n)}}
    for s in ("test", "valid"):
        data[s] = {task: {f"p{q}": {f"p{c}": int(rng.integers(0, 2))
                                    for c in rng.choice(n, 5, replace=False)}
                          for q in range(0, n, 6)}
                   for task in ("cite", "cocite", "coview", "coread")}
    (d / "data.json").write_text(json.dumps(data))


@pytest.mark.parametrize("flags", [["--layeridx", "1"], ["--method", "meanmean", "--specb"],
                                   ["--method", "lasttokenmean", "--evaltype", "valid"],
                                   ["--quantize", "int8"]])
def test_useb_retriever_matches_jax_cli(tmp_path, monkeypatch, flags):
    """The four tasks' main scores (×100, 2 decimals on both sides) within
    0.01 of the JAX CLI's, and the same JSON keys."""
    _write_useb(tmp_path / "data", np.random.default_rng(11))
    common = ["--modelname", "tiny", "--randominit", "--dtype", "float32", "--maxseqlen",
              "32", "--batchsize", "4", "--datapath", str(tmp_path / "data"), *flags]
    monkeypatch.setattr(jax_useb, "build_model", _jax_build)
    monkeypatch.setattr(sys, "argv", ["x", *common, "--output", str(tmp_path / "j.json")])
    jax_useb.main()
    monkeypatch.setattr(useb_retriever, "build_model", _port_build)
    useb_retriever.main(useb_retriever.parse_args(
        [*common, "--output", str(tmp_path / "p.json"), "--device", "cpu"]))
    want = json.loads((tmp_path / "j.json").read_text())
    got = json.loads((tmp_path / "p.json").read_text())
    assert {k: v for k, v in got.items() if k not in ("main", "detailed")} == \
        {k: v for k, v in want.items() if k not in ("main", "detailed")}
    assert list(got["main"]) == list(want["main"]) and len(want["main"]) == 5
    np.testing.assert_allclose([got["main"][k] for k in want["main"]],
                               list(want["main"].values()), atol=0.01 + 1e-9)
    for task, res in want["detailed"].items():
        assert list(got["detailed"][task]) == list(res), task


@pytest.mark.parametrize("flags,match", [(["--download"], "zero-egress")])
def test_useb_retriever_refuses_what_is_not_ported(tmp_path, monkeypatch, flags, match):
    """`--download` with no `--datapath` folder and no reachable archive
    (a closed local port) raises the download helper's error, as the JAX
    CLI does, and leaves no partial file behind."""
    from sgpt_tpu_torch.baselines import openai_client

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(openai_client, "USEB_DATA_URL", "http://127.0.0.1:9")
    with pytest.raises(RuntimeError, match=match):
        useb_retriever.main(useb_retriever.parse_args(
            ["--randominit", "--datapath", str(tmp_path / "missing"), *flags]))
    assert os.listdir(tmp_path) == []
