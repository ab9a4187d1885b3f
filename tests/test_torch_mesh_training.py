"""The port's training under a (dp, tp) mesh == the JAX package's single-device
training, on the CPU.

The port's meshes are `["cpu"] * n` device lists (one process drives every
shard); the JAX side is the single-device `ContrastiveTrainer` of
tests/test_trainer_mesh.py (whose own mesh fits, 220 s, stay out of tier-1),
from the same weights (`params_from_jax`), and, for `mnrl_loss_dp`, JAX's
shard_map on the forced 8-device CPU mesh (tests/conftest.py).

  * the collectives' gradients on a repeated device (a device holding
    several shards passes the sum of their gradients on once), and
    `sum_grads` (one gradient for every copy of a leaf, the same bits);
  * `shard_params` → `unshard_params` (and the sharded model's
    `state_dict`/`load_state_dict`) bit for bit, float and int8, for
    inference and trainable shards;
  * `ContrastiveTrainer(mesh=)` at (dp, tp) = (8, 1), (4, 2), (2, 4) (H=2:
    tp=4 takes JAX's gathered-attention fallback), and BitFit + GradCache at
    (4, 2): losses within rtol 2e-4 and parameters within rtol 3e-3, atol
    2e-5 of JAX's single-device fit (tests/test_trainer_mesh.py's
    tolerances); every copy of a leaf bit-equal after the fit; the ragged
    tail trimmed to dp; a chunk size that dp does not divide refused;
  * `mnrl_loss_dp` against JAX's under shard_map and `mnrl_loss` on the
    whole batch: value within 1e-6 relative, gradients within 1e-5 of
    their largest element (fp32; dot scores × 20 reach ~10^2);
  * the mesh trainer's save → restore (sharded again, in place), its
    evaluator (handed the live sharded decoder) and its best-model snapshot
    (the trainable leaves only);
  * `train_msmarco` and `train_nli` with `--dp 2 --tp 2 --device
    cpu,cpu,cpu,cpu` against their meshless runs.
"""
import functools
import gzip
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
os.environ.setdefault("JAX_PLATFORMS", "cpu")
pytest.importorskip("jax").config.update("jax_platforms", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh as JaxMesh  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from sgpt_tpu.losses import mnrl_loss_dp as jax_mnrl_loss_dp  # noqa: E402
from sgpt_tpu.models import init_params as jax_init_params  # noqa: E402
from sgpt_tpu.models import tiny as jax_tiny  # noqa: E402
from sgpt_tpu.tokenization import SimpleTokenizer  # noqa: E402
from sgpt_tpu.training import ContrastiveTrainer as JaxTrainer  # noqa: E402
from sgpt_tpu.training import TrainConfig as JaxTrainConfig  # noqa: E402
from sgpt_tpu_torch.cli import train_msmarco, train_nli  # noqa: E402
from sgpt_tpu_torch.encoder import EmbeddingEngine  # noqa: E402
from sgpt_tpu_torch.losses import mnrl_loss, mnrl_loss_dp  # noqa: E402
from sgpt_tpu_torch.models import Decoder, from_jax_config, params_from_jax, tiny  # noqa: E402
from sgpt_tpu_torch.ops import quant as pq  # noqa: E402
from sgpt_tpu_torch.parallel import (ShardedDecoder, all_gather, all_reduce_sum,  # noqa: E402
                                     make_mesh, shard_params, sum_grads, unshard_params)
from sgpt_tpu_torch.parallel.collectives import gather_to, reduce_sum_to  # noqa: E402
from sgpt_tpu_torch.training import BIAS_NAMES, ContrastiveTrainer, TrainConfig  # noqa: E402

VOCAB = 256
# tests/test_trainer_mesh.py's batches: 3 steps of 8 triplets
BATCHES = [
    [("anchor one text", "positive one body", "negative one body"),
     ("anchor two text", "positive two body", "negative two body"),
     ("anchor three text", "positive three body", "negative three body"),
     ("anchor four text", "positive four body", "negative four body"),
     ("anchor five text", "positive five body", "negative five body"),
     ("anchor six text", "positive six body", "negative six body"),
     ("anchor seven text", "positive seven body", "negative seven body"),
     ("anchor eight text", "positive eight body", "negative eight body")],
] * 3
LOSS_RTOL = 2e-4                     # tests/test_trainer_mesh.py
PARAM_RTOL, PARAM_ATOL = 3e-3, 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: beside the other test processes on the host's
    cores, a pool of threads makes many small operations wait."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cpus(n):
    return ["cpu"] * n


# -- the collectives' gradients and sum_grads ----------------------------------

def _parts(n=3, shape=(2, 4), seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=g).requires_grad_() for _ in range(n)]


def test_all_reduce_sum_gradient_on_a_repeated_device():
    """Every shard's result is the one sum (computed once on the device);
    d/dp_i Σ_j <w_j, out_j> = Σ_j w_j, passed on once."""
    parts, ws = _parts(), _parts(seed=1)
    outs = all_reduce_sum(parts)
    assert all(o is outs[0] for o in outs)
    sum(((o * w.detach()).sum() for o, w in zip(outs, ws))).backward()
    want = sum(w.detach() for w in ws)
    for p in parts:
        torch.testing.assert_close(p.grad, want, rtol=0, atol=1e-6)


def test_all_gather_gradient_on_a_repeated_device():
    """The backward of a gather hands each part its slice, summed over the
    shards that read the gathered tensor."""
    parts = _parts()
    ws = [w.detach() for w in _parts(shape=(2, 12), seed=2)]
    outs = all_gather(parts, dim=-1)
    sum((o * w).sum() for o, w in zip(outs, ws)).backward()
    total = sum(ws)
    for i, p in enumerate(parts):
        torch.testing.assert_close(p.grad, total[:, 4 * i:4 * (i + 1)], rtol=0, atol=1e-6)


def test_gather_to_and_reduce_sum_to_gradients():
    parts, w = _parts(), torch.randn(2, 12)
    (gather_to(parts, "cpu", dim=-1) * w).sum().backward()
    for i, p in enumerate(parts):
        assert torch.equal(p.grad, w[:, 4 * i:4 * (i + 1)])
    parts, w = _parts(), torch.randn(2, 4)
    (reduce_sum_to(parts, "cpu") * w).sum().backward()
    for p in parts:
        assert torch.equal(p.grad, w)


def test_sum_grads_gives_every_copy_the_sum_in_shard_order():
    """Copies without a gradient count as zero; each copy gets its own
    tensor with the same bits; no gradient at all leaves None."""
    copies = [torch.zeros(5, requires_grad=True) for _ in range(4)]
    g = torch.Generator().manual_seed(3)
    grads = [torch.randn(5, generator=g), None, torch.randn(5, generator=g) * 1e-7,
             torch.randn(5, generator=g) * 1e7]
    for c, gr in zip(copies, grads):
        c.grad = None if gr is None else gr.clone()
    sum_grads(copies)
    want = (grads[0] + grads[2]) + grads[3]
    for c in copies:
        assert torch.equal(c.grad, want)
    assert len({id(c.grad) for c in copies}) == 4
    empty = [torch.zeros(2, requires_grad=True) for _ in range(2)]
    sum_grads(empty)
    assert all(c.grad is None for c in empty)


# -- shard → unshard ------------------------------------------------------------

@pytest.mark.parametrize("family", ["neo", "gptj", "bloom"])
@pytest.mark.parametrize("dp,tp", [(1, 2), (2, 2), (1, 4)])
def test_shard_unshard_round_trip_bit_for_bit(family, dp, tp):
    cfg = tiny(family, num_layers=2, hidden_size=64, num_heads=4, vocab_size=128)
    model = Decoder(cfg, device="cpu", generator=torch.Generator().manual_seed(0),
                    lm_head=("w", "b") if family == "gptj" else ())
    want = model.state_dict()
    mesh = make_mesh(dp=dp, tp=tp, devices=_cpus(dp * tp))
    for trainable in (False, True):
        sharded = shard_params(model, mesh, trainable=trainable)
        back = unshard_params(sharded, device="cpu").state_dict()
        assert set(back) == set(want)
        for name, t in want.items():
            assert torch.equal(back[name], t), (family, trainable, name)
        shard = sharded.groups[dp - 1].shards[tp - 1]
        assert all(p.requires_grad == trainable for p in shard.parameters())
    # trainable pieces own their storage; load_state_dict cuts a tree in place
    ptrs = {p.data_ptr() for g in sharded.groups for s in g.shards for p in s.parameters()}
    assert not ptrs & {p.data_ptr() for p in model.parameters()}
    zeroed = {k: torch.zeros_like(v) for k, v in want.items()}
    live = [p for g in sharded.groups for s in g.shards for p in s.parameters()]
    sharded.load_state_dict(zeroed)
    assert all(p.abs().max() == 0 for p in live)
    sharded.load_state_dict(want)
    assert all(torch.equal(v, want[k]) for k, v in sharded.state_dict().items())


def test_shard_unshard_round_trip_int8():
    cfg = tiny("neo", num_layers=2, hidden_size=64, num_heads=4, vocab_size=128)
    model = pq.quantize_decoder_params(
        Decoder(cfg, device="cpu", generator=torch.Generator().manual_seed(1)))
    back = unshard_params(shard_params(model, make_mesh(dp=2, tp=2, devices=_cpus(4))))
    for name, t in model.state_dict().items():
        assert torch.equal(back.state_dict()[name], t), name


# -- the mesh fit against JAX's single-device fit ---------------------------------

def _configs(num_layers=2):
    jcfg = jax_tiny("neo", num_layers=num_layers, hidden_size=32, num_heads=2,
                    vocab_size=VOCAB)
    return jcfg, jax_init_params(jcfg, jax.random.key(0))


@functools.lru_cache(maxsize=None)
def _jax_fit(gradcache_bitfit: bool):
    """JAX's single-device fit of tests/test_trainer_mesh.py: (losses, the
    final parameters in the port's layout)."""
    jcfg, jparams = _configs()
    kw = dict(use_gradcache=True, chunk_size=4, freeze_nonbias=True) if gradcache_bitfit else {}
    tc = JaxTrainConfig(batch_size=8, max_seq_len=16, epochs=1, lr=1e-3, **kw)
    out = JaxTrainer(jparams, jcfg, SimpleTokenizer(vocab_size=VOCAB), tc).fit(
        lambda: iter(BATCHES), steps_per_epoch=len(BATCHES))
    return ([h["loss"] for h in out["history"]],
            params_from_jax(jax.tree.map(np.asarray, out["params"]), from_jax_config(jcfg)))


def _port_trainer(mesh, **kw):
    jcfg, jparams = _configs()
    cfg = from_jax_config(jcfg)
    model = Decoder(cfg, device="cpu",
                    weights=params_from_jax(jax.tree.map(np.asarray, jparams), cfg))
    tc = TrainConfig(batch_size=8, max_seq_len=16, epochs=1, lr=1e-3, **kw)
    return ContrastiveTrainer(model, cfg, SimpleTokenizer(vocab_size=VOCAB), tc, mesh=mesh)


def _hold_to_jax(trainer, gradcache_bitfit):
    out = trainer.fit(lambda: iter(BATCHES), steps_per_epoch=len(BATCHES))
    want_losses, want = _jax_fit(gradcache_bitfit)
    np.testing.assert_allclose([h["loss"] for h in out["history"]], want_losses,
                               rtol=LOSS_RTOL)
    assert set(out["params"]) == set(want)
    for name, p in out["params"].items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, err_msg=name)
    # every copy of a logical leaf (a piece in the dp rows, a whole leaf in
    # every shard, the aux in every row) bit-equal after the fit
    for group in trainer._groups:
        assert all(torch.equal(group[0], c) for c in group[1:])
    return out


@pytest.mark.parametrize("dp,tp", [(8, 1), (4, 2), (2, 4)])
def test_mesh_fit_equals_jax_single_device(dp, tp):
    trainer = _port_trainer(make_mesh(dp=dp, tp=tp, devices=_cpus(dp * tp)))
    assert isinstance(trainer.model, ShardedDecoder) and len(trainer.model.groups) == dp
    _hold_to_jax(trainer, False)


def test_mesh_fit_gradcache_bitfit_equals_jax_single_device():
    """The flagship combination: BitFit + GradCache (chunks of 4, 2 rows of
    each a dp row) on a 4 × 2 mesh; only biases move."""
    trainer = _port_trainer(make_mesh(dp=4, tp=2, devices=_cpus(8)), use_gradcache=True,
                            chunk_size=4, freeze_nonbias=True)
    before = trainer.model.state_dict()
    out = _hold_to_jax(trainer, True)
    for name, p in out["params"].items():
        assert (not torch.equal(p, before[name])) == (name.rsplit(".", 1)[-1] in
                                                      BIAS_NAMES), name


def test_replicated_copies_are_separate_tensors_kept_equal():
    """After a fit on a 2 × 2 mesh the copies of a whole leaf (LayerNorms,
    biases of wo) in all four shards, and a tp piece in both dp rows, are
    distinct tensors with equal bits; the pieces of one leaf differ."""
    trainer = _port_trainer(make_mesh(dp=2, tp=2, devices=_cpus(4)),
                            pooling="learned_weightedmean")
    trainer.fit(lambda: iter(BATCHES), steps_per_epoch=len(BATCHES))
    shards = [s for g in trainer.model.groups for s in g.shards]
    lns = [s.layers[0].ln1.scale for s in shards]
    assert len({t.data_ptr() for t in lns}) == 4
    assert all(torch.equal(lns[0], t) for t in lns[1:]) and not torch.all(lns[0] == 1)
    wq = [[g.shards[j].layers[1].attn.wq for g in trainer.model.groups] for j in range(2)]
    assert torch.equal(*wq[0]) and torch.equal(*wq[1]) and not torch.equal(wq[0][0], wq[1][0])
    pos = [a["pos_weights"] for a in trainer._aux_rows]
    assert torch.equal(*pos) and pos[0].data_ptr() != pos[1].data_ptr()


def test_mesh_fit_trims_ragged_tail():
    """A tail batch that dp does not divide is trimmed, one smaller than dp
    skipped (tests/test_trainer_mesh.py's case)."""
    trainer = _port_trainer(make_mesh(dp=4, tp=2, devices=_cpus(8)))
    ragged = [BATCHES[0], BATCHES[0][:6], BATCHES[0][:3]]  # 8, 6 -> 4, 3 -> skip
    out = trainer.fit(lambda: iter(ragged), steps_per_epoch=3)
    losses = [h["loss"] for h in out["history"] if "loss" in h]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert trainer._prep_batch(BATCHES[0][:3]) is None
    rows = trainer._prep_batch(BATCHES[0][:6])
    assert len(rows) == 4 and all(t["ids"].shape == (1, 16) for r in rows for t in r)


def test_gradcache_chunk_must_divide_dp():
    cfg = tiny("neo", num_layers=1, hidden_size=32, num_heads=2, vocab_size=VOCAB)
    with pytest.raises(ValueError, match="divisible by dp"):
        ContrastiveTrainer(Decoder(cfg, device="cpu"), cfg, SimpleTokenizer(vocab_size=VOCAB),
                           TrainConfig(use_gradcache=True, chunk_size=6),
                           mesh=make_mesh(dp=4, tp=2, devices=_cpus(8)))


def test_mesh_save_restore_and_evaluator(tmp_path):
    """The evaluator gets the live sharded decoder (no unsharded copy), which
    an engine runs with the mesh; `save_model` writes the unsharded tree,
    and `restore` on another mesh trainer shards it again, in place (the
    optimizer's tensors stay)."""
    seen = []

    def evaluator(model):
        seen.append(model)
        return 0.5

    trainer = _port_trainer(make_mesh(dp=2, tp=2, devices=_cpus(4)))
    out = trainer.fit(lambda: iter(BATCHES), steps_per_epoch=3, evaluator=evaluator)
    assert seen[0] is trainer.model and out["best_score"] == 0.5
    for name, t in seen[0].state_dict().items():
        assert torch.equal(t, out["params"][name]), name
    texts = ["anchor one text", "positive two body"]
    np.testing.assert_allclose(   # tp's row-parallel sums: fp32 rounding apart
        trainer.export_model().encode(texts),
        EmbeddingEngine(unshard_params(trainer.model), trainer.cfg, trainer.tokenizer,
                        device="cpu", max_seq_len=16).encode(texts), rtol=0, atol=1e-5)
    trainer.save_model(str(tmp_path / "m"))
    other = _port_trainer(make_mesh(dp=4, tp=2, devices=_cpus(8)))
    live = other.model.groups[3].shards[1].layers[0].attn.wk
    other.restore(str(tmp_path / "m"))
    assert other.model.groups[3].shards[1].layers[0].attn.wk is live
    for name, t in other.model.state_dict().items():
        assert torch.equal(t, out["params"][name]), name


def test_mesh_best_snapshot_holds_the_trainable_leaves():
    """Under BitFit the best-model snapshot of a 2 × 2 mesh trainer holds the
    bias leaves only, unsharded; `best_params` is the final tree with the
    best step's biases, as the meshless trainer's (evaluated after each
    step, best at step 2)."""
    outs, snaps = {}, {}
    for name, mesh in (("flat", None), ("mesh", make_mesh(dp=2, tp=2, devices=_cpus(4)))):
        scores = iter([0.1, 0.9, 0.5])
        trainer = _port_trainer(mesh, freeze_nonbias=True, eval_steps=1)
        outs[name] = trainer.fit(lambda: iter(BATCHES), steps_per_epoch=3,
                                 evaluator=lambda model: next(scores))
        snaps[name] = trainer.best_params
    assert outs["mesh"]["best_score"] == 0.9
    assert set(snaps["mesh"]) == set(snaps["flat"]) == {
        n for n in outs["flat"]["params"] if n.rsplit(".", 1)[-1] in BIAS_NAMES}
    best, final = outs["mesh"]["best_params"], outs["mesh"]["params"]
    assert set(best) == set(final)
    for name, t in best.items():
        if name in snaps["mesh"]:
            assert torch.equal(t, snaps["mesh"][name]) and not torch.equal(t, final[name]), name
        else:
            assert torch.equal(t, final[name]), name
        np.testing.assert_allclose(t.numpy(), outs["flat"]["best_params"][name].numpy(),
                                   rtol=PARAM_RTOL, atol=PARAM_ATOL, err_msg=name)


# -- mnrl_loss_dp against JAX's shard_map ----------------------------------------

@pytest.mark.parametrize("negatives", [True, False])
@pytest.mark.parametrize("similarity", ["cos_sim", "dot_score"])
def test_mnrl_loss_dp_matches_jax_shard_map(negatives, similarity):
    dp, n_local, D = 8, 3, 16
    rng = np.random.default_rng(4)
    towers = [rng.normal(size=(dp * n_local, D)).astype(np.float32)
              for _ in range(3 if negatives else 2)]
    mesh = JaxMesh(np.asarray(jax.devices()[:dp]), ("dp",))

    def jax_loss(*ts):
        return jax.shard_map(
            lambda *xs: jax_mnrl_loss_dp(*xs, scale=20.0, similarity=similarity),
            mesh=mesh, in_specs=(P("dp", None),) * len(ts), out_specs=P())(*ts)

    want, want_grads = jax.value_and_grad(jax_loss, argnums=tuple(range(len(towers))))(
        *[jnp.asarray(t) for t in towers])
    rows = [[torch.from_numpy(t[i * n_local:(i + 1) * n_local].copy()).requires_grad_()
             for i in range(dp)] for t in towers]
    losses = mnrl_loss_dp(*rows, scale=20.0, similarity=similarity)
    assert len(losses) == dp and all(torch.equal(x, losses[0]) for x in losses)
    losses[0].backward()
    got = float(losses[0].detach())
    assert abs(got - float(want)) <= 1e-6 * max(1.0, abs(float(want)))
    whole = mnrl_loss(*[torch.from_numpy(t) for t in towers], scale=20.0, similarity=similarity)
    assert abs(got - float(whole)) <= 1e-6 * max(1.0, abs(float(whole)))
    for parts, g in zip(rows, want_grads):
        g = np.asarray(g)
        np.testing.assert_allclose(torch.cat([p.grad for p in parts]).numpy(), g,
                                   rtol=0, atol=1e-5 * np.abs(g).max())


# -- the train CLIs on a mesh -------------------------------------------------------

def _tiny_build(model_name, random_init=False, dtype_str="float32", device="cpu", seed=0):
    from sgpt_tpu_torch.tokenization import SimpleTokenizer as PortTokenizer
    cfg = tiny("neo", num_layers=2, hidden_size=32, num_heads=2, vocab_size=VOCAB)
    model = Decoder(cfg, device=device, generator=torch.Generator().manual_seed(seed))
    return model, cfg, PortTokenizer(vocab_size=VOCAB)


def _write_msmarco(data, n_queries=10, n_passages=20):
    """A synthetic MS MARCO folder (tests/test_torch_cli_training.py's)."""
    data.mkdir()
    with open(data / "collection.tsv", "w") as f:
        for i in range(n_passages):
            f.write(f"p{i}\tpassage number {i} words here\n")
    with open(data / "queries.tsv", "w") as f:
        for i in range(n_queries):
            f.write(f"q{i}\tquery number {i}\n")
    with open(data / "hard-negatives.jsonl", "w") as f:
        for i in range(n_queries):
            f.write(json.dumps({"qid": f"q{i}", "pos": [f"p{i}"],
                                "neg": {"bm25": [f"p{(i + j) % n_passages}"
                                                 for j in range(5, 10)]}}) + "\n")
    with open(data / "dev-queries.tsv", "w") as f:
        f.write("d0\tquery number 3\n")
    with open(data / "dev-qrels.tsv", "w") as f:
        f.write("d0\tp3\n")


def _write_nli(tmp_path):
    """AllNLI and STS-B fixtures (tests/test_torch_symmetric.py's)."""
    rng = np.random.default_rng(2)
    with gzip.open(tmp_path / "AllNLI.tsv.gz", "wt") as f:
        f.write("split\tsentence1\tsentence2\tlabel\n")
        for i in range(40):
            words = " ".join(f"w{rng.integers(0, 60)}" for _ in range(int(rng.integers(3, 9))))
            f.write(f"train\tpremise {words}\tentailed {words} e{i}\tentailment\n")
            f.write(f"train\tpremise {words}\tcontra {i} c{rng.integers(0, 9)}\t"
                    "contradiction\n")
            f.write(f"train\tpremise {words}\tneutral {i}\tneutral\n")
    with gzip.open(tmp_path / "stsb.tsv.gz", "wt") as f:
        f.write("split\tsentence1\tsentence2\tscore\n")
        for i in range(16):
            a = " ".join(f"w{rng.integers(0, 60)}" for _ in range(5))
            b = " ".join(f"w{rng.integers(0, 60)}" for _ in range(int(rng.integers(2, 9))))
            f.write(f"{'dev' if i < 12 else 'test'}\t{a}\t{b}\t{(i * 7) % 5}.{i % 10}\n")


def test_train_msmarco_cli_on_a_mesh(tmp_path, monkeypatch):
    """`--dp 2 --tp 2 --device cpu,cpu,cpu,cpu` against the meshless run:
    the same losses (rtol 2e-4), checkpoints of the unsharded tree, and the
    dev evaluation on the trained weights."""
    monkeypatch.setattr(train_msmarco, "build_model", _tiny_build)
    monkeypatch.chdir(tmp_path)
    _write_msmarco(tmp_path / "msmarco")
    base = ["--model_name", "tiny", "--randominit", "--data_folder", str(tmp_path / "msmarco"),
            "--train_batch_size", "4", "--max_seq_length", "16", "--lr", "1e-3", "--specb",
            "--freezenonbias", "--gradcache", "--chunksize", "2", "--eval_dev",
            "--dev_corpus_sample", "5"]
    runs = {}
    for name, extra in (("flat", ["--device", "cpu"]),
                        ("mesh", ["--device", "cpu,cpu,cpu,cpu", "--dp", "2", "--tp", "2"])):
        runs[name] = train_msmarco.main(train_msmarco.parse_args(
            [*base, *extra, "--model_save_path", str(tmp_path / name)]))
    losses = [[h["loss"] for h in runs[k]["history"]] for k in ("flat", "mesh")]
    assert len(losses[0]) == 2
    np.testing.assert_allclose(losses[1], losses[0], rtol=LOSS_RTOL)
    for name, p in runs["mesh"]["params"].items():
        np.testing.assert_allclose(p.numpy(), runs["flat"]["params"][name].numpy(),
                                   rtol=PARAM_RTOL, atol=PARAM_ATOL, err_msg=name)
    assert (tmp_path / "mesh" / "checkpoints" / "2" / "params.pt").exists()
    with pytest.raises(SystemExit, match="dp"):
        train_msmarco.main(train_msmarco.parse_args(
            [*base, "--device", "cpu,cpu,cpu", "--dp", "2", "--tp", "2"]))


def test_train_nli_cli_on_a_mesh(tmp_path, monkeypatch):
    """`train_nli --dp 2 --tp 2` with the STS-B evaluator and the learnt
    mean: the same losses and dev scores as the meshless run; the best
    model it exports encodes as the meshless one."""
    monkeypatch.setattr(train_nli, "build_model", _tiny_build)
    _write_nli(tmp_path)
    base = ["--model_name", "tiny", "--randominit", "--nli_path", str(tmp_path / "AllNLI.tsv.gz"),
            "--stsb_path", str(tmp_path / "stsb.tsv.gz"), "--train_batch_size", "8",
            "--max_seq_length", "16", "--lr", "1e-3", "--freezenonbias", "--learntmean"]
    runs = {}
    for name, extra in (("flat", ["--device", "cpu"]),
                        ("mesh", ["--device", "cpu,cpu,cpu,cpu", "--dp", "2", "--tp", "2"])):
        runs[name] = train_nli.main(train_nli.parse_args(
            [*base, *extra, "--model_save_path", str(tmp_path / name)]))

    def split(history):
        return ([h["loss"] for h in history if "loss" in h],
                [h["eval_score"] for h in history if "eval_score" in h])

    (fl, fs), (ml, ms) = split(runs["flat"]["history"]), split(runs["mesh"]["history"])
    assert len(fl) == len(ml) == 5 and len(fs) == len(ms) == 5
    np.testing.assert_allclose(ml, fl, rtol=LOSS_RTOL)
    np.testing.assert_allclose(ms, fs, atol=1e-4)
    texts = ["a b c", "premise w1 w2", "w3"]
    np.testing.assert_allclose(runs["mesh"]["model"].encode(texts),
                               runs["flat"]["model"].encode(texts), atol=1e-4)
