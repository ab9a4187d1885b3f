"""The port's sequence parallelism (ring attention, `sp_mesh=`) == the JAX
package's on the CPU.

The JAX side runs `ring_attention` and the sp forward on the forced 8-device
XLA CPU mesh (tests/conftest.py); the port's sp meshes are `["cpu"] * n`
device lists (one process drives the ring), from the same weights
(`params_from_jax`), fp32 at matmul_precision "highest". The JAX tests'
tolerances (tests/test_ring_attention.py, tests/test_sequence_parallel.py):

  * `ring_attention` against JAX's: scaled, unscaled with a window, a
    sequence 8 × a shard's block, ALiBi; valid rows within 1e-4; rows with
    no valid key exactly 0; its gradients (dq, dk, dv) within 2e-5;
  * `Decoder.forward(sp_mesh=)` against JAX's sp forward for GPT-Neo (local
    layers), GPT-J (rotary) and BLOOM (ALiBi): valid positions within 2e-4;
    all hidden states too; the refusals JAX makes (bidirectional, packed,
    T5's relative bias) and a length the mesh does not divide;
  * the engine's sp encode (T padded to the mesh's size) against JAX's
    sp engine and the port's meshless encode, 1e-5 (float, a stack pooler
    and int8);
  * `ContrastiveTrainer(sp_mesh=)`: one step against JAX's single-device
    step, loss within 1e-4 and parameters within 2e-4; a max_seq_len the
    mesh does not divide refused ("divide");
  * `TSDAETrainer(sp_mesh=)`: one step against JAX's single-device step,
    loss within 1e-4 (the decoder side pads to (T-1 | sp) + 1).
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
os.environ.setdefault("JAX_PLATFORMS", "cpu")
pytest.importorskip("jax").config.update("jax_platforms", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh as JaxMesh  # noqa: E402

from sgpt_tpu.encoder import EmbeddingEngine as JaxEngine  # noqa: E402
from sgpt_tpu.models import init_params as jax_init_params  # noqa: E402
from sgpt_tpu.models import tiny as jax_tiny  # noqa: E402
from sgpt_tpu.models.decoder import alibi_slopes as jax_alibi_slopes  # noqa: E402
from sgpt_tpu.models.decoder import forward as jax_forward  # noqa: E402
from sgpt_tpu.ops.ring_attention import ring_attention as jax_ring_attention  # noqa: E402
from sgpt_tpu.tokenization import SimpleTokenizer  # noqa: E402
from sgpt_tpu.training import ContrastiveTrainer as JaxTrainer  # noqa: E402
from sgpt_tpu.training import TrainConfig as JaxTrainConfig  # noqa: E402
from sgpt_tpu.training.tsdae import TSDAETrainer as JaxTSDAETrainer  # noqa: E402
from sgpt_tpu_torch.encoder import EmbeddingEngine  # noqa: E402
from sgpt_tpu_torch.models import (Decoder, from_jax_config, params_from_jax, tiny,  # noqa: E402
                                   tsdae_from_jax)
from sgpt_tpu_torch.ops.ring_attention import ring_attention  # noqa: E402
from sgpt_tpu_torch.parallel import make_mesh  # noqa: E402
from sgpt_tpu_torch.training import ContrastiveTrainer, TrainConfig, TSDAETrainer  # noqa: E402

VOCAB = 256


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: beside the other test processes on the host's
    cores, a pool of threads makes many small operations wait."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_mesh():
    return JaxMesh(np.asarray(jax.devices()), ("dp",))


def _sp(n=8):
    return make_mesh(dp=n, tp=1, devices=["cpu"] * n)


def _mk(T, seed=0, B=2, H=2, Dh=16):
    """tests/test_ring_attention.py's inputs: the last 1/5 of batch row
    B-1's keys padded."""
    rng = np.random.default_rng(seed)
    qkv = [(rng.normal(size=(B, H, T, Dh)) * 0.5).astype(np.float32) for _ in range(3)]
    mask = np.ones((B, T), np.int32)
    mask[B - 1, T - T // 5:] = 0
    return qkv, mask


def _both(jax_mesh, qkv, mask, slopes=None, **kw):
    want = np.asarray(jax_ring_attention(*[jnp.asarray(t) for t in qkv], jnp.asarray(mask),
                                         None if slopes is None else jnp.asarray(slopes),
                                         mesh=jax_mesh, **kw))
    got = ring_attention(*[torch.from_numpy(t) for t in qkv], torch.from_numpy(mask),
                         None if slopes is None else torch.from_numpy(slopes), mesh=_sp(), **kw)
    return got.numpy(), want


@pytest.mark.parametrize("case", ["scaled", "unscaled_window", "long", "alibi"])
def test_ring_attention_matches_jax(jax_mesh, case):
    kw, T, shape, slopes = dict(scale=0.25), 64, {}, None
    if case == "unscaled_window":
        kw = dict(scale=1.0, window=24)
    elif case == "long":   # 32 positions a shard
        T, shape, kw = 256, dict(B=1, H=1, Dh=8), dict(scale=0.35)
    elif case == "alibi":
        shape, slopes = dict(H=4), np.array(jax_alibi_slopes(4), np.float32)
    qkv, mask = _mk(T, seed=["scaled", "unscaled_window", "long", "alibi"].index(case),
                    **shape)
    got, want = _both(jax_mesh, qkv, mask, slopes, **kw)
    m = mask[:, None, :, None]
    assert (np.abs(got - want) * m).max() < 1e-4


def test_fully_masked_rows_output_zeros(jax_mesh):
    """A query row with no valid key anywhere outputs exactly 0, as JAX's."""
    qkv, _ = _mk(16, seed=9)
    mask = np.ones((2, 16), np.int32)
    mask[1, :] = 0
    got, want = _both(jax_mesh, qkv, mask)
    assert np.abs(got[1]).max() == 0.0 and np.abs(want[1]).max() == 0.0
    assert np.isfinite(got[0]).all() and np.abs(got[0] - want[0]).max() < 1e-4


def test_ring_attention_gradients_match_jax(jax_mesh):
    """dq, dk, dv of sum(out²) against JAX's ring VJP (autograd through the
    peer copies and the online softmax)."""
    rng = np.random.default_rng(5)
    B, H, T, Dh = 2, 2, 64, 16
    qkv = [rng.normal(size=(B, H, T, Dh)).astype(np.float32) for _ in range(3)]
    mask = np.ones((B, T), np.int32)
    mask[1, 50:] = 0
    want = jax.grad(lambda q, k, v: jnp.sum(jax_ring_attention(
        q, k, v, jnp.asarray(mask), mesh=jax_mesh, scale=0.25) ** 2),
        argnums=(0, 1, 2))(*[jnp.asarray(t) for t in qkv])
    ts = [torch.from_numpy(t).requires_grad_() for t in qkv]
    (ring_attention(*ts, torch.from_numpy(mask), mesh=_sp(), scale=0.25) ** 2).sum().backward()
    for t, w in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=2e-5, rtol=2e-5)


# -- the decoder under sp_mesh ----------------------------------------------------

def _pair(family, **kw):
    jcfg = jax_tiny(family, num_layers=2, hidden_size=32, num_heads=4,
                    max_position_embeddings=128, **kw)
    jparams = jax_init_params(jcfg, jax.random.key(0))
    cfg = from_jax_config(jcfg)
    model = Decoder(cfg, device="cpu",
                    weights=params_from_jax(jax.tree.map(np.asarray, jparams), cfg))
    return jcfg, jparams, cfg, model


@pytest.mark.parametrize("family", ["neo", "gptj", "bloom"])
def test_sp_forward_matches_jax(jax_mesh, family):
    jcfg, jparams, cfg, model = _pair(family)
    rng = np.random.default_rng(0)
    B, T = 2, 64   # 8 tokens a shard on the 8-device mesh
    ids = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    mask = np.ones((B, T), np.int32)
    mask[1, 50:] = 0
    want = np.asarray(jax_forward(jparams, jnp.asarray(ids), jnp.asarray(mask), jcfg,
                                  sp_mesh=jax_mesh, output_hidden_states=True))
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long(), torch.from_numpy(mask), sp_mesh=_sp(),
                    output_hidden_states=True).numpy()
        final = model(torch.from_numpy(ids).long(), torch.from_numpy(mask), sp_mesh=_sp())
    m = mask[None, :, :, None]
    assert got.shape == want.shape
    assert (np.abs(got - want) * m).max() < 2e-4, (np.abs(got - want) * m).max()
    np.testing.assert_array_equal(final.numpy(), got[-1])


@pytest.mark.parametrize("family", ["neo", "gptj"])
def test_sp_forward_through_weight_copies_matches_the_direct_call(monkeypatch, family):
    """Where a shard's device does not hold the weights (distinct cards),
    each block runs its own methods on copies of its weights
    (`torch.func.functional_call`). Forced here on the CPU: the hidden
    states and the weights' gradients equal the direct calls' bit for bit."""
    from sgpt_tpu_torch.models import decoder as dec

    _, _, cfg, model = _pair(family)
    rng = np.random.default_rng(3)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 32))).long()
    mask = torch.ones(2, 32, dtype=torch.int32)
    mask[1, 20:] = 0

    def run():
        model.zero_grad(set_to_none=True)
        out = model(ids, mask, sp_mesh=_sp(4), output_hidden_states=True)
        (out ** 2).sum().backward()
        return out.detach(), {n: p.grad.clone() for n, p in model.named_parameters()
                              if p.grad is not None}

    direct = run()
    copies = []

    def on_device(module, device):
        copies.append(module)
        state = dict(module.named_parameters())
        state.update(module.named_buffers())
        return {k: t.clone() for k, t in state.items()}

    monkeypatch.setattr(dec, "_on_device", on_device)
    copied = run()
    assert len(copies) == (cfg.num_layers + 1) * 4   # every block and ln_f on every shard
    assert torch.equal(copied[0], direct[0])
    assert set(copied[1]) == set(direct[1]) and len(direct[1]) > 0
    for name, g in direct[1].items():
        assert torch.equal(copied[1][name], g), name


@pytest.mark.parametrize("family,kw,match", [
    ("bert", {}, "causal-only"),
    ("neo", dict(segment_ids=torch.zeros(1, 8, dtype=torch.int32),
                 position_ids=torch.zeros(1, 8, dtype=torch.int32)), "packing"),
    ("t5", {}, "relative position bias")])
def test_sp_forward_refuses_what_jax_refuses(family, kw, match):
    """BERT (bidirectional), packed rows and T5's relative bias (on a causal
    T5 config: a bidirectional one meets the first refusal)."""
    cfg = tiny(family, num_layers=1, hidden_size=32, num_heads=2)
    if family == "t5":
        cfg = cfg.replace(bidirectional=False)
    model = Decoder(cfg, device="cpu")
    ids = torch.zeros(1, 8, dtype=torch.long)
    with pytest.raises(NotImplementedError, match=match):
        model(ids, torch.ones_like(ids), sp_mesh=_sp(2), **kw)


def test_sp_forward_refuses_a_length_the_mesh_does_not_divide():
    model = Decoder(tiny("neo", num_layers=1, hidden_size=32, num_heads=2), device="cpu")
    ids = torch.zeros(1, 10, dtype=torch.long)
    with pytest.raises(ValueError, match="divide"):
        model(ids, torch.ones_like(ids), sp_mesh=_sp(4))


def test_engine_sp_encode_matches_the_meshless_encode():
    """The port's sp engine on 3 ring devices against JAX's
    `EmbeddingEngine(sp_mesh=)` on 3 XLA CPU devices, from the same weights,
    and against the port's meshless encode: buckets of 16-64 padded to a
    multiple of 3 on both sides (pads are causally invisible and masked out
    of the pooling), for the final states, a stack pooler and int8
    projections (per-token scales: the same for a shard's tokens), each
    within 1e-5."""
    jcfg, jparams, cfg, model = _pair("neo")
    tok = SimpleTokenizer(vocab_size=cfg.vocab_size)
    rng = np.random.default_rng(1)
    texts = [" ".join(f"w{rng.integers(0, 300)}" for _ in range(m))
             for m in rng.integers(1, 60, 9)]
    jax_sp = JaxMesh(np.asarray(jax.devices()[:3]), ("dp",))
    for kw in (dict(), dict(method="meanmean"), dict(quantize="int8")):
        want = JaxEngine(jparams, jcfg, tok, max_seq_len=64, batch_size=4, sp_mesh=jax_sp,
                         **kw).encode(texts)
        flat = EmbeddingEngine(model, cfg, tok, device="cpu", max_seq_len=64, batch_size=4,
                               **kw).encode(texts)
        engine = EmbeddingEngine(model, cfg, tok, sp_mesh=_sp(3), max_seq_len=64,
                                 batch_size=4, **kw)
        assert engine.device == torch.device("cpu")
        got = engine.warmup([16]).encode(texts)
        np.testing.assert_allclose(got, want, atol=1e-5, err_msg=str(kw))
        np.testing.assert_allclose(got, flat, atol=1e-5, err_msg=str(kw))


# -- training under sp_mesh --------------------------------------------------------

def _fp32_pair():
    jcfg = jax_tiny("neo", num_layers=2, hidden_size=32, num_heads=4, vocab_size=VOCAB,
                    max_position_embeddings=128).replace(dtype=jnp.float32)
    jparams = jax_init_params(jcfg, jax.random.key(0))
    cfg = from_jax_config(jcfg)
    model = Decoder(cfg, device="cpu",
                    weights=params_from_jax(jax.tree.map(np.asarray, jparams), cfg))
    return jcfg, jparams, cfg, model


def test_trainer_sp_mesh_matches_jax_single_device():
    """One fit step at T=64 sharded 8 ways against JAX's single-device step
    (tests/test_sequence_parallel.py's case, at a constant lr: the default
    warmup's first step has lr 0 and would move nothing): loss and updated
    parameters, which must have moved by more than twice the tolerance."""
    jcfg, jparams, cfg, model = _fp32_pair()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    batch = [(" ".join(f"a{i}w{j}" for j in range(30)), " ".join(f"p{i}w{j}" for j in range(40)))
             for i in range(4)]
    kw = dict(batch_size=4, max_seq_len=64, lr=1e-3, epochs=1, scheduler="constantlr")
    want = JaxTrainer(jparams, jcfg, SimpleTokenizer(vocab_size=VOCAB),
                      JaxTrainConfig(**kw)).fit(lambda: iter([batch]), steps_per_epoch=1)
    got = ContrastiveTrainer(model, cfg, SimpleTokenizer(vocab_size=VOCAB), TrainConfig(**kw),
                             sp_mesh=_sp()).fit(lambda: iter([batch]), steps_per_epoch=1)
    assert abs(got["history"][0]["loss"] - want["history"][0]["loss"]) < 1e-4
    want_params = params_from_jax(jax.tree.map(np.asarray, want["params"]), cfg)
    moved = max(float((p - before[name]).abs().max()) for name, p in got["params"].items())
    assert moved > 2 * 2e-4, moved   # Adam's first step moves a leaf by up to lr
    for name, p in got["params"].items():
        np.testing.assert_allclose(p.numpy(), want_params[name].numpy(), atol=2e-4,
                                   err_msg=name)


def test_trainer_sp_mesh_rejects_bad_seq_len():
    cfg = tiny("neo")
    with pytest.raises(ValueError, match="divide"):
        ContrastiveTrainer(Decoder(cfg, device="cpu"), cfg,
                           SimpleTokenizer(vocab_size=cfg.vocab_size),
                           TrainConfig(max_seq_len=75), sp_mesh=_sp())
    with pytest.raises(ValueError, match="not both"):
        ContrastiveTrainer(Decoder(cfg, device="cpu"), cfg,
                           SimpleTokenizer(vocab_size=cfg.vocab_size),
                           TrainConfig(max_seq_len=64), mesh=_sp(2), sp_mesh=_sp())


def test_tsdae_sp_mesh_matches_jax_single_device():
    """TSDAE with sp_mesh: encoder and tied decoder both ring-attend; the
    decoder side pads to (63 | 8) + 1 = 65, its extra pads masked out of the
    loss, so the loss is JAX's single-device loss."""
    jcfg, jparams, cfg, model = _fp32_pair()
    pairs = [(" ".join(f"n{i}w{j}" for j in range(20)), " ".join(f"o{i}w{j}" for j in range(30)))
             for i in range(3)]
    jt = JaxTSDAETrainer(jparams, jcfg, SimpleTokenizer(vocab_size=VOCAB), max_seq_len=64,
                         lr=1e-3)
    pt = TSDAETrainer(model, cfg, SimpleTokenizer(vocab_size=VOCAB), max_seq_len=64, lr=1e-3,
                      sp_mesh=_sp())
    carried = tsdae_from_jax(jax.tree.map(np.asarray, jt.tree["tsdae"]))
    with torch.no_grad():
        for k, t in pt.tsdae.items():
            t.copy_(carried[k])
    batch = pt.prep_batch(pairs)
    assert batch[0].shape[1] == 64 and batch[2].shape[1] == 65
    want = jt.train_batch(pairs)
    got = float(pt.step(batch))
    assert abs(got - want) < 1e-4
