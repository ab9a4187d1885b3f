"""The port's encode pipeline: the depth-2 fetch and dispatch chaining.

`sgpt_tpu_torch.encoder` keeps `FETCH_PIPELINE_DEPTH` dispatches in flight
before their fetch and, on one device, launches runs of same-shape batches
back to back and fetches each group as one (`dispatch_chain`, the JAX
engine's default 8). Both are scheduling only: the embeddings equal the
depth-1, chain-1 encode bit for bit (on one device, a CPU mesh and an
sp_mesh), and the JAX engine's with the same keywords within 1e-5. The
chain plan equals JAX's `_chain_group_sizes`; no batch is fetched before
`FETCH_PIPELINE_DEPTH` dispatches are pending; inputs reach a card from
pinned memory with `non_blocking=True`.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
os.environ.setdefault("JAX_PLATFORMS", "cpu")
pytest.importorskip("jax").config.update("jax_platforms", "cpu")

import jax  # noqa: E402

import sgpt_tpu_torch.encoder as enc_mod  # noqa: E402
from sgpt_tpu.encoder import EmbeddingEngine as JaxEngine  # noqa: E402
from sgpt_tpu.encoder import _chain_group_sizes as jax_chain_group_sizes  # noqa: E402
from sgpt_tpu.models import init_params as jax_init_params  # noqa: E402
from sgpt_tpu.models import tiny as jax_tiny  # noqa: E402
from sgpt_tpu.tokenization import SimpleTokenizer  # noqa: E402
from sgpt_tpu_torch.encoder import EmbeddingEngine, _chain_group_sizes  # noqa: E402
from sgpt_tpu_torch.models import Decoder, from_jax_config, params_from_jax  # noqa: E402
from sgpt_tpu_torch.parallel import make_mesh, rows_to_device  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: beside the other test processes on the host's
    cores, a pool of threads makes many small operations wait."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    jcfg = jax_tiny("neo", num_layers=2)
    jparams = jax_init_params(jcfg, jax.random.key(0))
    cfg = from_jax_config(jcfg)
    model = Decoder(cfg, device="cpu",
                    weights=params_from_jax(jax.tree.map(np.asarray, jparams), cfg))
    return jcfg, jparams, cfg, model


def _ragged(n=90, seed=3):
    """tests/test_encoder_retrieval.py's ragged mix: long same-shape runs,
    partial groups and bucket changes mid-stream."""
    rng = np.random.default_rng(seed)
    return [" ".join(f"w{rng.integers(1000)}" for _ in range(int(m)))
            for m in np.clip(rng.lognormal(2.5, 0.7, n), 2, 60)]


KW = dict(batch_size=4, normalize_embeddings=True, max_seq_len=64)
WHERE = {"single": dict(device="cpu"),
         "mesh": dict(mesh=make_mesh(dp=2, tp=1, devices=["cpu", "cpu"])),
         "sp_mesh": dict(sp_mesh=make_mesh(dp=2, tp=1, devices=["cpu", "cpu"]))}


def test_chain_group_plan():
    """Greedy powers of two over same-shape runs, singles at once (the JAX
    package's own cases)."""
    A, B = (4, 64), (8, 32)
    assert _chain_group_sizes([A] * 13 + [B] * 3, 8) == \
        [8, 0, 0, 0, 0, 0, 0, 0, 4, 0, 0, 0, 1, 2, 0, 1]
    assert _chain_group_sizes([A] * 6, 6) == [4, 0, 0, 0, 2, 0]
    assert _chain_group_sizes([A, B, A], 8) == [1, 1, 1]
    assert _chain_group_sizes([A] * 5, 1) == [1] * 5
    assert _chain_group_sizes([], 8) == []


def test_chain_group_sizes_match_jax():
    """The port's plan == JAX's on random shape streams and chains."""
    hyp = pytest.importorskip("hypothesis")
    st = hyp.strategies

    @hyp.settings(max_examples=300, deadline=None, database=None)
    @hyp.given(st.lists(st.sampled_from([(4, 64), (8, 32), (16, 16), (512, 16)]),
                        max_size=48),
               st.integers(-2, 40))
    def check(shapes, chain):
        assert _chain_group_sizes(shapes, chain) == jax_chain_group_sizes(shapes, chain)

    check()


@pytest.mark.parametrize("where", list(WHERE))
def test_fetch_pipeline_depth_does_not_change_results(pair, monkeypatch, where):
    """Depth 2 (the default) == depth 1, bit for bit, on one device (chain
    8 and chain 1), on a dp=2 CPU mesh and on an sp_mesh of 2."""
    _, _, cfg, model = pair
    tok = SimpleTokenizer(cfg.vocab_size)
    texts = _ragged(40)
    engine = EmbeddingEngine(model, cfg, tok, **KW, **WHERE[where])
    assert enc_mod.FETCH_PIPELINE_DEPTH == 2 and engine.dispatch_chain == 8
    piped = engine.encode(texts)
    monkeypatch.setattr(enc_mod, "FETCH_PIPELINE_DEPTH", 1)
    sync = EmbeddingEngine(model, cfg, tok, dispatch_chain=1, **KW,
                           **WHERE[where]).encode(texts)
    np.testing.assert_array_equal(piped, sync)
    np.testing.assert_array_equal(engine.encode(texts), sync)


@pytest.mark.parametrize("depth,chain,where", [(1, 1, "single"), (2, 1, "single"),
                                               (3, 1, "single"), (2, 8, "single"),
                                               (2, 8, "mesh")])
def test_no_fetch_before_depth_dispatches_are_pending(pair, monkeypatch, depth, chain, where):
    """Every fetch in the loop finds FETCH_PIPELINE_DEPTH entries pending
    (then the tail drains), one entry per batch or chain group, and the
    fetches follow the plan: on a mesh the chain is 1."""
    _, _, cfg, model = pair
    engine = EmbeddingEngine(model, cfg, SimpleTokenizer(cfg.vocab_size),
                             dispatch_chain=chain, **KW, **WHERE[where])
    texts = _ragged(60)
    dispatched, seen = [], []
    embed, drain = engine._embed, engine._drain

    def counting_embed(ids, mask):
        dispatched.append(ids.shape)
        return embed(ids, mask)

    def counting_drain(pending, out):
        seen.append((len(dispatched), len(pending), len(pending[0][0])))
        return drain(pending, out)

    monkeypatch.setattr(enc_mod, "FETCH_PIPELINE_DEPTH", depth)
    monkeypatch.setattr(engine, "_embed", counting_embed)
    monkeypatch.setattr(engine, "_drain", counting_drain)
    got = engine.encode(texts)
    effective = 1 if where == "mesh" else chain
    plan = [g for g in _chain_group_sizes(dispatched, effective) if g]
    assert [g for _, _, g in seen] == plan and len(plan) > depth
    assert (max(plan) > 1) == (effective > 1)   # the mix holds same-shape runs
    n = len(dispatched)
    for i, (done, pend, _) in enumerate(seen):
        if done < n:          # in the loop: exactly `depth` pending, oldest fetched
            assert pend == depth, seen
        else:                 # the tail
            assert pend == len(seen) - i, seen
    monkeypatch.setattr(enc_mod, "FETCH_PIPELINE_DEPTH", 1)
    sync = EmbeddingEngine(model, cfg, SimpleTokenizer(cfg.vocab_size), dispatch_chain=1,
                           **KW, **WHERE[where]).encode(texts)
    np.testing.assert_array_equal(got, sync)


def test_dispatch_chain_equality(pair):
    """The ragged mix at dispatch_chain=3 (full groups, a partial group's
    single tail, shape changes mid-stream): chain 1's embeddings bit for
    bit, and the JAX engine's at dispatch_chain=3 within 1e-5."""
    jcfg, jparams, cfg, model = pair
    tok = SimpleTokenizer(cfg.vocab_size)
    texts = _ragged()
    single = EmbeddingEngine(model, cfg, tok, device="cpu", dispatch_chain=1,
                             **KW).encode(texts)
    chained = EmbeddingEngine(model, cfg, tok, device="cpu", dispatch_chain=3,
                              **KW).encode(texts)
    np.testing.assert_array_equal(chained, single)
    want = JaxEngine(jparams, jcfg, tok, dispatch_chain=3, **KW).encode(texts)
    np.testing.assert_allclose(chained, want, atol=1e-5)


@pytest.mark.parametrize("chain", [0, -3, 2.9])
def test_dispatch_chain_is_taken_as_jax_takes_it(pair, chain):
    """max(1, int(dispatch_chain)), as the JAX engine does."""
    _, _, cfg, model = pair
    engine = EmbeddingEngine(model, cfg, SimpleTokenizer(cfg.vocab_size), device="cpu",
                             dispatch_chain=chain)
    assert engine.dispatch_chain == max(1, int(chain))


def test_inputs_reach_a_card_from_pinned_memory(monkeypatch):
    """rows_to_device pins each array and copies it with non_blocking=True
    for a CUDA device (recorded here with the copy itself stubbed: no card),
    and on the CPU neither pins nor copies."""
    calls = []

    def pin(self):
        calls.append("pin")
        return self

    def to(self, *a, **kw):
        calls.append((a, kw))
        return self

    ids = np.arange(6, dtype=np.int32).reshape(2, 3)
    mask = np.ones((2, 3), np.int32)
    monkeypatch.setattr(torch.Tensor, "pin_memory", pin)
    monkeypatch.setattr(torch.Tensor, "to", to)
    card = torch.device("cuda", 0)
    rows_to_device(card, ids, mask)
    assert calls == ["pin", ((card,), {"non_blocking": True})] * 2
    calls.clear()
    out = rows_to_device(torch.device("cpu"), ids, mask)
    monkeypatch.undo()
    assert calls == [] and [t.dtype for t in out] == [torch.int32] * 2
    np.testing.assert_array_equal(out[0].numpy(), ids)


def test_the_engine_copies_its_inputs_through_rows_to_device(pair, monkeypatch):
    """Every dispatch hands its ids and mask to rows_to_device (the pinned,
    non-blocking copy on a card)."""
    _, _, cfg, model = pair
    seen = []

    def recording(device, *arrays):
        seen.append((str(device), [a.shape for a in arrays]))
        return rows_to_device(device, *arrays)

    monkeypatch.setattr(enc_mod, "rows_to_device", recording)
    engine = EmbeddingEngine(model, cfg, SimpleTokenizer(cfg.vocab_size), device="cpu", **KW)
    engine.encode(_ragged(12))
    assert seen and all(d == "cpu" and len(s) == 2 and s[0] == s[1] for d, s in seen)
