"""The port's cross-encoder (SGPT-CE) == the JAX package's, on the CPU.

Tiny GPT-Neo in fp32 at matmul_precision "highest", the JAX `init_params`
converted by `params_from_jax`, inputs from a numpy seed. The LM head, the
three continuation scorers (vocab mask included) and `greedy_continuations`
against `sgpt_tpu/ops/logprobs.py`; `CrossEncoderRanker` / `YesNoRanker` /
`rerank` against `sgpt_tpu/crossencoder.py` on ragged pairs (the bucket
path, `pack_t`, few-shot, Yes/No, truncation that keeps the instruction),
once against JAX's fused Pallas K1 in interpret mode; packed == unpacked
inside the port; and the errors JAX raises raise here too.

Tolerance on summed log-probs: rtol 2e-5, atol 1e-4 (the JAX package's own
packed-vs-unpacked check is rtol 2e-4, atol 1e-4).
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
os.environ.setdefault("JAX_PLATFORMS", "cpu")
pytest.importorskip("jax").config.update("jax_platforms", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import sgpt_tpu.crossencoder as jce  # noqa: E402
import sgpt_tpu.ops.logprobs as jlp  # noqa: E402
import sgpt_tpu_torch.crossencoder as pce  # noqa: E402
import sgpt_tpu_torch.ops.logprobs as plp  # noqa: E402
from sgpt_tpu.models import init_params as jax_init_params  # noqa: E402
from sgpt_tpu.models import tiny as jax_tiny  # noqa: E402
from sgpt_tpu.models.decoder import forward as jax_forward  # noqa: E402
from sgpt_tpu.models.decoder import logits as jax_logits  # noqa: E402
from sgpt_tpu.tokenization import SimpleTokenizer  # noqa: E402
from sgpt_tpu_torch.models import Decoder, from_jax_config, params_from_jax  # noqa: E402
from sgpt_tpu_torch.parallel import make_mesh  # noqa: E402

RTOL, ATOL = 2e-5, 1e-4
VOCAB = 512


def _pair(**kw):
    jcfg = jax_tiny("neo", num_layers=2, hidden_size=32, num_heads=2, vocab_size=VOCAB,
                    matmul_precision="highest", **kw)
    jparams = jax_init_params(jcfg, jax.random.key(1))
    cfg = from_jax_config(jcfg)
    model = Decoder(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams), cfg))
    return jcfg, jparams, cfg, model


@pytest.fixture(scope="module")
def pair():
    return _pair()


TOK = SimpleTokenizer(vocab_size=VOCAB)


def _ragged_pairs(n=24, seed=7):
    """Queries and documents whose rows span the packed and the bucket paths,
    with duplicates (the shared-score fan-out)."""
    rng = np.random.default_rng(seed)
    pairs = []
    for i in range(n):
        qlen = int(rng.integers(1, 5))
        dlen = int(rng.integers(2, 40)) if i % 3 else int(rng.integers(60, 90))
        pairs.append((" ".join(f"q{i} t{j}" for j in range(qlen)),
                      " ".join(f"d{i} w{j}" for j in range(dlen))))
    pairs[5] = pairs[2]
    pairs[11] = pairs[2]
    return pairs


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=RTOL, atol=ATOL)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_logits_match_jax(pair):
    jcfg, jparams, cfg, model = pair
    h = np.random.default_rng(0).normal(size=(2, 5, cfg.hidden_size)).astype(np.float32)
    want = np.asarray(jax_logits(jparams, jnp.asarray(h), jcfg))
    got = model.logits(_t(h)).detach().numpy()
    assert got.shape == (2, 5, VOCAB)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # a separate, biased head (GPT-J's): the port's Decoder takes it from the tree
    tree = jax.tree.map(np.asarray, jparams)
    rng = np.random.default_rng(1)
    tree["lm_head"] = {"w": rng.normal(size=(cfg.hidden_size, VOCAB)).astype(np.float32),
                       "b": rng.normal(size=(VOCAB,)).astype(np.float32)}
    headed = Decoder(cfg, device="cpu", weights=params_from_jax(tree, cfg))
    np.testing.assert_allclose(headed.logits(_t(h)).detach().numpy(),
                               np.asarray(jax_logits(tree, jnp.asarray(h), jcfg)),
                               rtol=1e-5, atol=1e-5)


def _scorer_inputs(seed=0, B=3, T=24, C=8):
    """Rows with continuation windows of varying length at varying offsets, in
    the full (B, T) and the gathered (B, C) layouts."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, VOCAB, (B, T)).astype(np.int32)
    amask = np.ones((B, T), np.int32)
    full_t = np.zeros((B, T), np.int32)
    full_m = np.zeros((B, T), np.float32)
    cpos = np.zeros((B, C), np.int32)
    ctgt = np.zeros((B, C), np.int32)
    cmask = np.zeros((B, C), np.float32)
    for b, (start, n) in enumerate(((3, 5), (10, 8), (0, 1))):
        tg = rng.integers(0, VOCAB, n)
        full_t[b, start:start + n] = tg
        full_m[b, start:start + n] = 1
        cpos[b, :n] = np.arange(start, start + n)
        ctgt[b, :n] = tg
        cmask[b, :n] = 1
    return ids, amask, full_t, full_m, cpos, ctgt, cmask


def _packed_inputs(seed=1, T=48, C=16):
    """Two packed rows of three segments each (ragged lengths and windows),
    padding slots at segment -1."""
    rng = np.random.default_rng(seed)
    reqs = [[(rng.integers(0, VOCAB, n), c) for n, c in segs]
            for segs in (((9, 3), (13, 5), (6, 2)), ((15, 4), (8, 8), (10, 1)))]
    B = len(reqs)
    ids, amask, pos = (np.zeros((B, T), np.int32) for _ in range(3))
    seg = np.full((B, T), -1, np.int32)
    cpos, ctgt, cseg = (np.zeros((B, C), np.int32) for _ in range(3))
    cmask = np.zeros((B, C), np.float32)
    for b, segs in enumerate(reqs):
        off = cslot = 0
        for s, (row, contlen) in enumerate(segs):
            n = len(row)
            ids[b, off:off + n], amask[b, off:off + n] = row, 1
            pos[b, off:off + n], seg[b, off:off + n] = np.arange(n), s
            cpos[b, cslot:cslot + contlen] = np.arange(off + n - contlen, off + n)
            ctgt[b, cslot:cslot + contlen] = row[n - contlen:]
            cmask[b, cslot:cslot + contlen] = 1
            cseg[b, cslot:cslot + contlen] = s
            cslot += contlen
            off += n
    return ids, amask, pos, seg, cpos, ctgt, cmask, cseg


@pytest.mark.parametrize("vocab_subset", [False, True])
@pytest.mark.parametrize("scorer", ["full", "gathered", "packed"])
def test_scorers_match_jax(pair, scorer, vocab_subset):
    jcfg, jparams, cfg, model = pair
    vm = None
    if vocab_subset:  # every third id; the targets move onto it, so every score is finite
        vm = np.zeros(VOCAB, bool)
        vm[::3] = True
    ids, amask, full_t, full_m, cpos, ctgt, cmask = _scorer_inputs()
    if vm is not None:
        full_t -= full_t % 3
        ctgt -= ctgt % 3
    jvm = None if vm is None else jnp.asarray(vm)
    pvm = None if vm is None else _t(vm)
    if scorer == "full":
        args = (ids, amask, full_t, full_m)
        want = jlp.continuation_scores(jparams, *map(jnp.asarray, args), jcfg, jvm)
        got = plp.continuation_scores(model, *map(_t, args), pvm)
    elif scorer == "gathered":
        args = (ids, amask, cpos, ctgt, cmask)
        want = jlp.continuation_scores_gathered(jparams, *map(jnp.asarray, args), jcfg, jvm)
        got = plp.continuation_scores_gathered(model, *map(_t, args), pvm)
        # the head at the scored positions only == the head everywhere
        _close(got, plp.continuation_scores(model, *map(_t, (ids, amask, full_t, full_m)),
                                            pvm))
    else:
        args = list(_packed_inputs())
        if vm is not None:
            args[5] -= args[5] % 3
        want = jlp.continuation_scores_packed(jparams, *map(jnp.asarray, args), jcfg, 4, jvm)
        got = plp.continuation_scores_packed(model, *map(_t, args), 4, pvm)
        assert got.shape == (2, 4)
        np.testing.assert_array_equal(got[:, 3].numpy(), 0.0)  # an unused segment slot
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    _close(got, np.asarray(want))


def test_greedy_continuations_match_jax(pair):
    jcfg, jparams, cfg, model = pair
    ids, amask, *_ = _scorer_inputs(seed=3)
    want = np.asarray(jlp.greedy_continuations(jparams, jnp.asarray(ids),
                                                jnp.asarray(amask), jcfg))
    got = plp.greedy_continuations(model, _t(ids), _t(amask)).numpy()
    np.testing.assert_array_equal(got, want)


FEWSHOT = ("an example document about w1 w2", "example query")

RANKERS = {  # name: (class name, keyword arguments, pairs)
    "bucket": ("CrossEncoderRanker", dict(batch_size=4, max_length=128), None),
    "pack_t": ("CrossEncoderRanker", dict(batch_size=4, max_length=128, pack_t=64), None),
    "pack_t_all_short": ("CrossEncoderRanker", dict(batch_size=4, max_length=128,
                                                    pack_t=128),
                         [(f"q{i}", f"d{i} body") for i in range(7)]),
    "fewshot": ("CrossEncoderRanker", dict(batch_size=4, max_length=128, fewshots=FEWSHOT,
                                           prompt_doc="Document:\n{}\nQuery:\n",
                                           prompt_doc_start="Document:\n{}\nQuery:\n{}\n"),
                None),
    "no_prompt": ("CrossEncoderRanker", dict(batch_size=4, max_length=128,
                                             use_prompt=False), None),
    # documents of 60-90 words against max_length 48: left truncation keeps
    # the instruction prefix
    "truncation": ("CrossEncoderRanker", dict(batch_size=2, max_length=48), None),
    "truncation_pack_t": ("CrossEncoderRanker", dict(batch_size=2, max_length=48,
                                                     pack_t=48), None),
    "yesno": ("YesNoRanker", dict(batch_size=4, max_length=128), None),
    "yesno_pack_t": ("YesNoRanker", dict(batch_size=4, max_length=128, pack_t=128), None),
    "yesno_fewshot": ("YesNoRanker", dict(batch_size=4, max_length=128, fewshots=FEWSHOT,
                                          prompt_doc="\nDocument: {}\nQuery: {}\nBot:",
                                          prompt_doc_start="Document: {}\nQuery: {}\nBot:"),
                      None),
}


@pytest.mark.parametrize("name", list(RANKERS))
def test_ranker_matches_jax(pair, name):
    jcfg, jparams, cfg, model = pair
    cls, kw, pairs = RANKERS[name]
    pairs = pairs or _ragged_pairs()
    port = getattr(pce, cls)(model, cfg, TOK, device="cpu", **kw)
    ref = getattr(jce, cls)(jparams, jcfg, TOK, **kw)
    assert (port.instruction_len, port.fewshot_prefix) == (ref.instruction_len,
                                                           ref.fewshot_prefix)
    got = port.predict(pairs)
    assert isinstance(got, list) and len(got) == len(pairs)
    _close(got, ref.predict(pairs))
    if len(pairs) > 11:
        assert got[5] == got[2] == got[11]  # dedup fan-out
    if name.startswith("truncation"):
        ctx = TOK.encode(port.prompt_doc.format(pairs[0][1]))
        cont = TOK.encode(pairs[0][0])
        inp, inplen, contlen = port._pack(ctx, cont)
        assert (inp, inplen, contlen) == ref._pack(ctx, cont)
        assert inplen == 48 and inp[:port.instruction_len] == ctx[:port.instruction_len]
        assert inp[inplen - (contlen - 1):] == cont[:-1]


@pytest.mark.parametrize("cls", ["CrossEncoderRanker", "YesNoRanker"])
def test_packed_equals_unpacked(pair, cls):
    _, _, cfg, model = pair
    pairs = _ragged_pairs(30, seed=3)
    base = getattr(pce, cls)(model, cfg, TOK, device="cpu", batch_size=4, max_length=128)
    packed = getattr(pce, cls)(model, cfg, TOK, device="cpu", batch_size=4, max_length=128,
                               pack_t=64)
    _close(packed.predict(pairs), base.predict(pairs))


def test_packed_ranker_matches_jax_fused_kernel():
    """JAX's fused Pallas K1 (interpret mode on the CPU: T=192 lies in its
    [160, 512] window) on packed and bucketed rows == the port's plain K1."""
    jcfg, jparams, cfg, model = _pair(max_position_embeddings=256)
    jcfg = jcfg.replace(fused_attention=True)
    pairs = _ragged_pairs(12)
    kw = dict(batch_size=4, max_length=192, pack_t=192)
    got = pce.CrossEncoderRanker(model, cfg, TOK, device="cpu", **kw).predict(pairs)
    _close(got, jce.CrossEncoderRanker(jparams, jcfg, TOK, **kw).predict(pairs))


def test_rerank_matches_jax(pair):
    jcfg, jparams, cfg, model = pair
    corpus = {f"d{i}": {"title": "T" if i % 2 else "", "text": f"document number {i} w{i}"}
              for i in range(6)}
    queries = {"q0": "find document w3", "q1": "number"}
    first = {"q0": {f"d{i}": float(6 - i) for i in range(6)},
             "q1": {"d5": 1.0, "d0": 2.0, "d2": 0.5}}
    got = pce.rerank(pce.CrossEncoderRanker(model, cfg, TOK, device="cpu", max_length=64),
                     corpus, queries, first, top_k=2)
    want = jce.rerank(jce.CrossEncoderRanker(jparams, jcfg, TOK, max_length=64),
                      corpus, queries, first, top_k=2)
    assert {q: set(h) for q, h in got.items()} == {q: set(h) for q, h in want.items()}
    assert set(got["q0"]) == {"d0", "d1"}
    for q in want:
        _close([got[q][d] for d in want[q]], list(want[q].values()))


ERRORS = {  # name: (ranker keyword arguments, pairs or None, message)
    "pack_t_low": (dict(pack_t=8), None, "pack_t"),
    "pack_t_high": (dict(pack_t=129), None, "pack_t"),
    "fewshot_without_prompt": (dict(fewshots=FEWSHOT, use_prompt=False), None, "fewshots"),
    "continuation_too_long": (dict(max_length=16), [(" ".join(["q"] * 20), "d")],
                              "continuation"),
    "instruction_and_continuation": (dict(max_length=30), [(" ".join(["q"] * 20), "doc")],
                                     "instruction"),
}


@pytest.mark.parametrize("name", list(ERRORS))
def test_errors_match_jax(pair, name):
    jcfg, jparams, cfg, model = pair
    kw, pairs, match = ERRORS[name]
    for build in (lambda: jce.CrossEncoderRanker(jparams, jcfg, TOK, **kw),
                  lambda: pce.CrossEncoderRanker(model, cfg, TOK, device="cpu", **kw)):
        with pytest.raises(ValueError, match=match):
            build().predict(pairs or [])


MESH = make_mesh(dp=2, tp=1, devices=["cpu", "cpu"])


@pytest.mark.parametrize("kw,exc,match", [
    (dict(quantize="int4"), ValueError, "quantize"),
    (dict(mesh=MESH, device="cuda:1"), ValueError, "first device"),
    (dict(max_length=129), ValueError, "positions")])
def test_ranker_refuses_what_it_cannot_run(pair, kw, exc, match):
    _, _, cfg, model = pair
    kw = {"device": "cpu", **kw}
    with pytest.raises(exc, match=match):
        pce.CrossEncoderRanker(model, cfg, TOK, **kw)


@pytest.mark.parametrize("pack_t", [None, 64])
def test_ranker_on_a_mesh_matches_the_meshless_ranker(pair, pack_t):
    """`mesh=` (dp 2; tests/test_torch_mesh_serving.py holds meshes to the
    JAX ranker's): each dp row scores its block of rows, the same scores."""
    _, _, cfg, model = pair
    pairs = _ragged_pairs()
    kw = dict(batch_size=4, max_length=128, pack_t=pack_t)
    got = pce.CrossEncoderRanker(model, cfg, TOK, mesh=MESH, **kw).predict(pairs)
    _close(got, pce.CrossEncoderRanker(model, cfg, TOK, device="cpu", **kw).predict(pairs))


def test_ranker_refuses_token_ids_outside_the_vocab(pair):
    """A tokenizer with a larger vocab than the model's: refused on the host
    (on the card the embedding lookup would be a device assert)."""
    _, _, cfg, model = pair
    ranker = pce.CrossEncoderRanker(model, cfg, SimpleTokenizer(vocab_size=50257),
                                    device="cpu", max_length=64)
    with pytest.raises(ValueError, match="outside"):
        ranker.predict([("some query words", "a document with many words")])


def test_packed_forward_matches_jax(pair):
    """The decoder's packed path (segments, per-segment positions) == JAX's."""
    jcfg, jparams, cfg, model = pair
    ids, amask, pos, seg, *_ = _packed_inputs()
    want = np.asarray(jax_forward(jparams, *map(jnp.asarray, (ids, amask)), jcfg,
                                  position_ids=jnp.asarray(pos),
                                  segment_ids=jnp.asarray(seg)))
    with torch.inference_mode():
        got = model(_t(ids), _t(amask), position_ids=_t(pos), segment_ids=_t(seg)).numpy()
    valid = amask[..., None].astype(bool)
    np.testing.assert_allclose(np.where(valid, got, 0), np.where(valid, want, 0), atol=1e-4)
