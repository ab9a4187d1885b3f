"""The cross-encoder's dispatch plan (`crossencoder.plan_dispatches`), on the
CPU: every row planned once and in order, T a multiple of 16 at or above a
dispatch's longest row, no dispatch above the token budget, whole dp blocks
on a mesh, the cuts a brute force finds least, the rerank benchmark's 400
lengths at under 20 % padding (the length and row ladders' plan: 47.47 %),
and the rankers' scores under the plan equal to their scores under the
ladders' plan, on and off a two-device CPU mesh."""
import itertools
import statistics

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import sgpt_tpu_torch.crossencoder as ce  # noqa: E402
from sgpt_tpu_torch.models import Decoder, tiny  # noqa: E402
from sgpt_tpu_torch.parallel import make_mesh  # noqa: E402
from sgpt_tpu_torch.tokenization import SimpleTokenizer  # noqa: E402
from sgpt_tpu_torch.tokenization.specb import (DEFAULT_BUCKETS, ROW_BUCKETS,  # noqa: E402
                                               pick_bucket, row_bucket)

RTOL, ATOL = 2e-5, 1e-4
COST = ce.CrossEncoderRanker.DISPATCH_COST


def ladder_plan(lengths, budget, cap):
    """The length and row ladders' plan that `plan_dispatches` replaced:
    [(start, n, T, B)], B the rows a dispatch pads to."""
    out, i = [], 0
    while i < len(lengths):
        T = max(pick_bucket(lengths[i], DEFAULT_BUCKETS, cap), lengths[i])
        B = row_bucket(max(1, budget // T), allow_overshoot=T < cap)
        n = min(B, len(lengths) - i)
        out.append((i, n, T, B))
        i += n
    return out


def check_plan(plan, lengths, budget, dp=1, cap=2048):
    """The plan's invariants; returns its slots (pad rows included)."""
    i, slots = 0, 0
    for start, n, T in plan:
        assert start == i and n >= 1
        assert lengths[start] <= T <= cap and (T % 16 == 0 or T == cap)
        rows = -(-n // dp) * dp
        assert rows * T <= budget or rows == dp
        assert n <= ROW_BUCKETS[-1]
        i += n
        slots += rows * T
    assert i == len(lengths)
    return slots


def descending(rng, n, hi):
    return sorted(rng.integers(1, hi + 1, n).tolist(), reverse=True)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("dp", [1, 2, 3])
def test_plan_covers_every_row_in_order_within_the_budget(seed, dp):
    rng = np.random.default_rng(seed)
    lengths = descending(rng, int(rng.integers(1, 400)), 2048)
    budget = int(rng.choice([2048, 8192, 32768]))
    plan = ce.plan_dispatches(lengths, budget, COST, 2048, row_multiple=dp)
    check_plan(plan, lengths, budget, dp=dp)


def test_plan_caps_T_at_max_length_and_rows_at_the_ladders_top():
    """max_length 300 (no multiple of 16): a 297-token row takes T=300, not
    304 (a learned position table ends at max_length); 2,000 short rows take
    dispatches of at most 512 rows, the ladder's top, however large the
    budget (the (rows, C, vocab) logits)."""
    lengths = [297, 290, 150, 20]
    plan = ce.plan_dispatches(lengths, 16 * 300, COST, 300)
    assert plan[0][2] == 300
    check_plan(plan, lengths, 16 * 300, cap=300)
    plan = ce.plan_dispatches([5] * 2000, 1 << 20, COST, 2048)
    assert max(n for _, n, _ in plan) == ROW_BUCKETS[-1]
    check_plan(plan, [5] * 2000, 1 << 20)


def test_plan_keeps_whole_dp_blocks_when_dp_rows_exceed_the_budget():
    """batch_size 1 at max_length 2,048 on dp 4: 4 rows at T=2,000 exceed the
    budget, and the mesh still takes whole blocks of 4 rows."""
    lengths = [2000] * 6 + [100] * 3
    plan = ce.plan_dispatches(lengths, 2048, COST, 2048, row_multiple=4)
    check_plan(plan, lengths, 2048, dp=4)
    assert [(-(-n // 4) * 4, T) for _, n, T in plan if T == 2000] == [(4, 2000)] * 2


@pytest.mark.parametrize("seed", range(8))
def test_plan_cuts_where_a_brute_force_finds_the_least_cost(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 11))
    lengths = descending(rng, n, 300)
    budget, cost = int(rng.choice([512, 1024, 4096])), int(rng.choice([0, 64, 512]))

    def total(plan):
        return sum(m * T + cost for _, m, T in plan)

    best = None
    for k in range(n):
        for cuts in itertools.combinations(range(1, n), k):
            edges = (0,) + cuts + (n,)
            plan = [(a, b - a, -(-lengths[a] // 16) * 16) for a, b in zip(edges, edges[1:])]
            if all(m * T <= budget for _, m, T in plan):
                best = total(plan) if best is None else min(best, total(plan))
    plan = ce.plan_dispatches(lengths, budget, cost, 2048)
    check_plan(plan, lengths, budget)
    assert total(plan) == best


def test_plan_refuses_lengths_out_of_order():
    with pytest.raises(ValueError, match="non-increasing"):
        ce.plan_dispatches([10, 20], 1024, COST, 2048)
    assert ce.plan_dispatches([], 1024, COST, 2048) == []


def rerank_cell_lengths():
    """The rerank benchmark's rows: 400 documents whose words are the
    quantiles (i + 1/2)/400 of lognormal(5, 1) clipped to [20, 1,400], each
    under prompt G with a 12-word query, max_length 2,048 (one token a word:
    the hash tokenizer)."""
    nd = statistics.NormalDist(5.0, 1.0)
    words = [int(min(1400, max(20, np.exp(nd.inv_cdf((i + 0.5) / 400))))) for i in range(400)]
    cfg = tiny("gptj", num_layers=1, hidden_size=32, num_heads=2, vocab_size=512)
    ranker = ce.CrossEncoderRanker(Decoder(cfg, device="cpu"), cfg,
                                   SimpleTokenizer(cfg.vocab_size), device="cpu",
                                   max_length=2048, batch_size=16)
    tok = ranker.tokenizer
    cont = tok.encode(" ".join(["query"] * 12))
    lens = [ranker._pack(tok.encode(ce.PROMPT_G.format(" ".join(["w"] * w))), cont)[1]
            for w in words]
    return sorted(lens, reverse=True)


def test_rerank_benchmark_lengths_pad_under_a_fifth():
    lengths = rerank_cell_lengths()
    real, budget = sum(lengths), 16 * 2048
    old = sum(B * T for _, _, T, B in ladder_plan(lengths, budget, 2048))
    assert round(100 * (1 - real / old), 2) == 47.47
    plan = ce.plan_dispatches(lengths, budget, COST, 2048)
    new = check_plan(plan, lengths, budget)
    assert 100 * (1 - real / new) <= 20


@pytest.fixture(scope="module", params=["neo", "bloom"])
def model(request):
    cfg = tiny(request.param, num_layers=2, hidden_size=32, num_heads=2, vocab_size=512)
    if request.param == "bloom":
        cfg = cfg.replace(max_position_embeddings=2048)
    return Decoder(cfg, device="cpu", generator=torch.Generator().manual_seed(3)), cfg


def mixed_pairs(n=40, seed=5):
    """One document near max_length (128) and many short ones, a duplicate."""
    rng = np.random.default_rng(seed)
    pairs = [(f"q{i} " + " ".join(f"t{j}" for j in range(int(rng.integers(1, 4)))),
              " ".join(f"d{i}w{j}" for j in range(int(rng.integers(1, 25)))))
             for i in range(n)]
    pairs[0] = ("q0 long", " ".join(f"L{j}" for j in range(112)))
    pairs[7] = pairs[3]
    return pairs


def with_ladder_plan(monkeypatch):
    def plan(lengths, budget, cost, cap, row_multiple=1):
        return [(i, n, T) for i, n, T, _ in ladder_plan(list(lengths), budget, cap)]

    monkeypatch.setattr(ce, "plan_dispatches", plan)


@pytest.mark.parametrize("dp", [1, 2])
@pytest.mark.parametrize("cls", ["CrossEncoderRanker", "YesNoRanker"])
def test_rankers_score_as_under_the_ladders_plan(model, cls, dp, monkeypatch):
    m, cfg = model
    kw = dict(max_length=128, batch_size=2)
    if dp > 1:
        kw["mesh"] = make_mesh(dp=dp, tp=1, devices=["cpu"] * dp)
    else:
        kw["device"] = "cpu"
    pairs = mixed_pairs()
    shapes = []
    hook = m.register_forward_pre_hook(lambda mod, a: shapes.append(tuple(a[0].shape)))
    try:
        got = getattr(ce, cls)(m, cfg, SimpleTokenizer(cfg.vocab_size), **kw).predict(pairs)
        planned = list(shapes)
        with monkeypatch.context() as mp:
            with_ladder_plan(mp)
            want = getattr(ce, cls)(m, cfg, SimpleTokenizer(cfg.vocab_size),
                                    **kw).predict(pairs)
    finally:
        hook.remove()
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=ATOL)
    assert got[7] == got[3]
    if dp == 1:   # on a mesh the hook sees only the model itself, not the dp groups
        assert sum(B * T for B, T in planned) < sum(B * T for B, T in shapes[len(planned):])
        assert all(T % 16 == 0 and B * T <= 2 * 128 for B, T in planned)
