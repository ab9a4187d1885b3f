"""The program's profiler spans and the micro-batchers' queue counters, on
the CPU: `utils.profiling.span` (one shared no-op when no profiler records,
an op-level range when one does), the spans of the engine, the
cross-encoder, the micro-batchers' dispatcher threads and the search path
(nested on the thread that ran them, under a profiler of every thread),
`profile_trace` recording a thread started before it, and the
`MicroBatcher` / `SearchService.stats()` counters."""
import json
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from sgpt_tpu_torch.crossencoder import CrossEncoderRanker  # noqa: E402
from sgpt_tpu_torch.encoder import EmbeddingEngine  # noqa: E402
from sgpt_tpu_torch.models import Decoder, tiny  # noqa: E402
from sgpt_tpu_torch.serving import MicroBatcher, SearchService  # noqa: E402
from sgpt_tpu_torch.tokenization import SimpleTokenizer  # noqa: E402
from sgpt_tpu_torch.utils import profile_trace, profiling, span  # noqa: E402

HOLD_S = 0.05
TEXTS = ["a short text", "a much longer text " * 12, "x", "two words", "y z " * 30]


@pytest.fixture(scope="module")
def model():
    cfg = tiny("neo", num_layers=1, hidden_size=32, num_heads=2, vocab_size=128)
    return Decoder(cfg, device="cpu", generator=torch.Generator().manual_seed(0)), cfg


@pytest.fixture(scope="module")
def engine(model):
    m, cfg = model
    return EmbeddingEngine(m, cfg, SimpleTokenizer(cfg.vocab_size), device="cpu", specb=True,
                           max_seq_len=64, batch_size=2, normalize_embeddings=True)


def every_thread():
    """A CPU profiler that records every thread."""
    return profile(activities=[ProfilerActivity.CPU],
                   experimental_config=torch._C._profiler._ExperimentalConfig(
                       profile_all_threads=True))


def host_events(prof, prefixes):
    """(name, thread, start_ns, end_ns) of the recorded host events whose
    name starts with one of `prefixes`, in start order."""
    return sorted(((e.name(), e.start_thread_id(), e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.name().startswith(prefixes)), key=lambda x: x[2])


def inside(inner, outer) -> bool:
    return inner[1] == outer[1] and outer[2] <= inner[2] and inner[3] <= outer[3]


def test_span_off_is_one_shared_null_context_and_records_nothing(monkeypatch):
    """No profiler: span() is the one shared null context and creates no
    profiler range; under a profiler it creates one per call, with its ints."""
    made = []
    real = torch._C._profiler._RecordFunctionFast

    def counting(*a):
        made.append(a)
        return real(*a)

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", counting)
    assert not torch.autograd.profiler._is_profiler_enabled
    a, b = span("x"), span("y", seq=1, items=2)
    assert a is b is profiling._OFF
    with a, b:
        pass
    assert made == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("outer.span", seq=3, items=2):
            with span("inner.span"):
                torch.ones(4).sum()
    assert made == [("outer.span", (), {"seq": 3, "items": 2}), ("inner.span", (), {})]
    outer, inner = host_events(prof, ("outer.span", "inner.span"))
    assert outer[0] == "outer.span" and inside(inner, outer)


def test_engine_and_ce_spans_on_the_calling_thread(model, engine):
    """One encode names its tokenize and plan once, a pad and a dispatch per
    batch and a drain per fetch, in that nesting-free order, and gives the
    embeddings it gives unprofiled; the cross-encoder's bucket and packed
    paths name theirs."""
    want = engine.encode(TEXTS)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = engine.encode(TEXTS)
    np.testing.assert_array_equal(got, want)
    ev = host_events(prof, ("engine.",))
    names = [e[0] for e in ev]
    assert names[:2] == ["engine.tokenize", "engine.plan"]
    n_batches = names.count("engine.pad")
    assert n_batches == names.count("engine.dispatch") >= 2
    assert 1 <= names.count("engine.drain") <= n_batches
    for a, b in zip(ev, ev[1:]):   # one thread, no span inside another
        assert a[3] <= b[2] and a[1] == b[1]

    m, cfg = model
    pairs = [("query text", "a document " * n) for n in (1, 3, 20, 40)]
    for pack_t in (None, 64):
        ranker = CrossEncoderRanker(m, cfg, SimpleTokenizer(cfg.vocab_size), device="cpu",
                                    max_length=128, batch_size=2, pack_t=pack_t)
        want = ranker.predict(pairs)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            got = ranker.predict(pairs)
        assert got == want
        names = [e[0] for e in host_events(prof, ("ce.",))]
        assert names[0] == "ce.tokenize" and names[1] == "ce.plan"
        # the packed path plans its bins once more
        assert names.count("ce.plan") == (1 if pack_t is None else 2)
        assert names.count("ce.pad") == names.count("ce.dispatch") >= 1
        assert names.count("ce.drain") == names.count("ce.dispatch")


@pytest.mark.parametrize("pack_t", [None, 64], ids=["buckets", "packed"])
def test_ce_pad_spans_count_each_dispatch_and_the_real_tokens(model, pack_t, monkeypatch):
    """Each `ce.pad` names its dispatch's rows, T and real tokens: the rows
    and T of the forward it feeds, and tokens that sum to the call's input
    tokens (each distinct pair's row, once)."""
    made = []
    real = torch._C._profiler._RecordFunctionFast

    def recording(name, a, kw):
        made.append((name, kw))
        return real(name, a, kw)

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", recording)
    m, cfg = model
    tok = SimpleTokenizer(cfg.vocab_size)
    pairs = [("query text", "a document " * n) for n in (1, 3, 20, 40, 3)]
    ranker = CrossEncoderRanker(m, cfg, tok, device="cpu", max_length=128, batch_size=2,
                                pack_t=pack_t)
    shapes = []
    hook = m.register_forward_pre_hook(lambda mod, a: shapes.append(tuple(a[0].shape)))
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            ranker.predict(pairs)
    finally:
        hook.remove()
    pads = [kw for name, kw in made if name == "ce.pad"]
    assert [(kw["rows"], kw["T"]) for kw in pads] == shapes
    want = sum(ranker._pack(tok.encode(ranker.prompt_doc.format(d)), tok.encode(q))[1]
               for q, d in set(pairs))
    assert sum(kw["tokens"] for kw in pads) == want
    assert all(0 < kw["tokens"] <= kw["rows"] * kw["T"] for kw in pads)


def test_dispatcher_thread_spans_nest_under_a_profiler_of_every_thread(engine):
    """A service whose dispatcher threads start before the profiler: each
    batcher's collect, dispatch and resolve follow each other on its own
    thread, the engine's spans nest in the enc-query dispatch and
    search.stack and index.search in the search dispatch; search.assemble
    runs on the caller's thread."""
    svc = SearchService(engine, index_kw={"dtype": torch.float32}, max_wait_ms=1.0)
    try:
        svc.add_documents(TEXTS, ids=[str(i) for i in range(len(TEXTS))], build=True)
        with every_thread() as prof:
            hits = svc.search(["a short query"], k=2)
    finally:
        svc.close()
    assert len(hits[0]) == 2
    ev = host_events(prof, ("batcher.", "engine.", "search.", "index."))
    by = {}
    for e in ev:
        by.setdefault(e[0], []).append(e)
    for name in ("enc-query", "search"):
        (c,), (d,), (r,) = (by[f"batcher.{name}.{s}"] for s in ("collect", "dispatch", "resolve"))
        assert c[1] == d[1] == r[1] and c[3] <= d[2] and d[3] <= r[2]
    q_dispatch, s_dispatch = by["batcher.enc-query.dispatch"][0], by["batcher.search.dispatch"][0]
    assert q_dispatch[1] != s_dispatch[1]
    for name in ("engine.tokenize", "engine.plan", "engine.pad", "engine.dispatch",
                 "engine.drain"):
        assert by[name] and all(inside(e, q_dispatch) for e in by[name]), name
    for name in ("search.stack", "index.search"):
        (e,) = by[name]
        assert inside(e, s_dispatch), name
    (assemble,) = by["search.assemble"]
    assert assemble[1] not in (q_dispatch[1], s_dispatch[1])


def test_profile_trace_records_a_thread_started_before_it(tmp_path):
    """profile_trace's Chrome trace holds the spans and ops of a thread that
    was running before the block began (as the dispatcher threads are)."""
    go, done, tid = threading.Event(), threading.Event(), []

    def worker():
        tid.append(threading.get_native_id())
        assert go.wait(10)
        with span("worker.span"):
            torch.mm(torch.ones(8, 8), torch.ones(8, 8))
        done.set()

    t = threading.Thread(target=worker)
    t.start()
    try:
        with profile_trace(str(tmp_path)):
            go.set()
            assert done.wait(10)
    finally:
        go.set()
        t.join(10)
    assert not t.is_alive()
    (trace,) = tmp_path.glob("*.pt.trace.json")
    events = json.loads(trace.read_text())["traceEvents"]
    on_worker = {e["name"] for e in events if e.get("tid") == tid[0] and "name" in e}
    assert {"worker.span", "aten::mm"} <= on_worker


@pytest.mark.parametrize("max_items", [1024, 1], ids=["coalesced", "one-each"])
def test_queue_wait_and_busy_time(max_items):
    """A dispatch held on an Event for HOLD_S while three requests queue:
    each queued item's wait (its dispatch's start minus its submit time) is
    at least HOLD_S, the held dispatch's busy time too; the counters are
    read as one snapshot after each dispatch."""
    release, entered = threading.Event(), threading.Event()
    calls, snaps = [], []

    def fn(items):
        calls.append(list(items))
        snaps.append(b.stats())   # the totals of the dispatches before this one
        if len(calls) == 1:
            entered.set()
            assert release.wait(10)
        return items

    b = MicroBatcher(fn, max_items=max_items, max_wait_ms=1.0, name="held")
    try:
        first = b.submit(["a"])
        assert entered.wait(10)
        queued = [b.submit([x]) for x in "bcd"]
        time.sleep(HOLD_S)
        release.set()
        assert first.result(10) == ["a"]
        assert [f.result(10) for f in queued] == [["b"], ["c"], ["d"]]
        snaps.append(b.stats())
    finally:
        b.close()
    want = [["a"], ["b", "c", "d"]] if max_items > 1 else [["a"], ["b"], ["c"], ["d"]]
    assert calls == want
    assert set(snaps[-1]) == {"dispatches", "items", "wait_s", "busy_s"}
    assert snaps[-1]["dispatches"] == len(want) and snaps[-1]["items"] == 4
    assert snaps[0] == {"dispatches": 0, "items": 0, "wait_s": 0.0, "busy_s": 0.0}
    assert snaps[1]["busy_s"] >= HOLD_S              # the held dispatch
    for prev, cur, items in zip(snaps[1:], snaps[2:], want[1:]):
        assert cur["items"] - prev["items"] == len(items)
        assert cur["wait_s"] - prev["wait_s"] >= HOLD_S * len(items)
    assert b.dispatches == snaps[-1]["dispatches"] and b.items_processed == 4


@pytest.mark.parametrize("with_ranker", [False, True], ids=["search", "search+rerank"])
def test_search_service_stats(model, engine, with_ranker):
    """stats() keeps its keys and gains `search_dispatches` and `batchers`
    (each batcher's dispatches, items, wait_s, busy_s): two queries one after
    the other are two dispatches of enc-query and of search."""
    m, cfg = model
    ranker = (CrossEncoderRanker(m, cfg, SimpleTokenizer(cfg.vocab_size), device="cpu",
                                 max_length=128, batch_size=2) if with_ranker else None)
    svc = SearchService(engine, index_kw={"dtype": torch.float32}, max_wait_ms=1.0,
                        ranker=ranker)
    try:
        svc.add_documents(TEXTS, ids=[str(i) for i in range(len(TEXTS))], build=True)
        before = svc.stats()
        svc.search(["a b"], k=2)
        svc.search(["c"], k=1)
        st = svc.stats()
    finally:
        svc.close()
    assert set(st) == {"documents", "pending_docs", "queries_served", "uptime_s",
                       "embed_dispatches", "embed_items", "out_dim", "search_dispatches",
                       "batchers"}
    names = {"enc-query", "enc-doc", "search"} | ({"rerank"} if with_ranker else set())
    assert set(st["batchers"]) == names
    for v in st["batchers"].values():
        assert set(v) == {"dispatches", "items", "wait_s", "busy_s"}
        assert v["wait_s"] >= 0 and v["busy_s"] >= 0
    assert before["search_dispatches"] == 0 and st["search_dispatches"] == 2
    bq, bs, bd = (st["batchers"][n] for n in ("enc-query", "search", "enc-doc"))
    assert bq["dispatches"] == bq["items"] == 2 and bs["dispatches"] == bs["items"] == 2
    assert bd["items"] == len(TEXTS) == before["batchers"]["enc-doc"]["items"]
    assert bq["busy_s"] > 0 and bs["busy_s"] > 0
    assert st["embed_dispatches"] == bq["dispatches"] + bd["dispatches"]
    assert st["embed_items"] == bq["items"] + bd["items"]
    assert st["queries_served"] == 2 and st["documents"] == len(TEXTS)
