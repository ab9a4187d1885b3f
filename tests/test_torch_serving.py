"""Port's serving layer: the `MicroBatcher` cases of tests/test_serving.py,
and a `SearchService` over a tiny GPT-Neo engine (the default block-max
index and `index_kw={"kernel": "pallas"}`) behind `make_server` on an
ephemeral port, spoken to over real HTTP.

Parity: with the weights of the JAX service and fp32 indexes on both sides,
the port's /search answers hold the JAX service's ids in the same order and
scores within 1e-5 (the engines' embeddings agree to ~1e-6); with the JAX
service's cross-encoder weights too, /rerank's answers hold its ids in the
same order, first-stage scores within 1e-5 and CE scores within rtol 2e-5,
atol 1e-4 (summed log-probs).
"""
import http.client
import json
import os
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
os.environ.setdefault("JAX_PLATFORMS", "cpu")
pytest.importorskip("jax").config.update("jax_platforms", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sgpt_tpu.crossencoder import CrossEncoderRanker as JaxRanker  # noqa: E402
from sgpt_tpu.encoder import EmbeddingEngine as JaxEngine  # noqa: E402
from sgpt_tpu.models import init_params as jax_init_params  # noqa: E402
from sgpt_tpu.models import tiny as jax_tiny  # noqa: E402
from sgpt_tpu.serving import SearchService as JaxService  # noqa: E402
from sgpt_tpu.tokenization import SimpleTokenizer  # noqa: E402
from sgpt_tpu_torch.crossencoder import CrossEncoderRanker  # noqa: E402
from sgpt_tpu_torch.encoder import EmbeddingEngine  # noqa: E402
from sgpt_tpu_torch.models import Decoder, from_jax_config, params_from_jax  # noqa: E402
from sgpt_tpu_torch.serving import MicroBatcher, SearchService, make_server  # noqa: E402


# ---------------------------------------------------------------------------
# MicroBatcher (the cases of tests/test_serving.py)
# ---------------------------------------------------------------------------
def test_microbatcher_results_align():
    b = MicroBatcher(lambda items: [x * 2 for x in items], max_wait_ms=1)
    try:
        assert b([1, 2, 3]) == [2, 4, 6]
        assert b([]) == []
        assert b.items_processed == 3
    finally:
        b.close()


@pytest.mark.parametrize("max_items,want", [(1024, [[1, 2, 3]]), (2, [[1, 2], [3]])])
def test_microbatcher_coalesces_up_to_max_items(max_items, want):
    """Requests arriving while a dispatch runs ride ONE next dispatch (the
    first call blocks on a gate while the others enqueue), capped at max_items."""
    gate = threading.Event()
    calls = []

    def fn(items):
        calls.append(sorted(items))
        gate.wait(5)
        return items

    b = MicroBatcher(fn, max_items=max_items, max_wait_ms=200)
    try:
        futs = [b.submit([0])]
        while not calls:
            time.sleep(0.005)
        futs += [b.submit([i]) for i in (1, 2, 3)]
        gate.set()
        assert [f.result(timeout=5) for f in futs] == [[0], [1], [2], [3]]
        assert calls[1:] == want
    finally:
        b.close()


def test_microbatcher_error_propagates_and_keeps_serving():
    def fn(items):
        if "boom" in items:
            raise RuntimeError("boom")
        return items

    b = MicroBatcher(fn, max_wait_ms=1)
    try:
        with pytest.raises(RuntimeError, match="boom"):
            b(["boom"])
        assert b(["ok"]) == ["ok"]
    finally:
        b.close()


def test_microbatcher_submit_after_close_fails_fast():
    mb = MicroBatcher(lambda items: [x * 2 for x in items], max_wait_ms=1.0)
    assert mb([1, 2]) == [2, 4]
    mb.close()
    with pytest.raises(RuntimeError, match="close"):
        mb.submit([3])


# ---------------------------------------------------------------------------
# SearchService + HTTP over a tiny engine
# ---------------------------------------------------------------------------
DOCS = {
    "py": "python is a programming language",
    "gpu": "graphics processing units accelerate matrix multiplication",
    "sea": "the pacific ocean is the largest body of water",
    "moon": "the moon orbits the earth every twenty seven days",
}
QUERIES = ["a programming language", "the largest ocean", "matrix multiplication",
           "what orbits the earth", "python"]


@pytest.fixture(scope="module")
def engines():
    jcfg = jax_tiny("neo", num_layers=2)
    jparams = jax_init_params(jcfg, jax.random.key(0))
    cfg = from_jax_config(jcfg)
    model = Decoder(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams), cfg))
    tok = SimpleTokenizer(cfg.vocab_size)
    kw = dict(method="weightedmean", specb=True, batch_size=4, max_seq_len=64,
              normalize_embeddings=True)
    return EmbeddingEngine(model, cfg, tok, device="cpu", **kw), JaxEngine(jparams, jcfg, tok, **kw)


@pytest.fixture(scope="module", params=["blockmax", "pallas"])
def served(request, engines):
    svc = SearchService(engines[0], index_kw={"kernel": request.param}, max_wait_ms=1.0)
    svc.add_documents(list(DOCS.values()), ids=list(DOCS), build=True)
    srv = make_server(svc, port=0, model_name="tiny-neo")
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        yield request.param, svc, srv
    finally:
        srv.shutdown()
        srv.server_close()
        svc.close()


def _post(server, path, payload):
    conn = http.client.HTTPConnection(*server.server_address[:2], timeout=30)
    try:
        conn.request("POST", path, json.dumps(payload), {"Content-Type": "application/json"})
        r = conn.getresponse()
        return r.status, json.loads(r.read().decode())
    finally:
        conn.close()


def _get(server, path):
    conn = http.client.HTTPConnection(*server.server_address[:2], timeout=30)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        return r.status, json.loads(r.read().decode())
    finally:
        conn.close()


@pytest.mark.parametrize("kernel", ["blockmax", "pallas"])
def test_search_matches_jax_service(engines, kernel):
    engine, jengine = engines
    port = SearchService(engine, index_kw={"kernel": kernel, "dtype": torch.float32},
                         max_wait_ms=1.0)
    ref = JaxService(jengine, index_kw={"kernel": kernel, "dtype": jnp.float32},
                     max_wait_ms=1.0)
    try:
        assert port.index.device == engine.device and port.index.kernel == kernel
        for svc in (port, ref):
            svc.add_documents(list(DOCS.values()), ids=list(DOCS), build=True)
            svc.add_documents(["a pending document about volcanoes"], ids=["volc"])
        for k in (1, 3, 5):
            got = port.search(QUERIES, k=k, return_documents=True)
            want = ref.search(QUERIES, k=k, return_documents=True)
            assert [[h["id"] for h in r] for r in got] == [[h["id"] for h in r] for r in want]
            assert [[h["document"] for h in r] for r in got] == \
                [[h["document"] for h in r] for r in want]
            np.testing.assert_allclose([h["score"] for r in got for h in r],
                                       [h["score"] for r in want for h in r], atol=1e-5)
        st, jst = port.stats(), ref.stats()
        for key in ("documents", "pending_docs", "queries_served", "out_dim"):
            assert st[key] == jst[key], key
    finally:
        port.close()
        ref.close()


@pytest.mark.parametrize("pack_t", [None, 64])
def test_rerank_matches_jax_service(engines, pack_t):
    """The two-stage /rerank (first_k by the index, then the CE) of the port's
    service == the JAX service's, over HTTP on the port's side."""
    engine, jengine = engines
    kw = dict(max_length=64, batch_size=4, pack_t=pack_t)
    port = SearchService(engine, index_kw={"dtype": torch.float32}, max_wait_ms=1.0,
                         ranker=CrossEncoderRanker(engine.model, engine.cfg, engine.tokenizer,
                                                   device="cpu", **kw))
    ref = JaxService(jengine, index_kw={"dtype": jnp.float32}, max_wait_ms=1.0,
                     ranker=JaxRanker(jengine.params, jengine.cfg, jengine.tokenizer, **kw))
    srv = make_server(port, port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        for svc in (port, ref):
            svc.add_documents(list(DOCS.values()), ids=list(DOCS), build=True)
        status, body = _post(srv, "/rerank", {"queries": QUERIES, "k": 3, "first_k": 4,
                                              "return_documents": True})
        assert status == 200
        got, want = body["results"], ref.rerank(QUERIES, k=3, first_k=4,
                                                 return_documents=True)
        assert [[(h["id"], h["document"]) for h in r] for r in got] == \
            [[(h["id"], h["document"]) for h in r] for r in want]
        np.testing.assert_allclose([h["score"] for r in got for h in r],
                                   [h["score"] for r in want for h in r], atol=1e-5)
        np.testing.assert_allclose([h["ce_score"] for r in got for h in r],
                                   [h["ce_score"] for r in want for h in r],
                                   rtol=2e-5, atol=1e-4)
    finally:
        srv.shutdown()
        srv.server_close()
        port.close()
        ref.close()


def test_http_healthz_stats_embeddings(served):
    _, svc, srv = served
    assert _get(srv, "/healthz") == (200, {"status": "ok"})
    status, stats = _get(srv, "/stats")
    assert status == 200 and stats["documents"] >= len(DOCS)
    assert _get(srv, "/nope")[0] == 404
    status, body = _post(srv, "/v1/embeddings", {"input": ["hello world", "second text"]})
    assert status == 200 and body["object"] == "list" and body["model"] == "tiny-neo"
    assert [d["index"] for d in body["data"]] == [0, 1]
    emb = np.array(body["data"][0]["embedding"])
    assert emb.shape == (svc.engine.out_dim,)
    assert np.linalg.norm(emb) == pytest.approx(1.0, abs=1e-2)
    assert body["usage"]["prompt_tokens"] == 4
    np.testing.assert_allclose(emb, svc.embed(["hello world"])[0], atol=1e-6)
    assert _post(srv, "/v1/embeddings", {"input": []}) == (
        200, {"object": "list", "model": "tiny-neo", "data": [],
              "usage": {"prompt_tokens": 0, "total_tokens": 0}})


def test_http_search_documents_rebuild(served):
    kernel, svc, srv = served
    status, body = _post(srv, "/search", {"queries": [DOCS["gpu"]], "k": 3,
                                          "return_documents": True})
    assert status == 200
    hits = body["results"][0]
    assert hits[0]["id"] == "gpu" and hits[0]["document"] == DOCS["gpu"]
    # the HTTP answer equals a direct search of the index
    vals, ids = svc.index.search_embeddings(svc.embed([DOCS["gpu"]], is_query=True), k=3)
    assert [h["id"] for h in hits] == ids[0]
    np.testing.assert_allclose([h["score"] for h in hits], vals[0], atol=1e-6)

    status, body = _post(srv, "/documents", {
        "documents": [{"id": f"http-{kernel}", "text": "added over http"}]})
    assert status == 200 and body["added"] == 1 and body["pending_docs"] == 1
    status, body = _post(srv, "/search", {"queries": ["added over http"], "k": 1})
    assert body["results"][0][0]["id"] == f"http-{kernel}"
    status, body = _post(srv, "/rebuild", {})
    assert status == 200 and body["documents"] == svc.stats()["documents"]
    assert svc.stats()["pending_docs"] == 0
    status, body = _post(srv, "/documents", {"texts": ["auto id one", "auto id two"]})
    assert status == 200 and len(set(body["ids"])) == 2
    assert _post(srv, "/search", {"queries": []}) == (200, {"results": []})


def test_http_delete(served):
    kernel, svc, srv = served
    _post(srv, "/documents", {"documents": [{"id": "del-a", "text": "delete me aa"}],
                              "build": True})
    status, out = _post(srv, "/documents/delete", {"ids": ["del-a"]})
    if kernel == "pallas":  # the streaming kernel has no tombstone mask: 400, as in JAX
        assert status == 400 and "blockmax" in out["error"]
        return
    assert status == 200 and out["deleted"] == 1
    status, out = _post(srv, "/search", {"queries": ["delete me aa"], "k": 5})
    assert "del-a" not in [h["id"] for h in out["results"][0]]
    assert _post(srv, "/documents/delete", {"ids": ["nope"]})[0] == 400
    assert _post(srv, "/documents/delete", {"ids": "x"})[0] == 400


def test_http_bad_requests_and_rerank_without_ranker(served, engines):
    _, _, srv = served
    assert _post(srv, "/v1/embeddings", {})[0] == 400
    assert _post(srv, "/search", {"queries": "not a list"})[0] == 400
    assert _post(srv, "/search", {"queries": ["q"], "k": 0})[0] == 400
    assert _post(srv, "/documents", {"texts": "nope"})[0] == 400
    assert _post(srv, "/documents", {"texts": ["a"], "ids": [""]})[0] == 400
    status, out = _post(srv, "/rerank", {"queries": ["q"]})
    ref = JaxService(engines[1], max_wait_ms=1.0)
    try:
        with pytest.raises(ValueError) as want:
            ref.rerank(["q"])
    finally:
        ref.close()
    assert (status, out) == (400, {"error": str(want.value)})


def test_http_save_and_load_index(served, tmp_path):
    kernel, svc, srv = served
    assert _post(srv, "/save", {"path": str(tmp_path / "x")})[0] == 403
    assert _post(srv, "/save", {})[0] == 400
    srv2 = make_server(svc, port=0, index_path=str(tmp_path / "idx"))
    threading.Thread(target=srv2.serve_forever, daemon=True).start()
    try:
        status, out = _post(srv2, "/save", {})
        assert status == 200 and out["documents"] == len(svc.index)
    finally:
        srv2.shutdown()
        srv2.server_close()
    index, documents = SearchService.load_index(str(tmp_path / "idx"), kernel=kernel,
                                                device="cpu")
    assert documents == svc.documents and len(index) == len(svc.index)
    q = svc.embed(QUERIES, is_query=True)
    assert index.search_embeddings(q, k=3)[1] == svc.index.search_embeddings(q, k=3)[1]


def test_concurrent_searches_coalesce(served):
    _, svc, srv = served
    before = svc._q_batcher.dispatches
    errs, results = [], {}

    def one(i):
        try:
            status, body = _post(srv, "/search", {"queries": [DOCS["sea"]], "k": 1 + i % 3})
            assert status == 200
            results[i] = [h["id"] for h in body["results"][0]]
        except Exception as e:  # pragma: no cover
            errs.append(e)

    threads = [threading.Thread(target=one, args=(i,)) for i in range(12)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errs
    assert all(r[0] == "sea" and len(r) == 1 + i % 3 for i, r in results.items())
    assert svc._q_batcher.dispatches - before < 12


def test_warm_search_and_empty_service(engines):
    svc = SearchService(engines[0])
    try:
        assert svc.index.device == engines[0].device and svc.index.kernel == "blockmax"
        svc.warm_search()  # empty, unbuilt index: a no-op
        assert svc.rebuild() == 0
        svc.add_documents(list(DOCS.values()), ids=list(DOCS))
        svc.warm_search(max_queries=4, ks=(1, 2))
        assert svc.search([DOCS["moon"]], k=1)[0][0]["id"] == "moon"
    finally:
        svc.close()


def test_load_index_refuses_ivf(tmp_path, engines):
    """An IVF directory saved by the JAX service loads as the port's
    `IVFIndex` (the class comes from the file's metadata), with its
    documents, and serves what the JAX service serves; loaded onto a dp=2
    mesh, it searches as JAX's index loaded onto its dp=2 mesh."""
    from sgpt_tpu.index_ivf import IVFIndex as JaxIVF
    from sgpt_tpu_torch.index_ivf import IVFIndex

    d = tmp_path / "ivf"
    ref = JaxService(engines[1], JaxIVF(engines[1].out_dim, n_clusters=2, nprobe=1,
                                        quantize="int8"))
    try:
        ref.add_documents(list(DOCS.values()), ids=list(DOCS), build=True)
        ref.save(str(d))
        want = ref.search(QUERIES, k=3, return_documents=True)
    finally:
        ref.close()
    index, documents = SearchService.load_index(str(d), device="cpu")
    assert isinstance(index, IVFIndex) and index.quantize == "int8" and index.nprobe == 1
    assert documents == DOCS and len(index) == len(DOCS)
    svc = SearchService(engines[0], index, documents=documents)
    try:
        got = svc.search(QUERIES, k=3, return_documents=True)
    finally:
        svc.close()
    assert [[h["id"] for h in r] for r in got] == [[h["id"] for h in r] for r in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose([h["score"] for h in g], [h["score"] for h in w], atol=1e-5)
        assert [h["document"] for h in g] == [h["document"] for h in w]
    from sgpt_tpu.parallel import make_mesh as jax_make_mesh
    from sgpt_tpu_torch.parallel import make_mesh

    sharded, _ = SearchService.load_index(str(d), mesh=make_mesh(2, 1, ["cpu", "cpu"]))
    jsharded, _ = JaxService.load_index(str(d), mesh=jax_make_mesh(2, 1, jax.devices()[:2]))
    q = engines[0].encode(QUERIES)
    (got_v, got_i), (want_v, want_i) = (sharded.search_embeddings(q, k=3),
                                        jsharded.search_embeddings(q, k=3))
    assert sharded.mesh is not None and got_i == want_i
    for g, w in zip(got_v, want_v):
        np.testing.assert_allclose(g, w, atol=1e-5)

