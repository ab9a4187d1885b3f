"""Serving: dynamic micro-batching and HTTP endpoints over the port's engine
(counterpart of `sgpt_tpu/serving.py`).

Same classes, routes and payloads as the JAX module. One process owns the
card; HTTP handler threads never touch it themselves: they submit to
`MicroBatcher`s whose dispatcher threads coalesce concurrent small requests
into one engine encode or one index search. The threads share the one CUDA
context and PyTorch's current stream.

Endpoints (stdlib `http.server`, JSON bodies):

  POST /v1/embeddings   OpenAI embeddings wire shape ({"input": str|[str]})
  POST /search          {"queries": [...], "k": 10, "return_documents": bool}
  POST /rerank          two-stage: bi-encoder first_k retrieval + SGPT-CE
                        log-prob rerank ({"queries", "k", "first_k"}); 400
                        without a ranker
  POST /documents       add documents to the live index (pending-slab adds;
                        POST /rebuild merges)
  POST /documents/delete  {"ids": [...]} tombstone documents
  POST /rebuild         merge pending docs into the static-shape corpus
  POST /save            persist index + documents to the configured path
  GET  /healthz, /stats

Index mutation and search serialize on one lock; encoding does not.
"""
from __future__ import annotations

import json
import logging
import os
import queue
import threading
import time
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Sequence

import numpy as np

from .index import DenseIndex
from .utils.profiling import span

logger = logging.getLogger(__name__)


class _Request:
    __slots__ = ("items", "future", "submitted")

    def __init__(self, items):
        self.items = list(items)
        self.future = Future()
        self.submitted = time.monotonic()


class MicroBatcher:
    """Coalesce concurrent submissions into single calls of a batch function.

    `fn` receives ONE concatenated list per dispatch and must return results
    indexable per item (list/array, same length, same order). Submissions
    arriving while a dispatch is on the device ride the next dispatch — the
    classic serving pattern the reference lacks entirely (every
    `SentenceTransformer.encode` caller dispatches its own batch).

    max_wait_ms bounds the added latency for a lone request; max_items bounds
    the coalesced batch (one oversized submission still processes whole — the
    engine token-budget-batches internally).

    Counters (`stats()`), over the dispatches that returned: `dispatches`,
    `items`, `wait_s` (for each item, the dispatch's start minus the item's
    submit time: its queue wait, the coalescing window included) and
    `busy_s` (the time inside `fn`). Under a torch profiler the dispatcher
    thread records the spans `batcher.<name>.collect` (first request taken
    to the end of coalescing), `.dispatch` (the `fn` call; args: the
    dispatch's sequence number and item count, which the spans nested under
    it share) and `.resolve` (setting the futures).
    """

    def __init__(self, fn, *, max_items: int = 1024, max_wait_ms: float = 3.0,
                 name: str = "batcher"):
        self._fn = fn
        self.name = name
        self.max_items = max_items
        self.max_wait = max_wait_ms / 1000.0
        self._q: "queue.Queue[Optional[_Request]]" = queue.Queue()
        self.dispatches = 0
        self.items_processed = 0
        self.wait_s = 0.0
        self.busy_s = 0.0
        self._stats_lock = threading.Lock()   # one snapshot of the four counters
        self._closed = False
        self._thread = threading.Thread(target=self._loop, name=name, daemon=True)
        self._thread.start()

    def submit(self, items: Sequence) -> Future:
        """Future resolving to the per-item results for `items` (in order).

        Raises after close(): enqueueing onto a dead dispatcher would return
        a Future that never resolves (the drain in _loop additionally fails
        any request racing the shutdown)."""
        if self._closed:
            raise RuntimeError(f"{self._thread.name}: submit() after close()")
        req = _Request(items)
        if not req.items:
            req.future.set_result([])
            return req.future
        self._q.put(req)
        return req.future

    def __call__(self, items: Sequence):
        return self.submit(items).result()

    def _loop(self):
        while True:
            req = self._q.get()
            if req is None:
                # fail (don't strand) anything that raced the shutdown
                while True:
                    try:
                        late = self._q.get_nowait()
                    except queue.Empty:
                        return
                    if late is not None:
                        late.future.set_exception(
                            RuntimeError("batcher closed"))
            with span(f"batcher.{self.name}.collect"):
                batch = [req]
                n = len(req.items)
                deadline = time.monotonic() + self.max_wait
                while n < self.max_items:
                    remaining = deadline - time.monotonic()
                    try:
                        # budget spent → take only what is already queued
                        nxt = (self._q.get(timeout=remaining) if remaining > 0
                               else self._q.get_nowait())
                    except queue.Empty:
                        break
                    if nxt is None:  # close() while coalescing: flush, then exit
                        self._q.put(None)
                        break
                    batch.append(nxt)
                    n += len(nxt.items)
                all_items: List = []
                for r in batch:
                    all_items.extend(r.items)
            start = time.monotonic()
            try:
                with span(f"batcher.{self.name}.dispatch", seq=self.dispatches, items=n):
                    results = self._fn(all_items)
            except Exception as e:  # propagate to every waiter, keep serving
                logger.exception("micro-batch dispatch failed (%d items)", n)
                for r in batch:
                    r.future.set_exception(e)
                continue
            busy = time.monotonic() - start
            wait = sum((start - r.submitted) * len(r.items) for r in batch)
            with self._stats_lock:
                self.dispatches += 1
                self.items_processed += n
                self.wait_s += wait
                self.busy_s += busy
            with span(f"batcher.{self.name}.resolve"):
                off = 0
                for r in batch:
                    r.future.set_result(results[off:off + len(r.items)])
                    off += len(r.items)

    def stats(self) -> dict:
        """{dispatches, items, wait_s, busy_s} over the dispatches that
        returned, read together."""
        with self._stats_lock:
            return {"dispatches": self.dispatches, "items": self.items_processed,
                    "wait_s": self.wait_s, "busy_s": self.busy_s}

    def close(self):
        self._closed = True
        self._q.put(None)
        self._thread.join(timeout=5)


class SearchService:
    """Embed / index / search facade the HTTP layer (or any host app) drives.

    Wraps an `EmbeddingEngine` (queries and documents coalesce through
    separate micro-batchers — SPECB gives them different token streams) and a
    `DenseIndex` or an `IVFIndex`, whose pending-slab `add` keeps new
    documents searchable between rebuilds. `documents` retains id → text
    for `return_documents=True`.
    """

    def __init__(self, engine, index: Optional[DenseIndex] = None, *,
                 documents: Optional[Dict[str, str]] = None,
                 max_batch_items: int = 1024, max_wait_ms: float = 3.0,
                 index_kw: Optional[dict] = None, ranker=None):
        self.engine = engine
        self.index = index if index is not None else DenseIndex(
            engine.out_dim, normalize_embeddings=True,
            **{"device": engine.device, **(index_kw or {})})
        self.ranker = ranker  # optional CrossEncoderRanker for POST /rerank
        self.documents: Dict[str, str] = dict(documents or {})
        # ids ever deleted this process: the auto-id probe must skip them even
        # after delete_documents() pops them from self.documents, or a new
        # document could silently reuse a deleted id
        self._tombstoned_ids: set = set()
        self._lock = threading.RLock()
        self._t0 = time.monotonic()
        self._queries_served = 0
        self._q_batcher = MicroBatcher(
            lambda t: engine.encode(list(t), is_query=True),
            max_items=max_batch_items, max_wait_ms=max_wait_ms, name="enc-query")
        self._d_batcher = MicroBatcher(
            lambda t: engine.encode(list(t), is_query=False),
            max_items=max_batch_items, max_wait_ms=max_wait_ms, name="enc-doc")
        # rerank pairs coalesce too: concurrent clients' (query, doc) pairs
        # concatenate into one token-budget-batched scoring pass
        self._r_batcher = (MicroBatcher(
            lambda pairs: ranker.predict(list(pairs)),
            max_items=max_batch_items, max_wait_ms=max_wait_ms, name="rerank")
            if ranker is not None else None)
        # index searches coalesce as well: N concurrent single-query
        # requests become one device dispatch instead of N behind the lock
        self._s_batcher = MicroBatcher(
            self._batched_search, max_items=max_batch_items,
            max_wait_ms=max_wait_ms, name="search")

    # -- embedding ----------------------------------------------------------
    def embed(self, texts: Sequence[str], *, is_query: bool = False) -> np.ndarray:
        batcher = self._q_batcher if is_query else self._d_batcher
        return np.asarray(batcher(list(texts)))

    def count_tokens(self, texts: Sequence[str]) -> int:
        tok = self.engine.tokenizer
        return sum(len(tok.encode(t)) for t in texts)

    # -- documents ----------------------------------------------------------
    def add_documents(self, texts: Sequence[str],
                      ids: Optional[Sequence[str]] = None, *,
                      build: bool = False) -> List[str]:
        if ids is not None:
            if len(ids) != len(texts):
                raise ValueError(f"{len(ids)} ids for {len(texts)} texts")
            if len(set(ids)) != len(ids):
                raise ValueError("duplicate ids within one request")
            if any(i == "" for i in ids):
                raise ValueError("empty-string document ids are not allowed")
        emb = self.embed(texts, is_query=False)
        with self._lock:
            if ids is None:
                # monotonic probe: len(index) alone would reuse ids after
                # deletions shrink the live count
                ids, base = [], len(self.index)
                for _ in texts:
                    while (str(base) in self.documents
                           or str(base) in self._tombstoned_ids):
                        base += 1
                    ids.append(str(base))
                    base += 1
            dup = [i for i in ids if i in self.documents]
            if dup:
                raise ValueError(f"duplicate document ids: {dup[:5]}")
            self.index.add(emb, ids=list(ids))
            for i, t in zip(ids, texts):
                self.documents[i] = t
            if build or not self.index.is_built:
                self.index.build()
        return list(ids)

    def delete_documents(self, ids: Sequence[str]) -> int:
        """Tombstone documents: immediately unsearchable; storage reclaims at
        the next rebuild(). Raises KeyError for unknown ids."""
        with self._lock:
            n = self.index.delete(list(ids))
            for i in ids:
                self.documents.pop(i, None)
                self._tombstoned_ids.add(i)
            return n

    def rebuild(self) -> int:
        with self._lock:
            if len(self.index) == 0 and not self.index.is_built:
                return 0  # nothing to build yet (IVF raises on empty build)
            self.index.build()
            return len(self.index)

    # -- search -------------------------------------------------------------
    def _batched_search(self, items) -> List[tuple]:
        """Micro-batch fn: items are (query_embedding_row, k) pairs from
        concurrent search() calls; ONE padded-Q index dispatch serves all.

        Q pads to a power-of-two bucket (filler = copies of row 0, trimmed
        before return), as in the JAX service: the index sees few distinct
        query shapes."""
        kmax = max(k for _, k in items)
        with span("search.stack"):
            rows = np.stack([np.asarray(e, np.float32) for e, _ in items])
            n = len(rows)
            bucket = 1
            while bucket < n:
                bucket *= 2
            if bucket > n:
                rows = np.concatenate(
                    [rows, np.broadcast_to(rows[:1], (bucket - n, rows.shape[1]))])
        with self._lock:
            scores, ids = self.index.search_embeddings(rows, k=kmax)
            self._queries_served += n
        return [(s[:k], i[:k])
                for (s, i, (_, k)) in zip(scores[:n], ids[:n], items)]

    def warm_search(self, max_queries: int = 64,
                    ks: Sequence[int] = (10,)) -> "SearchService":
        """Run each power-of-two Q bucket _batched_search pads to, for each
        k, once before traffic: the first search builds the kernels and
        warms the matmul libraries, as EmbeddingEngine.warmup() does for
        encode shapes."""
        if len(self.index) == 0 or not self.index.is_built:
            return self
        rng = np.random.default_rng(0)
        b = 1
        while b <= max_queries:
            q = rng.standard_normal((b, self.engine.out_dim)).astype(np.float32)
            with self._lock:
                for k in ks:
                    self.index.search_embeddings(q, k=k)
            b *= 2
        return self

    def search(self, queries: Sequence[str], *, k: int = 10,
               return_documents: bool = False) -> List[List[dict]]:
        q_emb = self.embed(queries, is_query=True)
        rows = self._s_batcher([(e, int(k)) for e in np.asarray(q_emb)])
        out = []
        with self._lock, span("search.assemble"):
            for row_s, row_i in rows:
                hits = []
                for s, i in zip(row_s, row_i):
                    hit = {"id": i, "score": float(s)}
                    if return_documents:
                        hit["document"] = self.documents.get(i)
                    hits.append(hit)
                out.append(hits)
        return out

    def rerank(self, queries: Sequence[str], *, k: int = 10,
               first_k: int = 100,
               return_documents: bool = False) -> List[List[dict]]:
        """Two-stage search: bi-encoder retrieval of first_k candidates, then
        the ranker's scores (SGPT-CE: `crossencoder.CrossEncoderRanker`, or
        anything with predict(pairs)). Each hit keeps the first-stage cosine
        as `score` and gains `ce_score`; hits sort by ce_score. Requires a
        ranker AND retained document texts."""
        if self.ranker is None:
            raise ValueError("no reranker configured: pass ranker= to "
                             "SearchService (serve --rerank)")
        first = self.search(queries, k=first_k,
                            return_documents=return_documents)
        pairs, spans = [], []
        with self._lock:
            for q, hits in zip(queries, first):
                spans.append(len(hits))
                for h in hits:
                    text = self.documents.get(h["id"])
                    if text is None:
                        raise ValueError(
                            f"no retained text for doc {h['id']!r}: rerank "
                            "needs the documents map (serve --corpus keeps "
                            "it; an index loaded without documents.jsonl "
                            "cannot rerank)")
                    pairs.append((q, text))
        scores = self._r_batcher(pairs) if pairs else []
        out, off = [], 0
        for n, hits in zip(spans, first):
            for h, s in zip(hits, scores[off:off + n]):
                h["ce_score"] = float(s)
            off += n
            out.append(sorted(hits, key=lambda h: -h["ce_score"])[:k])
        return out

    # -- misc ---------------------------------------------------------------
    def stats(self) -> dict:
        """The index's and the service's counts; `batchers` maps each
        micro-batcher's name to its `MicroBatcher.stats()`, and
        `search_dispatches` is the search batcher's dispatch count."""
        batchers = {b.name: b.stats() for b in (
            self._q_batcher, self._d_batcher, self._s_batcher, self._r_batcher)
            if b is not None}
        with self._lock:
            pending = self.index.pending_docs
            return {
                "documents": len(self.index),
                "pending_docs": pending,
                "queries_served": self._queries_served,
                "uptime_s": round(time.monotonic() - self._t0, 1),
                "embed_dispatches": (self._q_batcher.dispatches
                                     + self._d_batcher.dispatches),
                "embed_items": (self._q_batcher.items_processed
                                + self._d_batcher.items_processed),
                "out_dim": self.engine.out_dim,
                "search_dispatches": batchers["search"]["dispatches"],
                "batchers": batchers,
            }

    # -- persistence --------------------------------------------------------
    def save(self, directory: str) -> dict:
        """Persist the index (+ retained doc texts) under `directory`:
        index.npz via the index's own save(), documents.jsonl for
        return_documents=True. A restarted server points --index-path here
        and skips re-encoding the corpus."""
        os.makedirs(directory, exist_ok=True)
        with self._lock:
            self.index.save(os.path.join(directory, "index.npz"))
            n_docs = len(self.documents)
            with open(os.path.join(directory, "documents.jsonl"), "w") as f:
                for i, t in self.documents.items():
                    f.write(json.dumps({"id": i, "text": t}) + "\n")
        return {"documents": len(self.index), "texts": n_docs,
                "path": directory}

    @staticmethod
    def load_index(directory: str, *, mesh=None, **index_kw):
        """(index, documents dict) from a save()d directory. The index class
        comes from the file's own metadata: `IVFIndex.load` for an IVF file,
        else `DenseIndex.load`; `mesh` re-shards the loaded corpus over its
        dp axis (saves do not depend on the mesh); index_kw (device; kernel
        for a dense index) go to it."""
        path = os.path.join(directory, "index.npz")
        meta = json.loads(bytes(np.load(path)["meta"]))
        if meta.get("kind") == "ivf":
            from .index_ivf import IVFIndex
            index = IVFIndex.load(path, mesh=mesh, **index_kw)
        else:
            index = DenseIndex.load(path, mesh=mesh, **index_kw)
        documents = {}
        doc_path = os.path.join(directory, "documents.jsonl")
        if os.path.exists(doc_path):
            with open(doc_path) as f:
                for line in f:
                    if line.strip():
                        row = json.loads(line)
                        documents[row["id"]] = row["text"]
        return index, documents

    def close(self):
        self._q_batcher.close()
        self._d_batcher.close()
        self._s_batcher.close()
        if self._r_batcher is not None:
            self._r_batcher.close()


# ---------------------------------------------------------------------------
# HTTP layer
# ---------------------------------------------------------------------------
class _Handler(BaseHTTPRequestHandler):
    service: SearchService  # set by make_server on the subclass
    model_name: str = "sgpt-tpu"
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # route through logging, not stderr
        logger.debug("%s " + fmt, self.address_string(), *args)

    # -- plumbing -----------------------------------------------------------
    def _send(self, code: int, payload: dict):
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _read_json(self) -> dict:
        n = int(self.headers.get("Content-Length", 0))
        raw = self.rfile.read(n) if n else b"{}"
        obj = json.loads(raw.decode())
        if not isinstance(obj, dict):
            raise ValueError("request body must be a JSON object")
        return obj

    # -- routes -------------------------------------------------------------
    def do_GET(self):
        if self.path == "/healthz":
            self._send(200, {"status": "ok"})
        elif self.path == "/stats":
            self._send(200, self.service.stats())
        else:
            self._send(404, {"error": f"no route {self.path}"})

    def do_POST(self):
        try:
            body = self._read_json()
        except Exception as e:
            self._send(400, {"error": f"bad JSON body: {e}"})
            return
        try:
            if self.path == "/v1/embeddings":
                self._send(200, self._embeddings(body))
            elif self.path == "/search":
                self._send(200, self._search(body))
            elif self.path == "/rerank":
                self._send(200, self._rerank(body))
            elif self.path == "/documents":
                self._send(200, self._documents(body))
            elif self.path == "/documents/delete":
                ids = body.get("ids")
                if not isinstance(ids, list) or not all(
                        isinstance(i, str) for i in ids):
                    raise ValueError("'ids' must be a list of strings")
                self._send(200, {"deleted": self.service.delete_documents(ids),
                                 "documents": self.service.stats()["documents"]})
            elif self.path == "/rebuild":
                self._send(200, {"documents": self.service.rebuild()})
            elif self.path == "/save":
                # client-supplied paths are only honored when the server was
                # built with allow_save_path=True — otherwise a remote client
                # could write files to arbitrary filesystem locations
                configured = getattr(self.server, "index_path", None)
                client_path = body.get("path")
                if client_path and not getattr(self.server,
                                               "allow_save_path", False):
                    self._send(403, {"error": "client-supplied save paths are "
                                     "disabled; start the server with "
                                     "allow_save_path=True or use the "
                                     "configured --index-path"})
                    return
                path = client_path or configured
                if not path:
                    self._send(400, {"error": "no path: start the server with "
                                     "--index-path (or allow_save_path=True "
                                     "and pass {\"path\": ...})"})
                else:
                    self._send(200, self.service.save(path))
            else:
                self._send(404, {"error": f"no route {self.path}"})
        except (ValueError, TypeError, KeyError) as e:
            self._send(400, {"error": str(e)})
        except Exception as e:
            logger.exception("request failed: %s", self.path)
            self._send(500, {"error": str(e)})

    def _embeddings(self, body: dict) -> dict:
        """OpenAI `/v1/embeddings` wire shape (the reference's client format,
        beir_openai_embeddings_batched_parallel.py:193-266): `input` is a
        string or list of strings; response carries index-aligned `data` and
        a token `usage` block. `is_query` is our extension (SPECB routing)."""
        inp = body.get("input")
        if inp is None:
            raise ValueError("missing 'input'")
        texts = [inp] if isinstance(inp, str) else list(inp)
        if not all(isinstance(t, str) for t in texts):
            raise ValueError("'input' must be a string or list of strings")
        emb = self.service.embed(texts, is_query=bool(body.get("is_query")))
        ntok = self.service.count_tokens(texts)
        return {
            "object": "list",
            "model": body.get("model", self.model_name),
            "data": [{"object": "embedding", "index": i,
                      "embedding": np.asarray(e, np.float64).tolist()}
                     for i, e in enumerate(emb)],
            "usage": {"prompt_tokens": ntok, "total_tokens": ntok},
        }

    def _search(self, body: dict) -> dict:
        queries = body.get("queries")
        if not isinstance(queries, list) or not all(
                isinstance(q, str) for q in queries):
            raise ValueError("'queries' must be a list of strings")
        k = int(body.get("k", 10))
        if k < 1:
            raise ValueError("'k' must be >= 1")
        results = self.service.search(
            queries, k=k, return_documents=bool(body.get("return_documents")))
        return {"results": results}

    def _rerank(self, body: dict) -> dict:
        queries = body.get("queries")
        if not isinstance(queries, list) or not all(
                isinstance(q, str) for q in queries):
            raise ValueError("'queries' must be a list of strings")
        k = int(body.get("k", 10))
        first_k = int(body.get("first_k", max(100, k)))
        if k < 1 or first_k < k:
            raise ValueError("need 1 <= k <= first_k")
        results = self.service.rerank(
            queries, k=k, first_k=first_k,
            return_documents=bool(body.get("return_documents")))
        return {"results": results}

    def _documents(self, body: dict) -> dict:
        if "documents" in body:  # [{"id": ..., "text": ...}, ...]
            docs = body["documents"]
            if not isinstance(docs, list) or not all(
                    isinstance(d, dict) for d in docs):
                raise ValueError("'documents' must be a list of objects")
            texts = [d["text"] for d in docs]
            with_id = [d for d in docs if "id" in d]
            if with_id and len(with_id) != len(docs):
                # honoring some ids and auto-assigning the rest would
                # silently drop the supplied ones — refuse the mix
                raise ValueError("either every document carries an 'id' "
                                 "or none does")
            ids = [str(d["id"]) for d in docs] if with_id else None
        else:  # {"texts": [...], "ids": [...]?}
            texts = body.get("texts")
            ids = body.get("ids")
            if ids is not None:
                if not isinstance(ids, list):
                    raise ValueError("'ids' must be a list")
                ids = [str(i) for i in ids]
        if not isinstance(texts, list) or not all(isinstance(t, str) for t in texts):
            raise ValueError("'documents' (id/text objects) or 'texts' "
                             "(list of strings) required")
        assigned = self.service.add_documents(
            texts, ids=ids, build=bool(body.get("build")))
        st = self.service.stats()
        return {"added": len(assigned), "ids": assigned,
                "documents": st["documents"], "pending_docs": st["pending_docs"]}


def make_server(service: SearchService, host: str = "127.0.0.1",
                port: int = 8080, *, model_name: str = "sgpt-tpu",
                index_path: Optional[str] = None,
                allow_save_path: bool = False) -> ThreadingHTTPServer:
    """Bind a ThreadingHTTPServer for `service`; caller runs serve_forever().

    port=0 binds an ephemeral port (tests); `server.server_address[1]` holds
    the actual one. index_path is the default directory for POST /save;
    allow_save_path=True additionally lets clients pass {"path": ...}
    (off by default — it writes server-side files wherever the client says).
    """
    handler = type("BoundHandler", (_Handler,),
                   {"service": service, "model_name": model_name})
    # TCPServer's default listen backlog is 5: a burst of >5 simultaneous
    # client connects overflows the accept queue and the kernel sends RST
    # (measured: 32 keep-alive clients reset at level start). Serving is
    # exactly that shape — many clients connecting at once — so raise it.
    srv_cls = type("BoundServer", (ThreadingHTTPServer,),
                   {"request_queue_size": 128})
    srv = srv_cls((host, port), handler)
    srv.index_path = index_path
    srv.allow_save_path = allow_save_path
    return srv
