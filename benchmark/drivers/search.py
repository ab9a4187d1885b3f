"""Served search: `SearchService.search` in process, one query a request, under
an open loop of Poisson arrivals, as independent users send them.

Mix parameters: rate_qps (the offered rate), k, index_rows (the corpus's
documents, unit rows of the model's width in the served dtype, made on the
card from the seed), query_words {lo, hi}, batch_size (the engine's, as the
serve CLI sets it), max_wait_ms (the micro-batchers'), workers (host threads
that carry requests; one blocks on each request in flight), drain_s (how long
after the last arrival the window waits for answers), warm_queries (the
largest coalesced search set-up warms), vocabulary.

Arrivals: the gaps are the quantiles of an exponential of mean 1/rate_qps, in
an order drawn from the seed, so every seed offers the same load. Each
request is timed from when it was due, so a late generator or a stall counts
in the latency; how late the generator ran is kept beside.
"""
from __future__ import annotations

import math
import threading
import time
from concurrent.futures import ThreadPoolExecutor, wait

import numpy as np

from ..reference import model as ref
from ..reference import search as rsearch
from ..reference import text as rtext
from .common import Texts, even_lengths, program_model, stratified_sample, tokenizer

STRATA = (8, 12, 16, 22)   # SPECB query tokens, upper bounds
PER_STRATUM = 8
WARM_S = 2.0               # seconds of arrivals at the cell's rate during set-up


class Driver:
    kind = "search"

    def __init__(self, config: dict, mix: dict, seed: int, device, control: bool = False,
                 check_params: dict = None):
        self.config, self.mix, self.seed, self.device = config, mix, seed, device
        self.control = control
        self.check_params = check_params or {}
        self.max_seq_len = config["serving"]["max_seq_len"]

    def setup(self, seconds: float) -> None:
        import torch
        from sgpt_tpu_torch.encoder import EmbeddingEngine
        from sgpt_tpu_torch.index import DenseIndex
        from sgpt_tpu_torch.serving import SearchService
        from sgpt_tpu_torch.tokenization.specb import pick_bucket

        serving, mix = self.config["serving"], self.mix
        self.model, self.cfg, self.arch = program_model(self.config, self.seed, self.device)
        self.engine = EmbeddingEngine(
            self.model, self.cfg, tokenizer(self.cfg), device=self.device,
            method=serving["pooling"], specb=serving["specb"], max_seq_len=self.max_seq_len,
            batch_size=mix["batch_size"], normalize_embeddings=True,
            quantize="int8" if self.control else None)
        n, d = mix["index_rows"], self.arch["D"]
        corpus = torch.empty((n, d), dtype=getattr(torch, serving["dtype"]), device=self.device)
        for base, rows in rsearch.corpus_chunks(self.seed, n, d, self.device):
            corpus[base:base + rows.shape[0]] = rows
        # K5, the streaming MIPS kernel, scans the index (kernel="pallas")
        self.index = DenseIndex.from_device_embeddings(corpus)
        self.index.kernel = "pallas"
        del corpus
        self.service = SearchService(self.engine, self.index, max_wait_ms=mix["max_wait_ms"])
        self.texts = Texts(np.random.default_rng(self.seed), mix["vocabulary"])
        self.pool = ThreadPoolExecutor(max_workers=mix["workers"])
        q, codec = mix["query_words"], self.engine.codec
        self.engine.warmup(sorted({pick_bucket(n + 2, codec.buckets, codec.max_seq_len)
                                   for n in range(q["lo"], q["hi"] + 1)}))
        self.service.warm_search(max_queries=mix["warm_queries"], ks=(mix["k"],))
        self.run_arrivals(self._arrivals(WARM_S), drain_s=mix["drain_s"])
        self.ready = self._arrivals(seconds)

    def _arrivals(self, seconds: float) -> list:
        """(offset in seconds, query) of each arrival in [0, seconds)."""
        rate, q = self.mix["rate_qps"], self.mix["query_words"]
        n = max(1, int(round(rate * seconds)))
        gaps = [-math.log(1.0 - (i + 0.5) / n) / rate for i in range(n)]
        gaps = self.texts.shuffled(gaps)
        t = np.cumsum(gaps) - gaps[0]
        words = self.texts.shuffled(even_lengths(n, q["lo"], q["hi"]))
        return [(float(ti), self.texts.text(w)) for ti, w in zip(t, words) if ti < seconds]

    @property
    def program_model(self):
        return self.engine.model

    def _request(self, query: str):
        return self.service.search([query], k=self.mix["k"])[0]

    def run_arrivals(self, arrivals: list, drain_s: float) -> dict:
        """Send each query when it is due; wait for the answers up to drain_s
        after the last arrival."""
        reqs = []
        lock = threading.Lock()

        def one(i, query):
            try:
                res, err = self._request(query), None
            except Exception as e:   # a failed request counts as missing
                res, err = None, repr(e)
            done = time.perf_counter()
            with lock:
                reqs[i].update(done=done, result=res, error=err)

        t0 = time.perf_counter()
        futs = []
        for i, (off, query) in enumerate(arrivals):
            due = t0 + off
            now = time.perf_counter()
            if due > now:
                time.sleep(due - now)
            sent = time.perf_counter()
            reqs.append({"due": due, "sent": sent, "query": query, "done": None,
                         "result": None, "error": None})
            futs.append(self.pool.submit(one, i, query))
        t_last = time.perf_counter()
        wait(futs, timeout=drain_s)
        t1 = time.perf_counter()
        with lock:
            snap = [dict(r) for r in reqs]
        return {"t0": t0, "t_last": t_last, "t1": t1, "requests": snap}

    def window(self, seconds: float) -> dict:
        run = self.run_arrivals(self.ready, drain_s=self.mix["drain_s"])
        reqs = run["requests"]
        lat = [None if r["done"] is None or r["result"] is None else 1e3 * (r["done"] - r["due"])
               for r in reqs]
        late = [1e3 * (r["sent"] - r["due"]) for r in reqs]
        return {"window_s": seconds, "requests": reqs, "latencies_ms": lat,
                "attempted": len(reqs), "failed": sum(1 for x in lat if x is None),
                "generator_late_ms": {"p50": float(np.percentile(late, 50)) if late else 0.0,
                                      "max": max(late, default=0.0)}}

    def work(self, rec: dict) -> dict:
        return {"items": rec["attempted"], "queries": rec["attempted"],
                "index_rows": self.mix["index_rows"], "dim": self.arch["D"]}

    def counters(self) -> dict:
        from sgpt_tpu_torch.ops import mips, short_attention

        return {"k1_launches": short_attention.launches, "k5_launches": mips.launches,
                "queries_served": self.service.stats()["queries_served"]}

    def release(self) -> None:
        self.service.close()
        self.pool.shutdown(wait=True)
        del self.service, self.index, self.engine, self.model
        self.ready = []

    def check(self, rec: dict) -> dict:
        """Over a sample of answered requests drawn from the seed (every
        query length, the longest among them), each request's widest gap
        between a returned hit's score and the reference's score of that row
        for the reference's query embedding, and its shortfall of a returned
        hit's reference score below the reference's k-th best (0 when every
        hit is among the best k); both as a mean over the sample, which the
        int8 control reads 3.5 and 4 times as high as the program, where the
        widest reads under 3 times. A request with fewer than k hits, or one
        unanswered, fails."""
        k = self.mix["k"]
        failed = {"hit_score_mean_err": float("inf"), "rank_gap_mean": float("inf")}
        done = [r for r in rec["requests"] if r["result"] is not None]
        if len(done) < rec["attempted"] or not done:
            return failed
        lens = [rtext.specb_len(r["query"], self.max_seq_len) for r in done]
        pick = stratified_sample(np.random.default_rng([self.seed, 3]), lens, STRATA, PER_STRATUM)
        hits = [done[i]["result"] for i in pick]
        if any(len(h) != k for h in hits):
            return failed
        rows = [rtext.specb_row(done[i]["query"], self.arch["V"], self.max_seq_len, True)
                for i in pick]
        q = ref.embed(self.arch, self.seed, rows, self.device)
        q = q / q.norm(dim=1, keepdim=True)
        ids = [[int(h["id"]) for h in hs] for hs in hits]
        best_v, _, got = rsearch.exact_scores(self.seed, self.mix["index_rows"], self.arch["D"],
                                              q, k, ids)
        kth = best_v[:, -1].cpu().tolist()
        per_q = [max(abs(h["score"] - g) for h, g in zip(hs, gs)) for hs, gs in zip(hits, got)]
        gaps = [max(0.0, kk - min(gs)) for kk, gs in zip(kth, got)]
        return {"hit_score_mean_err": float(np.mean(per_q)), "rank_gap_mean": float(np.mean(gaps))}
