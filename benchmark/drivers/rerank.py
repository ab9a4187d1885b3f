"""SGPT-CE reranking: `crossencoder.rerank` over a fixed first stage in a
closed loop, one caller, as `cli/sgptce.py` runs it (prompt G).

Mix parameters: queries_per_call, top_k (first-stage documents a query),
query_words, batch_size, max_length, lengths {mu, sigma, lo, hi} (document
words), vocabulary, max_pairs_per_s (set-up makes that many pairs a second
of the window). Each query is query_words words drawn from its first-ranked
document; the first stage is made at set-up, not timed.
"""
from __future__ import annotations

import math
import time

import numpy as np

from ..reference import model as ref
from ..reference import text as rtext
from .. import roofline
from .common import Texts, lognormal_lengths, program_model, stratified_sample, tokenizer

STRATA = (256, 512, 1024, 2048)   # input tokens, upper bounds (the ranker's buckets)
QUERIES = 8
PER_QUERY = 8


class Driver:
    kind = "rerank"

    def __init__(self, config: dict, mix: dict, seed: int, device, control: bool = False,
                 check_params: dict = None):
        self.config, self.mix, self.seed, self.device = config, mix, seed, device
        self.control = control
        self.check_params = check_params or {}

    def setup(self, seconds: float) -> None:
        from sgpt_tpu_torch.crossencoder import CrossEncoderRanker

        mix = self.mix
        self.model, self.cfg, self.arch = program_model(self.config, self.seed, self.device,
                                                        lm_head=True)
        self.ranker = CrossEncoderRanker(
            self.model, self.cfg, tokenizer(self.cfg), device=self.device,
            batch_size=mix["batch_size"], max_length=mix["max_length"],
            quantize="int8" if self.control else None)
        self.texts = Texts(np.random.default_rng(self.seed), mix["vocabulary"])
        L = mix["lengths"]
        self.lengths = lognormal_lengths(mix["queries_per_call"] * mix["top_k"],
                                         L["mu"], L["sigma"], L["lo"], L["hi"])
        self.n_calls = 0
        self.run_call(self.call())                  # warm-up: every shape of a call
        self.ready = [self.call() for _ in range(
            math.ceil(mix["max_pairs_per_s"] * seconds / len(self.lengths)) + 1)]

    def call(self) -> tuple:
        """(corpus, queries, first stage) of one call."""
        mix, k = self.mix, self.mix["top_k"]
        c = self.n_calls
        self.n_calls += 1
        lens = self.texts.shuffled(self.lengths)
        corpus, queries, first = {}, {}, {}
        for q in range(mix["queries_per_call"]):
            qid = f"c{c}q{q}"
            hits = {}
            for r in range(k):
                did = f"c{c}q{q}d{r}"
                corpus[did] = {"title": "", "text": self.texts.text(lens[q * k + r])}
                hits[did] = float(k - r)
            words = corpus[f"c{c}q{q}d0"]["text"].split()
            queries[qid] = " ".join(self.texts.rng.choice(words, mix["query_words"],
                                                          replace=False).tolist())
            first[qid] = hits
        return corpus, queries, first

    def run_call(self, call) -> dict:
        from sgpt_tpu_torch.crossencoder import rerank

        corpus, queries, first = call
        return rerank(self.ranker, corpus, queries, first, top_k=self.mix["top_k"])

    @property
    def program_model(self):
        return self.ranker.model

    def window(self, seconds: float) -> dict:
        calls, outs = [], []
        t0 = time.perf_counter()
        while True:
            call = self.ready.pop(0) if self.ready else self.call()
            outs.append(self.run_call(call))
            calls.append(call)
            if time.perf_counter() - t0 >= seconds:
                break
        t1 = time.perf_counter()
        pairs = self._pairs(calls, outs)
        return {"window_s": t1 - t0, "pairs": pairs, "attempted": len(pairs),
                "failed": sum(1 for *_, s in pairs if s is None or not math.isfinite(s))}

    @staticmethod
    def _pairs(calls, outs) -> list:
        """(query, document text, score) of every pair the window scored."""
        out = []
        for (corpus, queries, first), res in zip(calls, outs):
            for qid, hits in first.items():
                for did in hits:
                    out.append((queries[qid], rtext.doc_text(corpus[did]),
                                res.get(qid, {}).get(did)))
        return out

    def work(self, rec: dict) -> dict:
        ml = self.mix["max_length"]
        lens = [rtext.ce_len(q, d, ml) for q, d, _ in rec["pairs"]]
        rows = [n for n, _ in lens]
        scored = sum(c for _, c in lens)
        return {"items": len(lens), "real_tokens": sum(rows),
                "flops": roofline.decoder_flops(self.arch, rows)
                + roofline.head_flops(self.arch, scored),
                "k1_bound_s": roofline.k1_bound_s(self.arch, rows)}

    def counters(self) -> dict:
        from sgpt_tpu_torch.ops import short_attention

        return {"k1_launches": short_attention.launches}

    def release(self) -> None:
        del self.ranker, self.model
        self.ready = []

    def check(self, rec: dict) -> dict:
        """Over a sample drawn from the seed (QUERIES queries, the one with
        the window's longest pair among them, and PER_QUERY pairs of each
        over the length buckets): the share of pairs whose returned score (a
        sum of the query's token log-probs) lies more than `far_nats` from
        the reference's. The int8 control's gaps are only ~2.3 times bf16's
        at single pairs, so a mean or a widest gap cannot hold a limit between
        them, while a gap of far_nats is rare in bf16 and common in int8."""
        ml, far = self.mix["max_length"], self.check_params["far_nats"]
        pairs = rec["pairs"]
        lens = [rtext.ce_len(q, d, ml)[0] for q, d, _ in pairs]
        rng = np.random.default_rng([self.seed, 2])
        by_q: dict = {}
        for i, (q, _, _) in enumerate(pairs):
            by_q.setdefault(q, []).append(i)
        longest = pairs[int(np.argmax(lens))][0]
        others = [q for q in by_q if q != longest]
        chosen = [longest] + [others[j] for j in rng.choice(
            len(others), min(QUERIES - 1, len(others)), replace=False)]
        pick = []
        for q in chosen:
            idx = by_q[q]
            pick += [idx[j] for j in stratified_sample(rng, [lens[i] for i in idx], STRATA,
                                                      PER_QUERY // len(STRATA))]
        items = [rtext.ce_row(pairs[i][0], pairs[i][1], self.arch["V"], ml) for i in pick]
        want = ref.continuation_logprob(self.arch, self.seed, items, self.device)
        gaps = [float("inf") if pairs[i][2] is None else abs(pairs[i][2] - w)
                for i, w in zip(pick, want)]
        return {"score_far_share": sum(g > far for g in gaps) / len(gaps)}
