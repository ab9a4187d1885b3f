"""Bulk corpus encode: `EmbeddingEngine.encode_corpus` in a closed loop, one
caller, as BEIR indexing drives it.

Mix parameters: docs_per_call, batch_size, lengths {mu, sigma, lo, hi} (words,
a clipped lognormal), vocabulary (distinct words), max_tokens_per_s (set-up
makes text for that rate over the window, so the window waits for text only
if the program outruns it). The configuration's `serving` block gives the
pooling, SPECB and max_seq_len.
"""
from __future__ import annotations

import math
import time

import numpy as np

from ..reference import model as ref
from ..reference import text as rtext
from .. import roofline
from .common import Texts, lognormal_lengths, program_model, stratified_sample, tokenizer

STRATA = (16, 32, 64, 128, 256, 300)   # SPECB token lengths, upper bounds
PER_STRATUM = 4


class Driver:
    kind = "encode"

    def __init__(self, config: dict, mix: dict, seed: int, device, control: bool = False,
                 check_params: dict = None):
        self.config, self.mix, self.seed, self.device = config, mix, seed, device
        self.control = control
        self.check_params = check_params or {}
        self.max_seq_len = config["serving"]["max_seq_len"]

    def setup(self, seconds: float) -> None:
        from sgpt_tpu_torch.encoder import EmbeddingEngine

        serving, mix = self.config["serving"], self.mix
        self.model, self.cfg, self.arch = program_model(self.config, self.seed, self.device)
        self.engine = EmbeddingEngine(
            self.model, self.cfg, tokenizer(self.cfg), device=self.device,
            method=serving["pooling"], specb=serving["specb"], max_seq_len=self.max_seq_len,
            batch_size=mix["batch_size"], quantize="int8" if self.control else None)
        self.texts = Texts(np.random.default_rng(self.seed), mix["vocabulary"])
        L = mix["lengths"]
        self.lengths = lognormal_lengths(mix["docs_per_call"], L["mu"], L["sigma"], L["lo"], L["hi"])
        self.engine.encode_corpus(self.call())      # warm-up: every shape of a call
        per_call = sum(min(n, self.max_seq_len - 2) + 2 for n in self.lengths)
        self.ready = [self.call() for _ in range(
            math.ceil(mix["max_tokens_per_s"] * seconds / per_call) + 1)]

    def call(self) -> list:
        docs = []
        for n in self.texts.shuffled(self.lengths):
            docs.append({"title": "", "text": self.texts.text(n)})
        return docs

    @property
    def program_model(self):
        """The decoder the engine runs (its int8 copy for the control)."""
        return self.engine.model

    def window(self, seconds: float) -> dict:
        calls, outs = [], []
        t0 = time.perf_counter()
        while True:
            docs = self.ready.pop(0) if self.ready else self.call()
            emb = self.engine.encode_corpus(docs)
            calls.append(docs)
            outs.append(emb)
            if time.perf_counter() - t0 >= seconds:
                break
        t1 = time.perf_counter()
        return {"window_s": t1 - t0, "calls": calls, "outputs": outs,
                "attempted": sum(len(c) for c in calls),
                "failed": sum(int((~np.isfinite(e).all(axis=1)).sum()) for e in outs)}

    def work(self, rec: dict) -> dict:
        lens = [rtext.specb_len(rtext.doc_text(d), self.max_seq_len)
                for docs in rec["calls"] for d in docs]
        return {"items": len(lens), "real_tokens": sum(lens),
                "flops": roofline.decoder_flops(self.arch, lens),
                "k1_bound_s": roofline.k1_bound_s(self.arch, lens)}

    def counters(self) -> dict:
        from sgpt_tpu_torch.ops import short_attention

        return {"k1_launches": short_attention.launches}

    def release(self) -> None:
        del self.engine, self.model
        self.ready = []

    def check(self, rec: dict) -> dict:
        """The widest relative gap ‖e − r‖/‖r‖ between an embedding the
        window returned and the reference's, over a sample drawn from the
        seed: every length stratum, the truncated documents and the longest."""
        import torch

        docs = [d for c in rec["calls"] for d in c]
        embs = np.concatenate(rec["outputs"])
        lens = [rtext.specb_len(rtext.doc_text(d), self.max_seq_len) for d in docs]
        pick = stratified_sample(np.random.default_rng([self.seed, 1]), lens, STRATA, PER_STRATUM)
        rows = [rtext.specb_row(rtext.doc_text(docs[i]), self.arch["V"], self.max_seq_len, False)
                for i in pick]
        want = ref.embed(self.arch, self.seed, rows, self.device).cpu()
        got = torch.from_numpy(embs[pick]).float()
        err = (got - want).norm(dim=1) / want.norm(dim=1)
        return {"emb_rel_err": float(err.max())}
