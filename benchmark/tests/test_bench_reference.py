"""The plain reference against the port on the CPU at a tiny width, both in
float32: the forward of both families with SGPT's pooling, SGPT-CE's scores,
the exact top-k, and the tokenizer's framing against the port's codec."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.reference import model as ref
from benchmark.reference import search as rsearch
from benchmark.reference import text as rtext

from .conftest import TINY_WIDTHS


def _config(family: str, lm_head_untied: bool) -> dict:
    hf = dict(TINY_WIDTHS[family], layer_norm_epsilon=1e-5,
              tie_word_embeddings=not lm_head_untied)
    if family == "gptj":
        hf.update(n_inner=None, n_positions=2048)
    return {"family": family, "hf_config": hf,
            "serving": {"dtype": "float32", "pooling": "weightedmean", "specb": True,
                        "max_seq_len": 300}}


def _port(config: dict, seed: int, lm_head: bool = False):
    from benchmark.drivers.common import program_model

    return program_model(config, seed, "cpu", lm_head=lm_head)


def _texts(rng, n, lo, hi):
    words = ["".join(rng.choice(list("abcdefgh"), rng.integers(2, 6))) for _ in range(200)]
    return [" ".join(rng.choice(words, int(rng.integers(lo, hi)))) for _ in range(n)]


@pytest.mark.parametrize("family", ["gptj", "bloom"])
def test_reference_embeddings_match_the_port(family):
    from sgpt_tpu_torch.encoder import EmbeddingEngine
    from sgpt_tpu_torch.tokenization.base import SimpleTokenizer

    config = _config(family, False)
    model, cfg, a = _port(config, 7)
    eng = EmbeddingEngine(model, cfg, SimpleTokenizer(cfg.vocab_size), device="cpu",
                          method="weightedmean", specb=True, max_seq_len=40, batch_size=4)
    texts = _texts(np.random.default_rng(1), 9, 1, 60)   # some cut at 40 tokens
    got = torch.from_numpy(eng.encode_corpus(texts))
    rows = [rtext.specb_row(t, a["V"], 40, False) for t in texts]
    assert rows == eng.codec.encode_rows(texts)[0]
    want = ref.embed(a, 7, rows, "cpu")
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-5)


def test_reference_scores_match_the_port_cross_encoder():
    from sgpt_tpu_torch.crossencoder import CrossEncoderRanker
    from sgpt_tpu_torch.tokenization.base import SimpleTokenizer

    config = _config("gptj", True)
    model, cfg, a = _port(config, 11, lm_head=True)
    assert a["lm_head"] and model.lm_head is not None
    ranker = CrossEncoderRanker(model, cfg, SimpleTokenizer(cfg.vocab_size), device="cpu",
                                batch_size=2, max_length=64)
    rng = np.random.default_rng(2)
    docs = _texts(rng, 6, 5, 90)                          # some cut at 64 tokens
    pairs = [(" ".join(d.split()[:5]), d) for d in docs]
    got = ranker.predict(pairs)
    items = [rtext.ce_row(q, d, a["V"], 64) for q, d in pairs]
    want = ref.continuation_logprob(a, 11, items, "cpu")
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_exact_top_k_matches_the_port_index():
    from sgpt_tpu_torch.index import DenseIndex

    n, d, k = 5000, 32, 10
    corpus = torch.cat([c for _, c in rsearch.corpus_chunks(3, n, d, "cpu")])
    assert corpus.shape == (n, d)
    again = rsearch.corpus_chunk(3, 0, n, d, "cpu")
    assert torch.equal(again, corpus[:rsearch.CHUNK_ROWS])
    index = DenseIndex.from_device_embeddings(corpus)
    index.kernel = "pallas"
    q = torch.nn.functional.normalize(torch.randn(4, d, generator=torch.Generator().manual_seed(0)), dim=1)
    scores, ids = index.search_embeddings(q.numpy(), k=k)
    # the index rounds the queries to bf16; the reference keeps them in fp32
    best_v, best_i, got = rsearch.exact_scores(3, n, d, q, k, [[int(i) for i in r] for r in ids])
    for r in range(4):
        assert len(ids[r]) == k and min(got[r]) >= float(best_v[r, -1]) - 2e-2
        np.testing.assert_allclose(scores[r], got[r], atol=2e-2)
        assert float(best_v[r, 0]) == pytest.approx(float((corpus.float() @ q[r]).max()), abs=1e-6)


def test_weights_redraw_equal():
    a = ref.arch(_config("bloom", False))
    first = ref.draw_group(a, 2**40 + 5, 1, "cpu")
    second = ref.draw_group(a, 2**40 + 5, 1, "cpu")
    assert first.keys() == second.keys()
    assert all(torch.equal(first[k], second[k]) for k in first)
    other = ref.draw_group(a, 2**40 + 6, 1, "cpu")
    assert not torch.equal(first["layers.0.attn.wq"], other["layers.0.attn.wq"])
