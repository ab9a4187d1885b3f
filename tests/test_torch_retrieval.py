"""Port's `DenseRetriever` == `sgpt_tpu.retrieval.DenseRetriever` on tiny
GPT-Neo engines with the same weights (fp32).

Result dicts hold the same documents in the same order, with scores within
1e-5 (the two engines' embeddings agree to ~1e-6; the score sums run in
another order). A query whose id is a document's id never retrieves that
document (self-hits are dropped after top_k + 1 are kept).
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
os.environ.setdefault("JAX_PLATFORMS", "cpu")
pytest.importorskip("jax").config.update("jax_platforms", "cpu")

import jax  # noqa: E402

from sgpt_tpu.encoder import EmbeddingEngine as JaxEngine  # noqa: E402
from sgpt_tpu.models import init_params as jax_init_params  # noqa: E402
from sgpt_tpu.models import tiny as jax_tiny  # noqa: E402
from sgpt_tpu.retrieval import DenseRetriever as JaxRetriever  # noqa: E402
from sgpt_tpu.tokenization import SimpleTokenizer  # noqa: E402
from sgpt_tpu_torch.encoder import EmbeddingEngine  # noqa: E402
from sgpt_tpu_torch.models import Decoder, from_jax_config, params_from_jax  # noqa: E402
from sgpt_tpu_torch.retrieval import DenseRetriever  # noqa: E402


@pytest.fixture(scope="module")
def engines():
    jcfg = jax_tiny("neo", num_layers=2)
    jparams = jax_init_params(jcfg, jax.random.key(0))
    cfg = from_jax_config(jcfg)
    model = Decoder(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams), cfg))
    tok = SimpleTokenizer(cfg.vocab_size)
    kw = dict(method="weightedmean", specb=True, batch_size=4, max_seq_len=64)
    return EmbeddingEngine(model, cfg, tok, device="cpu", **kw), JaxEngine(jparams, jcfg, tok, **kw)


def _corpus(n=60, seed=0):
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(50)]
    docs = {f"d{i}": " ".join(rng.choice(words, size=int(rng.integers(3, 30))))
            for i in range(n)}
    corpus = {d: {"title": "a title" if i % 4 == 0 else "", "text": t}
              for i, (d, t) in enumerate(docs.items())}
    # q-ids that are also doc ids (d7, d14): their own documents are dropped
    queries = {**{f"d{i * 7}": docs[f"d{i * 7}"] for i in (1, 2)},
               **{f"q{i}": docs[f"d{i * 5}"] for i in range(4)}}
    return corpus, queries


def _same(got, want):
    assert list(got) == list(want)
    for qid in want:
        assert list(got[qid]) == list(want[qid]), qid
        np.testing.assert_allclose(list(got[qid].values()), list(want[qid].values()),
                                   atol=1e-5)


@pytest.mark.parametrize("score_function", ["cos_sim", "dot"])
@pytest.mark.parametrize("chunk,top_k", [(10_000, 10), (17, 10), (13, 80)])
def test_retriever_matches_jax(engines, score_function, chunk, top_k):
    engine, jengine = engines
    corpus, queries = _corpus()
    kw = dict(score_function=score_function, corpus_chunk_size=chunk, device_chunk=128)
    got = DenseRetriever(engine, **kw).search(corpus, queries, top_k=top_k)
    want = JaxRetriever(jengine, **kw).search(corpus, queries, top_k=top_k)
    _same(got, want)
    for qid, hits in got.items():
        assert qid not in hits
        assert len(hits) == min(top_k, len(corpus) - (qid in corpus))
        scores = list(hits.values())
        assert scores == sorted(scores, reverse=True)
    assert got["q1"] and next(iter(got["q1"])) == "d5"  # identical text ranks first


def test_retriever_rejects_unknown_score_function(engines):
    with pytest.raises(ValueError, match="score_function"):
        DenseRetriever(engines[0], score_function="l2")
