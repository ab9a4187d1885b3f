"""The port's search utilities == the JAX package's.

`semantic_search` (cosine and dot, query chunks of 7 over a corpus of 300
rows, which pads to 384, and k larger than the corpus), `paraphrase_mining_
embeddings` and `community_detection` on the same fp32 embeddings, drawn
with numpy from a seed around 6 centres (so that communities exist and no two
scores tie): the same ids, pairs and communities, and scores within 1e-6
(fp32 products in another summation order).
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
os.environ.setdefault("JAX_PLATFORMS", "cpu")
pytest.importorskip("jax").config.update("jax_platforms", "cpu")

import sgpt_tpu.ops.search_utils as js  # noqa: E402
import sgpt_tpu_torch.ops.search_utils as ps  # noqa: E402

RNG = np.random.default_rng(7)
CENTRES = RNG.normal(size=(6, 16))
EMB = (CENTRES[RNG.integers(0, 6, 300)] + 0.35 * RNG.normal(size=(300, 16))).astype(np.float32)
QUERIES = RNG.normal(size=(20, 16)).astype(np.float32)


def _assert_hits_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert [h["corpus_id"] for h in g] == [h["corpus_id"] for h in w]
        np.testing.assert_allclose([h["score"] for h in g], [h["score"] for h in w],
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("score_function,top_k", [("cos_sim", 10), ("dot", 5),
                                                  ("cos_sim", 500)])
def test_semantic_search_matches_jax(score_function, top_k):
    kw = dict(top_k=top_k, score_function=score_function, query_chunk_size=7)
    got = ps.semantic_search(QUERIES, EMB, device="cpu", **kw)
    _assert_hits_equal(got, js.semantic_search(QUERIES, EMB, **kw))
    assert len(got[0]) == min(top_k, len(EMB))
    one = ps.semantic_search(torch.from_numpy(QUERIES[0]), EMB, device="cpu", **kw)
    _assert_hits_equal(one, got[:1])
    with pytest.raises(ValueError, match="score_function"):
        ps.semantic_search(QUERIES, EMB, score_function="cosine", device="cpu")


def test_paraphrase_mining_matches_jax():
    got = ps.paraphrase_mining_embeddings(EMB[:120], top_k=4, max_pairs=200, device="cpu")
    want = js.paraphrase_mining_embeddings(EMB[:120], top_k=4, max_pairs=200)
    assert [(a, b) for _, a, b in got] == [(a, b) for _, a, b in want]
    np.testing.assert_allclose([s for s, _, _ in got], [s for s, _, _ in want],
                               rtol=1e-6, atol=1e-6)
    assert len(got) == 200 and all(a < b for _, a, b in got)


@pytest.mark.parametrize("threshold,min_size", [(0.75, 10), (0.9, 3)])
def test_community_detection_matches_jax(threshold, min_size):
    kw = dict(threshold=threshold, min_community_size=min_size)
    got = ps.community_detection(EMB, device="cpu", **kw)
    assert got == js.community_detection(EMB, **kw)
    assert len(got) >= 2


def test_the_card_is_the_default_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default runs there")
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        ps.semantic_search(QUERIES, EMB)
