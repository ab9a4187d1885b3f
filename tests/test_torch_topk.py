"""Port's `ops/topk.py` == `sgpt_tpu.ops.topk` on the same inputs.

`merge_topk`, `chunked_topk` and `blockmax_topk`, fp32 and the int8
`corpus_scale` path, with `row_mask`, several slabs, k above a chunk, a
top-k clustered in one block, `valid_count` masking and duplicate rows
(ties). Ids equal exactly (the -inf filler slots included); values within
1e-5 (fp32; the products are exact on both sides, the sums run in another
order).
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
os.environ.setdefault("JAX_PLATFORMS", "cpu")
pytest.importorskip("jax").config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

from sgpt_tpu.ops import topk as jtopk  # noqa: E402
from sgpt_tpu_torch.ops import topk  # noqa: E402


def _data(n, d=16, q=5, seed=0, dup=False):
    rng = np.random.default_rng(seed)
    corpus = rng.normal(size=(n, d)).astype(np.float32)
    queries = rng.normal(size=(q, d)).astype(np.float32)
    if dup:  # exact ties: copies of rows, and a query that is one of them
        corpus[n // 2: n // 2 + 20] = corpus[3:23]
        corpus[n - 7] = corpus[3]
        queries[0] = corpus[3]
    return corpus, queries


def _same(got, want):
    gv, gi = (t.numpy() for t in got)
    wv, wi = (np.asarray(t) for t in want)
    np.testing.assert_array_equal(gi, wi)
    finite = np.isfinite(wv)
    np.testing.assert_array_equal(np.isfinite(gv), finite)
    np.testing.assert_allclose(gv[finite], wv[finite], atol=1e-5)


def test_merge_topk_keeps_the_first_set_on_ties():
    va = np.array([[3.0, 1.0, 1.0]], np.float32)
    ia = np.array([[7, 8, 9]], np.int32)
    vb = np.array([[1.0, 2.0, 3.0]], np.float32)
    ib = np.array([[1, 2, 3]], np.int32)
    for k in (1, 3, 5):
        got = topk.merge_topk(*(torch.from_numpy(x) for x in (va, ia, vb, ib)), k)
        want = jtopk.merge_topk(*(jnp.asarray(x) for x in (va, ia, vb, ib)), k)
        _same(got, want)
    assert topk.merge_topk(*(torch.from_numpy(x) for x in (va, ia, vb, ib)), 3)[1].tolist() \
        == [[7, 3, 2]]


@pytest.mark.parametrize("n,valid,k,chunk,dup", [
    (1024, 1024, 10, 256, False), (1024, 700, 10, 128, False), (512, 512, 20, 8, False),
    (512, 5, 10, 128, False), (768, 768, 7, 256, True)])
def test_chunked_topk_matches_jax(n, valid, k, chunk, dup):
    corpus, queries = _data(n, seed=n + valid, dup=dup)
    got = topk.chunked_topk(torch.from_numpy(queries), torch.from_numpy(corpus), valid,
                            k=k, chunk_size=chunk)
    want = jtopk.chunked_topk(jnp.asarray(queries), jnp.asarray(corpus), valid,
                              k=k, chunk_size=chunk)
    _same(got, want)


@pytest.mark.parametrize("n,valid,k,block,slab,dup,clustered", [
    (1024, 1024, 10, 128, 1 << 20, False, False),    # one slab
    (1024, 1000, 9, 128, 256, False, False),         # 4 slabs, masked tail
    (2048, 2048, 300, 128, 512, False, False),       # k above a block and below a slab
    (256, 256, 40, 16, 64, False, True),             # the top-k all in one block
    (512, 3, 10, 128, 128, False, False),            # valid_count < k
    (768, 768, 12, 64, 256, True, False),            # duplicate rows
    (384, 384, 600, 128, 1 << 20, False, False)])    # k above N: -inf filler
def test_blockmax_topk_matches_jax(n, valid, k, block, slab, dup, clustered):
    corpus, queries = _data(n, seed=n + k, dup=dup)
    if clustered:
        corpus[32:48] = queries[0] * 5 + 0.01 * corpus[32:48]
    got = topk.blockmax_topk(torch.from_numpy(queries), torch.from_numpy(corpus), valid,
                             k=k, block_size=block, slab_size=slab)
    want = jtopk.blockmax_topk(jnp.asarray(queries), jnp.asarray(corpus), valid,
                               k=k, block_size=block, slab_size=slab)
    _same(got, want)


@pytest.mark.parametrize("slab", [1 << 20, 128])
@pytest.mark.parametrize("masked", [False, True])
def test_blockmax_int8_scale_and_row_mask_match_jax(slab, masked):
    corpus, queries = _data(1024, d=32, seed=11)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    scale = (np.abs(corpus).max(axis=1) / 127.0).astype(np.float32)
    q8 = np.round(corpus / scale[:, None]).astype(np.int8)
    mask = np.ones(1024, bool)
    if masked:
        mask[np.random.default_rng(1).choice(1000, 100, replace=False)] = False
    kw_t = dict(k=10, block_size=128, slab_size=slab,
                corpus_scale=torch.from_numpy(scale),
                row_mask=torch.from_numpy(mask) if masked else None)
    kw_j = dict(k=10, block_size=128, slab_size=slab, corpus_scale=jnp.asarray(scale),
                row_mask=jnp.asarray(mask) if masked else None)
    got = topk.blockmax_topk(torch.from_numpy(queries), torch.from_numpy(q8), 1000, **kw_t)
    want = jtopk.blockmax_topk(jnp.asarray(queries), jnp.asarray(q8), 1000, **kw_j)
    _same(got, want)
    if masked:
        assert mask[got[1].numpy()].all()


def test_blockmax_bf16_corpus_matches_jax():
    corpus, queries = _data(512, d=32, seed=5)
    c16 = torch.from_numpy(corpus).to(torch.bfloat16)
    q16 = torch.from_numpy(queries).to(torch.bfloat16)
    got = topk.blockmax_topk(q16, c16, 512, k=10, block_size=128, slab_size=256)
    want = jtopk.blockmax_topk(jnp.asarray(queries, jnp.bfloat16),
                               jnp.asarray(corpus, jnp.bfloat16), 512, k=10,
                               block_size=128, slab_size=256)
    _same(got, want)
