"""Port's `mips_topk` (the plain version, on CPU tensors) == the JAX Pallas
kernel `sgpt_tpu.ops.pallas.mips.mips_topk` in interpret mode, as
tests/test_pallas_mips.py runs it.

The four cases of that file, a bf16 corpus, Q = 1, k = 1 and 16, valid_count
< k (ids compared only in slots above -1e29: the filler's index differs by
design), N with a tail, and k = 17 refused. Values within 1e-5 (the products
are exact on both sides; the sums run in another order); ids equal. A CPU
call launches no kernel. Then the hazards of the card's bf16 scan (all-equal
rows, duplicates across a split boundary, valid_count at a tile boundary ± 1)
and a CPU witness of that scan's top-k logic (`_k5_emulate`).
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
os.environ.setdefault("JAX_PLATFORMS", "cpu")
pytest.importorskip("jax").config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

from sgpt_tpu.ops.pallas.mips import mips_topk as jax_mips_topk  # noqa: E402
from sgpt_tpu_torch.ops import mips  # noqa: E402


def _brute(q, c, k):
    scores = q @ c.T
    idx = np.argsort(-scores, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(scores, idx, axis=1), idx


def _run_both(q, c, valid, k, tile_n, dtype=np.float32):
    launches = mips.launches
    if dtype == np.float32:
        got = mips.mips_topk(torch.from_numpy(q), torch.from_numpy(c), valid, k=k)
        want = jax_mips_topk(jnp.asarray(q), jnp.asarray(c), valid, k=k, tile_n=tile_n,
                             interpret=True)
    else:
        got = mips.mips_topk(torch.from_numpy(q).to(torch.bfloat16),
                             torch.from_numpy(c).to(torch.bfloat16), valid, k=k)
        want = jax_mips_topk(jnp.asarray(q, jnp.bfloat16), jnp.asarray(c, jnp.bfloat16),
                             valid, k=k, tile_n=tile_n, interpret=True)
    assert mips.launches == launches, "a CPU call must not count a kernel launch"
    gv, gi = (t.numpy() for t in got)
    wv, wi = (np.asarray(t) for t in want)
    assert gv.dtype == np.float32 and gi.dtype == np.int32 and gv.shape == wv.shape
    real = wv > -1e29
    np.testing.assert_array_equal(gv > -1e29, real)
    np.testing.assert_allclose(gv, wv, atol=1e-5)
    np.testing.assert_array_equal(np.where(real, gi, -1), np.where(real, wi, -1))
    assert (gi[~real] == 0).all()  # the port's filler index
    return gv, gi


def _data(Q, N, D, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(Q, D)).astype(np.float32),
            rng.normal(size=(N, D)).astype(np.float32))


def test_mips_exact():
    q, c = _data(8, 1024, 64, 0)
    vals, idx = _run_both(q, c, 1024, 10, 256)
    wv, wi = _brute(q, c, 10)
    np.testing.assert_allclose(vals, wv, atol=1e-4)
    np.testing.assert_array_equal(idx, wi)


def test_mips_valid_count_masking():
    q, c = _data(4, 512, 32, 1)
    c[400:] = 50.0  # padded region must be invisible
    _, idx = _run_both(q, c, 400, 5, 128)
    assert (idx < 400).all()


def test_mips_single_tile_and_ties():
    q, c = _data(3, 128, 16, 2)
    c[7] = c[3]  # exact tie: lowest index must win first
    q[0] = c[3]
    vals, idx = _run_both(q, c, 128, 4, 128)
    assert idx[0].tolist()[:2] == [3, 7]
    np.testing.assert_array_equal(idx, _brute(q, c, 4)[1])


def test_mips_results_sorted_desc():
    q, c = _data(2, 256, 8, 3)
    vals, _ = _run_both(q, c, 256, 8, 64)
    assert (np.diff(vals, axis=1) <= 1e-6).all()


@pytest.mark.parametrize("Q,N,D,k,valid,tile", [
    (1, 512, 32, 10, 512, 128),     # one query
    (5, 512, 32, 1, 512, 128),      # k = 1
    (5, 768, 32, 16, 768, 256),     # k = 16, the largest
    (4, 512, 32, 10, 6, 128),       # valid_count < k: filler slots
    (4, 512, 32, 10, 0, 128),       # nothing valid
    (3, 1000, 24, 10, 1000, 8)])    # N with a tail no power-of-two tile divides
def test_mips_shapes(Q, N, D, k, valid, tile):
    q, c = _data(Q, N, D, Q + N + k)
    _run_both(q, c, valid, k, tile)


def test_mips_bf16_corpus():
    q, c = _data(6, 1024, 64, 7)
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    c[900:910] = c[10:20]  # duplicate rows: ties in bf16 too
    _run_both(q, c, 1024, 10, 256, dtype="bfloat16")


def test_k_above_16_is_refused():
    q, c = _data(2, 256, 8, 4)
    with pytest.raises(AssertionError):
        jax_mips_topk(jnp.asarray(q), jnp.asarray(c), 256, k=17, tile_n=128, interpret=True)
    with pytest.raises(ValueError, match="k=17"):
        mips.mips_topk(torch.from_numpy(q), torch.from_numpy(c), 256, k=17)


def test_valid_count_is_clamped():
    q, c = _data(2, 256, 8, 5)
    a = mips.mips_topk(torch.from_numpy(q), torch.from_numpy(c), 10**9, k=5)
    b = mips.mips_topk(torch.from_numpy(q), torch.from_numpy(c), 256, k=5)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    v, i = mips.mips_topk(torch.from_numpy(q), torch.from_numpy(c), -3, k=5)
    assert (v == mips.NEG).all() and (i == 0).all()


# The hazards of K5's bf16 tensor-core scan (csrc/mips.cu `scan_mma`): ties
# that every tile sees, duplicates on both sides of a pass-1 split boundary
# (`mips._splits` at the kernel's 256-row tiles, as planned for a small
# card), and valid_count one row either side of a tile boundary. The plain
# version against the JAX kernel in interpret mode.
def _boundary(Q, N):
    splits = mips._splits(Q, N, 6, mips._mma_query_block(Q, 32), mips.MMA_TILE_ROWS)
    return mips._rows_per_split(N, splits, mips.MMA_TILE_ROWS)


@pytest.mark.parametrize("k", [1, 10, 16])
def test_mips_all_equal_rows(k):
    q, c = _data(6, 1024, 32, 11)
    c[:] = c[7]  # every score of a query is the same: ids 0 .. k-1
    vals, idx = _run_both(q, c, 1024, k, 256)
    assert (idx == np.arange(k)).all()
    assert (vals == vals[:, :1]).all()


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_mips_duplicates_straddle_a_split_boundary(dtype):
    q, c = _data(5, 2048, 32, 12)
    b = _boundary(5, 2048)
    assert 0 < b < 2048
    c[[b - 1, b, b + 1, b + 256]] = c[40]  # both sides of the boundary
    q[0] = c[40]
    _, idx = _run_both(q, c, 2048, 10, 256, dtype=dtype)
    assert idx[0, :5].tolist() == [40, b - 1, b, b + 1, b + 256]


@pytest.mark.parametrize("valid", [255, 256, 257, 511, 512, 513])
def test_mips_valid_count_at_a_tile_boundary(valid):
    q, c = _data(4, 1024, 32, valid)
    c[valid:] = 50.0  # rows past valid_count hold the largest scores
    _, idx = _run_both(q, c, valid, 10, 256)
    assert (idx < valid).all()


# A CPU witness of scan_mma's top-k logic (numpy, on one fp32 score matrix):
# splits of whole tiles, the full fold of a split's first tile and of any
# tile whose survivors overflow the queue (slices of `wr` rows in row order,
# `fold_tile`), the register filter against each query's k-th entry read
# at the tile's start (`before`), the queue folded in a random order by
# insertion, and the merge of the splits' lists in the total order. It must
# give exactly the stable top-k of the same scores.
def _before(va, ia, vb, ib):
    return va > vb or (va == vb and ia < ib)


def _fold_tile(s, r0, lv, li):
    for j, sj in enumerate(s):
        if sj > lv[-1]:
            pos = int((lv >= sj).sum())
            lv[pos + 1:], li[pos + 1:] = lv[pos:-1].copy(), li[pos:-1].copy()
            lv[pos], li[pos] = sj, r0 + j


def _insert(lv, li, sv, row):
    pos = sum(_before(a, b, sv, row) for a, b in zip(lv, li))
    if pos < len(lv):
        lv[pos + 1:], li[pos + 1:] = lv[pos:-1].copy(), li[pos:-1].copy()
        lv[pos], li[pos] = sv, row


def _k5_emulate(scores, valid, k, splits, rps, tr, wr, qcap, rng):
    Q = scores.shape[0]
    stats = {"full": 0, "queued": 0}
    cand_v, cand_i = [], []
    for s in range(splits):
        rb, re = s * rps, min(valid, (s + 1) * rps)
        tv = np.full((Q, k), mips.NEG, np.float32)
        ti = np.zeros((Q, k), np.int64)
        for r0 in range(rb, re, tr):
            tile = scores[:, r0:min(r0 + tr, re)]
            full = r0 == rb
            if not full:
                kv, ki = tv[:, -1:].copy(), ti[:, -1:].copy()
                rows = np.arange(r0, r0 + tile.shape[1])[None]
                passed = (tile > kv) | ((tile == kv) & (rows < ki))
                full = passed.sum() > qcap
                if not full:
                    qq, jj = np.nonzero(passed)
                    stats["queued"] += len(qq)
                    for t in rng.permutation(len(qq)):
                        _insert(tv[qq[t]], ti[qq[t]], tile[qq[t], jj[t]], r0 + jj[t])
            if full:
                stats["full"] += 1
                for w in range(0, tile.shape[1], wr):
                    for qi in range(Q):
                        _fold_tile(tile[qi, w:w + wr], r0 + w, tv[qi], ti[qi])
        cand_v.append(tv)
        cand_i.append(ti)
    cv, ci = np.concatenate(cand_v, 1), np.concatenate(cand_i, 1)
    vals = np.full((Q, k), mips.NEG, np.float32)
    idx = np.zeros((Q, k), np.int64)
    for qi in range(Q):  # merge_kernel: the k first distinct candidates
        picked = sorted(set(zip((-cv[qi]).tolist(), ci[qi].tolist())))[:k]
        for j, (v, i) in enumerate(picked):
            if -v > -1e29:
                vals[qi, j], idx[qi, j] = -v, i
    return vals, idx, stats


@pytest.mark.parametrize("case", ["random", "all-equal", "duplicates", "valid-tile-1",
                                  "valid-tile+1", "valid<k", "overflow"])
def test_k5_scan_logic_gives_the_exact_top_k(case):
    rng = np.random.default_rng(len(case))
    Q, N, k, tr, wr, qcap = 6, 1500, 10, 64, 16, 256
    q, c = _data(Q, N, 16, len(case))
    valid = {"valid-tile-1": 6 * tr - 1, "valid-tile+1": 6 * tr + 1, "valid<k": 7}.get(case, N)
    if case == "overflow":
        qcap = 8  # most tiles take the full fold
    splits = mips._splits(Q, valid, 4, 8, tr)
    rps = mips._rows_per_split(valid, splits, tr)
    if case == "all-equal":
        c[:] = c[3]
    if case == "duplicates":
        c[[rps - 1, rps, rps + 1, 2 * rps]] = c[5]
        q[0] = c[5]
    scores = q @ c.T
    vals, idx, stats = _k5_emulate(scores, valid, k, splits, rps, tr, wr, qcap, rng)
    want_i = np.argsort(-scores[:, :valid], axis=1, kind="stable")[:, :k]
    want_v = np.take_along_axis(scores[:, :valid], want_i, 1)
    n = min(k, valid)
    np.testing.assert_array_equal(idx[:, :n], want_i)
    np.testing.assert_array_equal(vals[:, :n], want_v)
    assert (vals[:, n:] == mips.NEG).all() and (idx[:, n:] == 0).all()
    # the plain version agrees (its own fp32 products: values within 1e-5)
    pv, pi = mips.mips_topk(torch.from_numpy(q), torch.from_numpy(c), valid, k)
    np.testing.assert_allclose(pv.numpy(), vals, atol=1e-5)
    assert stats["full"] >= splits  # every split's first tile
    if case == "all-equal":
        assert (idx == np.arange(k)).all() and stats["queued"] == 0
    if case == "duplicates":
        assert idx[0, :5].tolist() == [5, rps - 1, rps, rps + 1, 2 * rps]
    if case == "overflow":
        assert stats["full"] > splits
    if case == "random":
        assert stats["queued"] > 0 and stats["full"] == splits
