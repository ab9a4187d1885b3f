"""The K5 wrapper's planning (`sgpt_tpu_torch/ops/mips.py`), in plain Python:
the corpus splits of pass 1 and the tensor-core scan's block of queries.

No card and no JAX: the splits are what the kernel computes from the count
the wrapper passes (`_rows_per_split` mirrors `launch_mma`/`launch_simt`),
and `_mma_query_block` mirrors `mma_qb` in `csrc/mips.cu` (the card test
`test_mips_query_block_matches_the_plan` holds the two equal).
"""
import pytest

pytest.importorskip("torch")

from sgpt_tpu_torch.ops import mips  # noqa: E402


def _covered(valid, splits, tile_rows):
    rps = mips._rows_per_split(valid, splits, tile_rows)
    spans = [(s * rps, min(valid, (s + 1) * rps)) for s in range(splits)]
    return rps, spans


@pytest.mark.parametrize("Q", [1, 16, 64, 65, 1024])
@pytest.mark.parametrize("valid", [0, 1, 255, 257, 20_011, 2_681_468])
@pytest.mark.parametrize("slots,tile_rows", [(132, mips.MMA_TILE_ROWS),
                                             (264, mips.SIMT_TILE_ROWS), (7, 32)])
def test_splits_cover_every_valid_row_once(Q, valid, slots, tile_rows):
    qb = mips._mma_query_block(Q, 768)
    splits = mips._splits(Q, valid, slots, qb, tile_rows)
    assert 1 <= splits <= 65535
    rps, spans = _covered(valid, splits, tile_rows)
    assert rps % tile_rows == 0  # splits start on a tile
    if valid == 0:
        assert splits == 1
        return
    # every valid row once, in order, and no split without a row
    assert spans[0][0] == 0 and spans[-1][1] == valid
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    assert all(e > s for s, e in spans)
    # no more blocks than the slots hold in the waves the plan takes
    blocks = -(-Q // qb) * splits
    assert blocks <= 8 * slots or splits == 1


@pytest.mark.parametrize("Q,slots,want", [(64, 132, 131), (1, 132, 131), (65, 132, 66),
                                          (1024, 132, 8)])
def test_splits_at_the_main_shape_fill_the_card_in_one_wave(Q, slots, want):
    """NQ's corpus (2,681,468 rows) at D=768 on an H100's 132 SMs: one block
    an SM, each with one contiguous split (131 splits of 80 tiles at Q=64)."""
    qb = mips._mma_query_block(Q, 768)
    splits = mips._splits(Q, 2_681_468, slots, qb, mips.MMA_TILE_ROWS)
    assert splits == want
    assert -(-Q // qb) * splits <= slots


@pytest.mark.parametrize("D", [768, 784, 2048, 2560, 4096])
@pytest.mark.parametrize("Q", [1, 8, 9, 17, 33, 64, 65, 1024])
def test_query_block_holds_the_queries_and_fits_shared_memory(Q, D):
    qb = mips._mma_query_block(Q, D)
    assert qb in (8, 16, 32, 64)
    stages = mips._mma_stages(qb, D)
    assert stages >= mips.MMA_MIN_STAGES and stages <= mips.MMA_MAX_STAGES
    smem = 2 * qb * (-(-D // 64) * 64 + 8) + 8 * qb * mips.K_MAX + 8 * mips.QUEUE + 16
    assert smem + stages * mips.MMA_STAGE_BYTES <= mips.SMEM_MAX
    if qb < 64:  # the smallest block that holds all Q, unless shared memory halved it
        assert qb >= Q or mips._mma_stages(2 * qb, D) < mips.MMA_MIN_STAGES
    if qb > 8:  # and no larger than needed
        assert qb // 2 < Q


def test_query_block_at_the_main_widths():
    """QB 64 at D=768 (7 ring stages), 32 at D=2048 (5) and 2560 (3)."""
    assert [(mips._mma_query_block(64, D), mips._mma_stages(mips._mma_query_block(64, D), D))
            for D in (768, 2048, 2560)] == [(64, 7), (32, 5), (32, 3)]
    assert [mips._mma_query_block(Q, 768) for Q in (1, 8, 16, 1024)] == [8, 8, 16, 64]
