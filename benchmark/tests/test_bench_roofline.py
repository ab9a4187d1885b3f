"""`roofline.py` against counts made by hand at the configurations' published
widths, and the reference's token counts against its tokenizer."""
from __future__ import annotations

import pytest

from benchmark import harness, roofline
from benchmark.reference import model as ref
from benchmark.reference import text as rtext


def _arch(name: str, lm_head: bool = False) -> dict:
    return ref.arch(harness.load_json(harness.ROOT / f"benchmark/configs/{name}.json"), lm_head)


def test_published_widths():
    j, b = _arch("sgpt-5.8b", lm_head=True), _arch("sgpt-bloom-7b1")
    assert (j["D"], j["L"], j["H"], j["Dh"], j["F"], j["V"], j["rotary_dim"]) == \
        (4096, 28, 16, 256, 16384, 50400, 64)
    assert j["lm_head"] and not b["lm_head"]
    assert (b["D"], b["L"], b["H"], b["Dh"], b["F"], b["V"]) == (4096, 30, 32, 128, 16384, 250880)


@pytest.mark.parametrize("name, layers", [("sgpt-5.8b", 28), ("sgpt-bloom-7b1", 30)])
def test_matmul_params_by_hand(name, layers):
    # q, k, v, o: 4 × 4096²; MLP: 2 × 4096 × 16384
    per_layer = 4 * 4096 * 4096 + 2 * 4096 * 16384
    assert per_layer == 201_326_592
    assert roofline.matmul_params(_arch(name)) == layers * per_layer


def test_decoder_and_head_flops_by_hand():
    a = _arch("sgpt-5.8b", lm_head=True)
    # one row of 300 tokens: 2 FLOPs a weight a token; 300·301/2 = 45,150 causal
    # pairs, 4·4096 FLOPs a pair in each of 28 layers
    want = 2 * 5_637_144_576 * 300 + 4 * 4096 * 28 * 45_150
    assert roofline.decoder_flops(a, [300]) == pytest.approx(want, rel=1e-12)
    assert roofline.decoder_flops(a, [300, 20]) == pytest.approx(
        want + 2 * 5_637_144_576 * 20 + 4 * 4096 * 28 * 210, rel=1e-12)
    assert roofline.head_flops(a, 12) == 2 * 4096 * 50400 * 12


def test_k1_bound_by_hand():
    a = _arch("sgpt-bloom-7b1")
    # 64 rows of 300 tokens: q, k, v read and o written, bf16, 30 layers
    nbytes = 30 * 4 * 64 * 300 * 4096 * 2
    ops = 4 * 4096 * 30 * 64 * 45_150
    want = max(nbytes / 3.35e12, ops / 989e12)
    assert want == nbytes / 3.35e12          # bound by bytes at T = 300
    assert roofline.k1_bound_s(a, [300] * 64) == pytest.approx(want, rel=1e-12)


def test_k5_bound_by_hand():
    # NQ's corpus at GPT-J's width in bf16: 21.97 GB a scan, 6.557 ms at 3.35 TB/s
    rows, dim = 2_681_468, 4096
    assert rows * dim * 2 == 21_966_585_856
    assert roofline.k5_bound_s(rows, dim, 1, 8) == pytest.approx(rows * dim * 2 / 3.35e12)
    assert roofline.k5_bound_s(rows, dim, 10, 80) == pytest.approx(10 * rows * dim * 2 / 3.35e12)
    assert roofline.bound(0, 989e12)[1] == "operations"


@pytest.mark.parametrize("words", [0, 1, 297, 298, 299, 1400])
def test_token_counts_follow_the_tokenizer(words):
    text = " ".join(f"w{i}" for i in range(words))
    for q in (False, True):
        assert rtext.specb_len(text, 300) == len(rtext.specb_row(text, 50400, 300, q))
    if words:
        row, cont = rtext.ce_row("a b c d e f g h i j k l", text, 50400, 2048)
        assert rtext.ce_len("a b c d e f g h i j k l", text, 2048) == (len(row), len(cont))
