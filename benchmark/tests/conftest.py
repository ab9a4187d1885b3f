"""Fixtures of the benchmark's tests: tiny versions of each cell for the CPU,
and the card for the tests marked `cuda`."""
from __future__ import annotations

import copy

import pytest

from benchmark import harness

TINY_WIDTHS = {
    "gptj": dict(vocab_size=512, n_embd=64, n_layer=2, n_head=4, rotary_dim=8),
    "bloom": dict(vocab_size=512, hidden_size=64, n_layer=2, n_head=4),
}
TINY_MIX = {
    "encode": dict(docs_per_call=24, lengths={"mu": 3.0, "sigma": 1.0, "lo": 12, "hi": 400}),
    "rerank": dict(queries_per_call=3, top_k=6, max_pairs_per_s=4,
                   lengths={"mu": 3.0, "sigma": 1.0, "lo": 12, "hi": 400}),
    "search": dict(index_rows=3000, rate_qps=40, workers=8, drain_s=20, warm_queries=8),
}
# the tiny models' own limits: at width 64 a score is ~0.5 (unit rows in 64-D),
# so the search's gaps are larger than at 4,096; every other limit is the cell's
TINY_LIMITS = {"search": {"hit_score_mean_err": 0.004, "rank_gap_mean": 0.002}}


def tiny_spec(name: str, root=harness.ROOT) -> dict:
    """The cell's files, cut to a width and a traffic the CPU runs in seconds."""
    spec = copy.deepcopy(harness.cell(harness.load_json(root / "BENCHMARK.json"), name, root))
    spec["config"]["hf_config"].update(TINY_WIDTHS[spec["config"]["family"]])
    kind = spec["mix"]["driver"]
    spec["mix"].update(TINY_MIX[kind])
    spec["limits"].update(TINY_LIMITS.get(kind, {}))
    return spec


@pytest.fixture(scope="session")
def manifest():
    return harness.load_json(harness.ROOT / "BENCHMARK.json")


@pytest.fixture
def card():
    """Skips without a CUDA card (decided here, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    return torch.device("cuda")
