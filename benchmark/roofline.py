"""The yardstick's arithmetic: the card's datasheet peaks, a bound from bytes
and operations, and the useful work of the benchmark's calls.

Work is counted from the real tokens of the cell's traffic as the
reference's tokenizer frames and truncates them (`reference/text.py`), not
from what the program dispatched: padding is the program's waste, so the
same traffic counts the same work whatever implements it.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates without sparsity, at 700 W
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "tf32": 495e12, "fp32": 67e12, "int8": 1979e12}


def bound(nbytes: float, ops: float, kind: str = "bf16") -> tuple:
    """(seconds, what binds): the least time the card could take to move
    nbytes and do ops at the datasheet peaks."""
    mem, comp = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[kind]
    return (mem, "bytes") if mem >= comp else (comp, "operations")


def matmul_params(a: dict) -> int:
    """Weights every token passes through, in all layers: q, k, v, o and
    the MLP's two projections (no embedding, no LM head)."""
    P = a["H"] * a["Dh"]
    return a["L"] * (4 * a["D"] * P + 2 * a["D"] * a["F"])


def causal_pairs(n: int) -> int:
    """(query, key) pairs of one causal row of n real tokens."""
    return n * (n + 1) // 2


def decoder_flops(a: dict, row_lengths) -> float:
    """Useful FLOPs of the decoder over rows of these real lengths: 2 per
    weight per token, and per layer 4·H·Dh per (query, key) pair (QKᵀ and PV)."""
    tokens = sum(row_lengths)
    pairs = sum(causal_pairs(n) for n in row_lengths)
    return 2.0 * matmul_params(a) * tokens + 4.0 * a["H"] * a["Dh"] * a["L"] * pairs


def head_flops(a: dict, scored_tokens: int) -> float:
    """The LM head's product at each scored position (SGPT-CE)."""
    return 2.0 * a["D"] * a["V"] * scored_tokens


def k1_bound_s(a: dict, row_lengths, elem_bytes: int = 2) -> float:
    """K1 (fused causal attention) over these rows in all layers: q, k and v
    read and the output written once for each real token, and the causal
    pairs' operations; the bound of all that work taken together."""
    tokens = sum(row_lengths)
    P = a["H"] * a["Dh"]
    nbytes = a["L"] * 4 * tokens * P * elem_bytes
    ops = 4.0 * P * a["L"] * sum(causal_pairs(n) for n in row_lengths)
    return bound(nbytes, ops)[0]


def k5_bound_s(rows: int, dim: int, launches: int, queries: int, elem_bytes: int = 2) -> float:
    """K5 (streaming MIPS top-k): each launch reads the index's rows once;
    2·D operations per (query, row)."""
    nbytes = launches * rows * dim * elem_bytes
    ops = 2.0 * queries * rows * dim
    return bound(nbytes, ops)[0]
