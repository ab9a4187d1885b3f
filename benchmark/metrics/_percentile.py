"""Nearest-rank percentiles over every request of a window; a failed or
unanswered request (None) counts as slower than any answer."""
import math


def percentile(latencies, q: float):
    if not latencies:
        return None
    vals = sorted(math.inf if x is None else x for x in latencies)
    v = vals[max(0, math.ceil(q / 100.0 * len(vals)) - 1)]
    return v if math.isfinite(v) else None
