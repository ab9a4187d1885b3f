"""search_p50_ms: the median of every request's latency (see search_p95_ms).
Its steadier neighbour: the host paces it."""
from benchmark.metrics._percentile import percentile


def read(run):
    if run["kind"] != "search":
        return None
    return percentile(run["latencies_ms"], 50)
