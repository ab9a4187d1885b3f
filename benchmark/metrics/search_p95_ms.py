"""search_p95_ms: the 95th percentile of every request's latency, timed from
when it was due (an open loop), over all requests of the window; a failed
request counts as missing (slower than any answer)."""
from benchmark.metrics._percentile import percentile


def read(run):
    if run["kind"] != "search":
        return None
    return percentile(run["latencies_ms"], 95)
