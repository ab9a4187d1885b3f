"""search_batch_queries: queries the service searched in the window over K5's
launches in it: how many queries the micro-batcher coalesces a dispatch."""


def read(run):
    c = run["counters"]
    if run["kind"] != "search" or not c.get("k5_launches"):
        return None
    return c["queries_served"] / c["k5_launches"]
