"""rerank_pairs_per_s: (query, document) pairs scored over the whole window,
which ends when the call that crosses the window's length returns."""


def read(run):
    if run["kind"] != "rerank":
        return None
    return run["work"]["items"] / run["window_s"]
