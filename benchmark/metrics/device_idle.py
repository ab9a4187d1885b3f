"""device_idle: the share of the traced window in which no kernel, copy or
set ran on the card (torch.profiler's device events, their union)."""


def read(run):
    t = run["trace"]
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
