"""Reading a `torch.profiler` trace of the measured window.

The window is marked by a `record_function` span from the harness; device
events (kernels, copies, sets) are clipped to it. From the raw Kineto events,
not `key_averages()`, which builds a Python object per event.
"""
from __future__ import annotations

import bisect
import contextlib
from collections import defaultdict
from typing import Optional

WINDOW_SPAN = "benchmark.window"
TOP = 10
SHORT_GAP_NS = 20_000   # idle gaps shorter than this are summed, not attributed


@contextlib.contextmanager
def traced(enabled: bool):
    """A profiler over the block (CPU and CUDA activity) and the window's
    span inside it; yields the profiler, or None when not enabled."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW_SPAN):
            yield prof


def _union(intervals):
    """Merged, sorted (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def summarize(prof) -> Optional[dict]:
    """busy_s (union of device intervals), window_s, per-kernel device seconds
    and the breakdown (top device ops; idle gaps by the innermost host op
    running at the gap's middle, the short ones together)."""
    events = prof.profiler.kineto_results.events()
    win = [e for e in events if e.name() == WINDOW_SPAN]
    if not win:
        return None
    t0, t1 = win[0].start_ns(), win[0].start_ns() + win[0].duration_ns()
    dev, host = [], []
    for e in events:
        kind = str(e.device_type())
        s, d = e.start_ns(), e.duration_ns()
        if e.is_user_annotation():   # spans (the window's own), mirrored on the device
            continue
        if kind.endswith("CUDA"):
            if s < t1 and s + d > t0:
                dev.append((max(s, t0), min(s + d, t1), e.name()))
        elif d > 0:
            host.append((s, s + d, e.name()))
    by_name = defaultdict(float)
    for s, e, name in dev:
        by_name[name] += (e - s) / 1e9
    busy = _union([(s, e) for s, e, _ in dev])
    busy_s = sum(e - s for s, e in busy) / 1e9
    gaps, prev = [], t0
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if t1 > prev:
        gaps.append((prev, t1))
    host.sort()
    starts = [h[0] for h in host]
    idle = defaultdict(float)
    for s, e in gaps:
        if e - s < SHORT_GAP_NS:
            idle[f"gaps under {SHORT_GAP_NS // 1000} us"] += (e - s) / 1e9
            continue
        mid = (s + e) // 2
        label, span = "host: outside any torch op", None
        # innermost host op holding the gap's middle: the shortest of those
        # that start before it (ops nest, so a scan back from the middle
        # finds them; bounded to keep long traces cheap)
        j = bisect.bisect_right(starts, mid) - 1
        for h in range(j, max(-1, j - 4096), -1):
            hs, he, name = host[h]
            if he >= mid and (span is None or he - hs < span):
                label, span = name, he - hs
        idle[label] += (e - s) / 1e9
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    return {"busy_s": busy_s, "window_s": (t1 - t0) / 1e9, "kernels": dict(by_name),
            "breakdown": {"device_ops": top(by_name), "idle_gaps": top(idle)}}
