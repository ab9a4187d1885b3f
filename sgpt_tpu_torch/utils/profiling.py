"""Timing / throughput / profiler hooks (counterpart of
`sgpt_tpu/utils/profiling.py`).

`Timer` for wall timing that waits for the card's queued work,
`ThroughputMeter` for the embeddings/sec counter, `profile_trace` wrapping
`torch.profiler` for a Chrome trace (viewable in Perfetto, chrome://tracing
or TensorBoard's profiler plugin).
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch


class Timer:
    """Wall-clock timer that synchronises the current CUDA device on exit
    (when CUDA is initialised), so the time covers the work it queued. A
    device error raised by the synchronise propagates."""

    def __init__(self, sync: bool = True):
        self.sync = sync
        self.elapsed = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.sync and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        self.elapsed = time.perf_counter() - self._t0
        return False


class ThroughputMeter:
    """Counts items (e.g. embeddings) per second across laps."""

    def __init__(self):
        self.items = 0
        self.seconds = 0.0

    @contextlib.contextmanager
    def lap(self, n_items: int):
        t0 = time.perf_counter()
        yield
        self.seconds += time.perf_counter() - t0
        self.items += n_items

    @property
    def per_second(self) -> float:
        return self.items / self.seconds if self.seconds else 0.0


@contextlib.contextmanager
def profile_trace(logdir: Optional[str]):
    """torch.profiler over the block (CPU activities and, where a card is
    available, CUDA's), written as a Chrome trace
    `<host>_<pid>.<ns>.pt.trace.json` into `logdir` on exit; a no-op when
    logdir is falsy."""
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)):
        yield
