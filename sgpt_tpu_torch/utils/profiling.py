"""Timing and profiler hooks (counterpart of `sgpt_tpu/utils/profiling.py`).

`Timer` for wall timing that waits for the card's queued work; `span` for a
named range of host work inside the program, recorded only while a torch
profiler runs; `profile_trace` wrapping `torch.profiler` over every thread
for a Chrome trace (viewable in Perfetto, chrome://tracing or TensorBoard's
profiler plugin).

A rate is items over `Timer.elapsed`: the timer's synchronise puts the
card's work inside the time.
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


_OFF = contextlib.nullcontext()


def span(name: str, **args):
    """A context manager naming the host work inside it. While a torch
    profiler records, a profiler range `name` with `args` (ints; shown as
    the event's arguments under `record_shapes=True`), which lands in the
    profiler's timeline beside the ops and kernels, on its clock; else one
    shared no-op context (~1 us).

    The range is an op-level record (`_RecordFunctionFast`, ~2 us) rather
    than `record_function`'s user annotation (~14 us, and its string
    argument is not recorded): a trace reader that puts each idle gap of the
    card down to the innermost host op running then names these ranges.
    The flag read is torch's process-wide one, so a thread the profiler was
    not started on sees it too (the C check is per thread); whether that
    thread's ranges are recorded is the profiler's setting (see
    `profile_trace`)."""
    if not torch.autograd.profiler._is_profiler_enabled:
        return _OFF
    return torch._C._profiler._RecordFunctionFast(name, (), args)


@contextlib.contextmanager
def profile_trace(logdir: Optional[str]):
    """torch.profiler over the block (CPU activities of every thread and,
    where a card is available, CUDA's), written as a Chrome trace
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
    # a profiler records only the threads it starts on unless told otherwise:
    # the micro-batchers' dispatcher threads start earlier
    every_thread = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir),
                 experimental_config=every_thread):
        yield
