"""The program's spans as the benchmark's trace reader sees them: an idle
stretch of the window in which the host runs a program span and no torch op
is put down to that span's name, and the span leaves the window's device
readings alone."""
from __future__ import annotations

import time

from benchmark import tracing


def test_an_idle_gap_inside_a_program_span_takes_its_name():
    from sgpt_tpu_torch.utils import span

    with tracing.traced(True) as prof:
        with span("engine.tokenize"):
            time.sleep(0.05)   # host work with no torch op, the card idle
    out = tracing.summarize(prof)
    assert out["busy_s"] == 0 and out["kernels"] == {}
    (label, seconds), = out["breakdown"]["idle_gaps"]
    assert label == "engine.tokenize" and seconds >= 0.05
