"""LR schedules (counterpart of `sgpt_tpu/training/schedules.py`).

The five ST `fit()` schedulers: constantlr, warmupconstant, warmuplinear,
warmupcosine and warmupcosinewithhardrestarts. Each is a plain function
step → lr with optax's value at every step: optax's `linear_schedule`,
`cosine_decay_schedule` and `join_schedules` are written out below. `step`
is the number of updates already made, as optax counts it, so the first
warmup step runs at lr 0. The trainer hands a schedule to
`torch.optim.lr_scheduler.LambdaLR` over an optimizer whose base lr is 1,
so the lr of each step is the schedule's value itself.
"""
from __future__ import annotations

import math
from typing import Callable, Sequence

Schedule = Callable[[int], float]


def _linear(init: float, end: float, steps: int) -> Schedule:
    """optax.linear_schedule: init → end over `steps`, then end."""
    if steps <= 0:
        return lambda count: init

    def schedule(count):
        frac = 1 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end

    return schedule


def _cosine(init: float, decay_steps: int, alpha: float = 0.0) -> Schedule:
    """optax.cosine_decay_schedule."""
    if not decay_steps > 0:
        raise ValueError(f"cosine decay needs positive decay_steps, got {decay_steps}")

    def schedule(count):
        count = min(count, decay_steps)
        cosine_decay = 0.5 * (1 + math.cos(math.pi * count / decay_steps))
        return init * ((1 - alpha) * cosine_decay + alpha)

    return schedule


def _join(schedules: Sequence[Schedule], boundaries: Sequence[int]) -> Schedule:
    """optax.join_schedules: past each boundary the next schedule takes over,
    counting from the boundary."""
    def schedule(step):
        out = schedules[0](step)
        for boundary, sched in zip(boundaries, schedules[1:]):
            if step >= boundary:
                out = sched(step - boundary)
        return out

    return schedule


def _constant(lr: float) -> Schedule:
    return lambda count: lr


def warmup_linear(lr: float, warmup_steps: int, total_steps: int) -> Schedule:
    """Linear warmup 0→lr over warmup_steps, then linear decay lr→0."""
    warmup_steps = max(warmup_steps, 1)
    return _join([_linear(0.0, lr, warmup_steps),
                  _linear(lr, 0.0, max(total_steps - warmup_steps, 1))], [warmup_steps])


def warmup_cosine(lr: float, warmup_steps: int, total_steps: int) -> Schedule:
    """optax.warmup_cosine_decay_schedule(0, lr, max(warmup, 1),
    max(total, warmup + 1), 0); like it, raises when that leaves no decay
    step (warmup 0, total 1)."""
    decay_steps = max(total_steps, warmup_steps + 1)
    warmup_steps = max(warmup_steps, 1)
    return _join([_linear(0.0, lr, warmup_steps),
                  _cosine(lr, decay_steps - warmup_steps)], [warmup_steps])


def warmup_cosine_hard_restarts(lr: float, warmup_steps: int, total_steps: int,
                                cycles: int = 1) -> Schedule:
    """Linear warmup, then `cycles` cosine decays lr→0, each restarting at lr
    (the transformers schedule ST dispatches, with its default of 1 cycle)."""
    warmup_steps = max(warmup_steps, 1)
    decay_total = max(total_steps - warmup_steps, cycles)
    seg = decay_total // cycles
    schedules = [_linear(0.0, lr, warmup_steps)]
    boundaries = [warmup_steps]
    for c in range(cycles):
        steps = seg if c < cycles - 1 else decay_total - seg * (cycles - 1)
        schedules.append(_cosine(lr, max(steps, 1)))
        if c < cycles - 1:
            boundaries.append(boundaries[-1] + steps)
    return _join(schedules, boundaries)


def make_schedule(name: str, lr: float, warmup_steps: int, total_steps: int) -> Schedule:
    name = name.lower()
    if name == "constantlr":
        return _constant(lr)
    if name == "warmupconstant":
        return _join([_linear(0.0, lr, max(warmup_steps, 1)), _constant(lr)],
                     [max(warmup_steps, 1)])
    if name == "warmuplinear":
        return warmup_linear(lr, warmup_steps, total_steps)
    if name == "warmupcosine":
        return warmup_cosine(lr, warmup_steps, total_steps)
    if name == "warmupcosinewithhardrestarts":
        return warmup_cosine_hard_restarts(lr, warmup_steps, total_steps)
    raise ValueError(f"unknown scheduler {name!r}")
