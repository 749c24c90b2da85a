r"""
LR schedules as pure functions of the step.

Counterpart of ``virtex_tpu/optim/lr_schedules.py``: every schedule is a
multiplier on the base LR with a built-in linear warmup ``step / warmup``
while ``step < warmup`` (1 from step 0 when warmup is 0):

- ``none``:      then constant 1;
- ``multistep``: then ``gamma ** (milestones passed)``;
- ``linear``:    then ``max((T − t) / (T − w), 0)``;
- ``cosine``:    then ``cos²(clip((t − w) / (T − w), 0, 1) · π/2)`` (cos²,
  not ½(1 + cos)).

A schedule maps a Python int step to a Python float, so scaling the update
by it needs no device round trip, and resuming needs no state.
"""
from __future__ import annotations

import bisect
import math
from typing import Callable, Sequence

Schedule = Callable[[int], float]


def _warmup(step: int, warmup_steps: int) -> float:
    return step / max(warmup_steps, 1) if step < warmup_steps else 1.0


def warmup_no_decay(total_steps: int, warmup_steps: int) -> Schedule:
    return lambda step: _warmup(step, warmup_steps)


def warmup_multistep(total_steps: int, warmup_steps: int,
                     milestones: Sequence[int], gamma: float = 0.1
                     ) -> Schedule:
    milestones = sorted(milestones)

    def schedule(step: int) -> float:
        passed = bisect.bisect_right(milestones, step)  # milestones <= step
        return _warmup(step, warmup_steps) * gamma ** passed
    return schedule


def warmup_linear_decay(total_steps: int, warmup_steps: int) -> Schedule:
    def schedule(step: int) -> float:
        if step < warmup_steps:
            return _warmup(step, warmup_steps)
        decay = (total_steps - step) / max(total_steps - warmup_steps, 1)
        return max(decay, 0.0)
    return schedule


def warmup_cosine_decay(total_steps: int, warmup_steps: int) -> Schedule:
    def schedule(step: int) -> float:
        if step < warmup_steps:
            return _warmup(step, warmup_steps)
        frac = (step - warmup_steps) / max(total_steps - warmup_steps, 1)
        return math.cos(min(max(frac, 0.0), 1.0) * math.pi / 2.0) ** 2
    return schedule


def make_schedule(name: str, total_steps: int, warmup_steps: int,
                  milestones: Sequence[int] = (), gamma: float = 0.1
                  ) -> Schedule:
    if name == "none":
        return warmup_no_decay(total_steps, warmup_steps)
    if name == "multistep":
        return warmup_multistep(total_steps, warmup_steps, milestones, gamma)
    if name == "linear":
        return warmup_linear_decay(total_steps, warmup_steps)
    if name == "cosine":
        return warmup_cosine_decay(total_steps, warmup_steps)
    raise ValueError(f"Unknown LR schedule {name!r}")
