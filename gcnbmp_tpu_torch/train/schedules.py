"""Learning-rate schedules as plain functions of the step
(port of gcnbmp_tpu/train/schedules.py:17-59).

- ``exponential_shift_schedule``: lr multiplied by ``rate`` at each listed
  epoch boundary.
- ``cyclical_schedule``: CLR triangular / triangular2 / exp_range.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence


def exponential_shift_schedule(
    base_lr: float,
    shift_epochs: Sequence[int],
    steps_per_epoch: int,
    rate: float = 0.5,
) -> Callable[[int], float]:
    boundaries = [e * steps_per_epoch for e in sorted(shift_epochs)]

    def schedule(step: int) -> float:
        n_shifts = sum(step >= b for b in boundaries)
        return base_lr * (rate ** n_shifts)

    return schedule


def cyclical_schedule(
    base_lr: float,
    max_lr: float,
    step_size: int,
    mode: str = "triangular",
    gamma: float = 0.99994,
) -> Callable[[int], float]:
    """lr oscillates between base_lr and max_lr with half-cycle
    ``step_size`` iterations."""
    if mode not in ("triangular", "triangular2", "exp_range"):
        raise ValueError(f"unknown CLR mode {mode!r}")

    def schedule(step: int) -> float:
        cycle = math.floor(1 + step / (2.0 * step_size))
        x = abs(step / float(step_size) - 2 * cycle + 1)
        scale = max(0.0, 1.0 - x)
        if mode == "triangular":
            amp = 1.0
        elif mode == "triangular2":
            amp = 1.0 / (2.0 ** (cycle - 1))
        else:
            amp = gamma ** step
        return base_lr + (max_lr - base_lr) * scale * amp

    return schedule
