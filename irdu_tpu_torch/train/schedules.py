"""Learning-rate schedules (counterpart: ``irdu_tpu/train/schedules.py``),
plain functions of the update's index k, counted from 0 as optax counts it:
update k uses ``schedule(k)`` (``steps.apply_gradients``).

The flagship scheme: Adam at base lr 4e-4; ×0.5^0.25 at every 50k up to
600k; then cosine annealing from 5e-5 down to 1e-6 with T_max 701k,
counted from 0 at the switch.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence


def _n_decays(step: int, milestones: Sequence[int]) -> int:
    return sum(step >= m for m in milestones)


def multistep_then_cosine(base_lr: float, milestones: Sequence[int], gamma: float,
                          switch_step: int, cosine_base_lr: float, cosine_t_max: int,
                          eta_min: float) -> Callable[[int], float]:
    def schedule(step: int) -> float:
        if step < switch_step:
            return base_lr * gamma ** _n_decays(step, milestones)
        t = step - switch_step
        return eta_min + (cosine_base_lr - eta_min) * 0.5 * (
            1.0 + math.cos(math.pi * t / cosine_t_max))

    return schedule


def flagship_lr_schedule() -> Callable[[int], float]:
    return multistep_then_cosine(
        base_lr=4e-4,
        milestones=[50000 * i for i in range(1, 13)],
        gamma=math.sqrt(math.sqrt(0.5)),
        switch_step=600000,
        cosine_base_lr=5e-5,
        cosine_t_max=701000,
        eta_min=1e-6,
    )


def multistep_schedule(base_lr: float, milestones: Sequence[int],
                       gamma: float) -> Callable[[int], float]:
    """The pixel-domain family's scheme (MultiStepLR, ×gamma at each
    milestone)."""

    def schedule(step: int) -> float:
        return base_lr * gamma ** _n_decays(step, milestones)

    return schedule
