"""Per-epoch learning-rate schedules: the port's copy of
`snuffy_tpu/train/schedules.py`.

The reference steps its scheduler once per epoch (reference train.py:735:
`self.trainer.scheduler.step()` after each epoch) with
CosineAnnealingLR(T_max=num_epochs, eta_min) or a warmup-cosine variant
(train.py:182-197). Here schedules are pure functions epoch → lr, and
the trainer takes lr as a plain argument of each epoch.
"""

from __future__ import annotations

import math
from typing import Callable


def cosine_annealing(lr: float, num_epochs: int, eta_min: float) -> Callable[[int], float]:
    """torch CosineAnnealingLR's closed form at integer epochs t:
    eta_min + (lr − eta_min)·(1 + cos(π·t/T)) / 2."""

    def schedule(epoch: int) -> float:
        return eta_min + (lr - eta_min) * (1 + math.cos(math.pi * epoch / num_epochs)) / 2

    return schedule


def cosine_warmup(lr: float, num_epochs: int, warmup_frac: float = 0.05) -> Callable[[int], float]:
    """Linear warmup over num_epochs/20 epochs then half-cosine decay
    (reference train.py:189-195 + the CosineWarmupScheduler helper)."""
    warmup_epochs = max(int(num_epochs * warmup_frac), 1)

    def schedule(epoch: int) -> float:
        factor = 0.5 * (1 + math.cos(math.pi * epoch / num_epochs))
        if epoch <= warmup_epochs:
            factor *= epoch / warmup_epochs
        return lr * factor

    return schedule


def constant(lr: float) -> Callable[[int], float]:
    return lambda epoch: lr


def make_epoch_schedule(name: str, lr: float, num_epochs: int, eta_min: float):
    if name == "cosine":
        return cosine_annealing(lr, num_epochs, eta_min)
    if name == "cosinewarmup":
        return cosine_warmup(lr, num_epochs)
    return constant(lr)
