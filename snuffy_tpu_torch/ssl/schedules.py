"""Per-iteration SSL schedules (cosine with linear warmup).

The port's copy of `snuffy_tpu/ssl/schedules.py`. The reference
precomputes per-iteration arrays (reference dino_adapter/utils.py:192-204
`cosine_scheduler`; MAE's per-iter half-cycle cosine,
mae_adapter/util/lr_sched.py:10-23); here the same curves are functions
step → value.
"""

from __future__ import annotations

import math
from typing import Callable


def cosine_iter_schedule(
    base_value: float,
    final_value: float,
    epochs: int,
    iters_per_epoch: int,
    warmup_epochs: int = 0,
    start_warmup_value: float = 0.0,
) -> Callable[[int], float]:
    warmup_iters = warmup_epochs * iters_per_epoch
    total = epochs * iters_per_epoch

    def schedule(it: int) -> float:
        if warmup_iters > 0 and it < warmup_iters:
            return start_warmup_value + (base_value - start_warmup_value) * it / warmup_iters
        progress = (it - warmup_iters) / max(1, total - warmup_iters)
        return final_value + 0.5 * (base_value - final_value) * (
            1 + math.cos(math.pi * progress)
        )

    return schedule


def mae_lr_schedule(
    base_lr: float, min_lr: float, epochs: int, warmup_epochs: int
) -> Callable[[float], float]:
    """Epoch-fractional half-cycle cosine with warmup
    (reference mae_adapter/util/lr_sched.py:10-23)."""

    def schedule(epoch: float) -> float:
        if epoch < warmup_epochs:
            return base_lr * epoch / max(warmup_epochs, 1e-8)
        return min_lr + (base_lr - min_lr) * 0.5 * (
            1.0 + math.cos(
                math.pi * (epoch - warmup_epochs) / max(epochs - warmup_epochs, 1e-8)
            )
        )

    return schedule
