"""Metric meters and the epoch-row sync of the SSL CLIs, one process.

The single-process half of `snuffy_tpu/utils/metrics_sync.py`: the
reference's windowed meters (`SmoothedValue`, `MetricLogger`, reference
dino_adapter/utils.py:229-405) and the CLIs' per-epoch helpers, which are
identities on one process (`global_min_int`, `sync_epoch_row`). The
cross-process half (the all-gather behind them) belongs to the multi-GPU
slice; `require_one_process` refuses a launch of more than one process
until then.
"""

from __future__ import annotations

import os
from collections import defaultdict, deque
from typing import Dict, Optional

import numpy as np


def require_one_process(what: str) -> None:
    """Raise SystemExit when the launcher asks for more than one process
    (WORLD_SIZE > 1, as torchrun sets it): the port's `what` runs on one
    device, and the multi-process sync is Slice 7's."""
    world = int(os.environ.get("WORLD_SIZE", "1") or 1)
    if world > 1:
        raise SystemExit(
            f"{what} runs in one process on one device; WORLD_SIZE={world} "
            "asks for more (multi-GPU data parallelism is ROADMAP.md Queue "
            "1, Slice 7)")


def global_min_int(value: int) -> int:
    """Smallest `value` across processes: one process, the value."""
    return int(value)


def sync_epoch_row(metrics: Dict[str, Optional[float]], n_batches: int,
                   weight_key: str = "n_train_batches"):
    """The SSL CLIs' epoch-log sync on one process: the row as it is, and
    this process writes it."""
    return dict(metrics), True


class SmoothedValue:
    """Windowed meter: median/avg over the last `window_size` updates,
    global_avg over everything (reference utils.py:229-287)."""

    def __init__(self, window_size: int = 20, fmt: Optional[str] = None):
        self.deque: deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt or "{median:.6f} ({global_avg:.6f})"

    def update(self, value: float, n: int = 1) -> None:
        self.deque.append(value)
        self.count += n
        self.total += value * n

    def synchronize_between_processes(self) -> None:
        """One process: nothing to reduce."""

    @property
    def median(self) -> float:
        return float(np.median(np.asarray(self.deque)))

    @property
    def avg(self) -> float:
        return float(np.mean(np.asarray(self.deque, np.float32)))

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)

    @property
    def max(self) -> float:
        return max(self.deque)

    @property
    def value(self) -> float:
        return self.deque[-1]

    def __str__(self) -> str:
        return self.fmt.format(
            median=self.median, avg=self.avg, global_avg=self.global_avg,
            max=self.max, value=self.value,
        )


class MetricLogger:
    """Named SmoothedValue meters (reference utils.py:316-405)."""

    def __init__(self, delimiter: str = "\t"):
        self.meters: Dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs) -> None:
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __getattr__(self, attr: str) -> SmoothedValue:
        meters = self.__dict__.get("meters")
        if meters is not None and attr in meters:
            return meters[attr]
        raise AttributeError(
            f"'{type(self).__name__}' object has no attribute '{attr}'"
        )

    def synchronize_between_processes(self) -> None:
        for meter in self.meters.values():
            meter.synchronize_between_processes()

    def global_averages(self) -> Dict[str, float]:
        return {k: m.global_avg for k, m in self.meters.items()}

    def __str__(self) -> str:
        return self.delimiter.join(
            f"{name}: {meter}" for name, meter in self.meters.items()
        )
