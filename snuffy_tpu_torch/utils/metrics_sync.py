"""Metric meters and their sync across processes.

The port of `snuffy_tpu/utils/metrics_sync.py`: the reference's windowed
meters (`SmoothedValue`, `MetricLogger`, reference dino_adapter/utils.py:
229-405, mae_adapter/util/misc.py:29-147) and the reductions across the
ranks of `parallel/distributed.py`:

  * `sync_metrics(d)`: one all-gather of a flat {name: scalar} dict over
    the host group (gloo), reduced on every rank (the reference's
    `reduce_dict`); count-weighted where the ranks saw unequal counts;
  * `sync_epoch_row`: the SSL CLIs' epoch row, count-weighted, and
    whether this rank writes it (rank 0);
  * `global_min_int`: the ranks agree on a loop bound, or the rank with
    one batch more launches a collective its peers never join;
  * `mesh_metric_mean`: a device tensor's mean over a mesh's ranks, one
    all-reduce.

One process short-circuits everywhere: identical results, no collective.
"""

from __future__ import annotations

from collections import defaultdict, deque
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from snuffy_tpu_torch.parallel import distributed


def _process_count() -> int:
    return distributed.world_size()


def _allgather_rows(vals: np.ndarray) -> np.ndarray:
    """Gather a (K,) float64 vector from every process → (P, K), over the
    host group. Module-level, so tests can simulate P > 1 in one process
    by monkeypatching it and `_process_count`."""
    return np.stack(distributed.host_allgather(np.asarray(vals,
                                                          np.float64)))


def sync_metrics(
    metrics: Dict[str, Optional[float]],
    *,
    average: bool = True,
    weight_key: Optional[str] = None,
) -> Dict[str, Optional[float]]:
    """All-reduce a flat dict of host-local scalars across processes.

    `average=True` → mean over processes (the reference reduce_dict
    average path); False → sum. With `weight_key` naming a per-host count
    entry, every other value is treated as a host-local MEAN over that
    many samples and reduced count-weighted (exact global mean when hosts
    saw unequal batch counts); the count itself is summed.

    None values ride the wire as NaN and are excluded per-key from the
    reduction (a key that is None on EVERY host stays None). This keeps
    the gathered vector the SAME length on every process even when hosts
    disagree about which metrics they produced this epoch (e.g. a host
    whose stride-shard had no validation batch) — dropping None keys
    per-host would make the collective shapes mismatch across processes.
    Keys are sorted before the collective so the wire order is identical
    on every process (reference utils.py:300-303).
    """
    if _process_count() < 2:
        return dict(metrics)
    keys = sorted(
        k for k, v in metrics.items()
        if v is None or isinstance(v, (int, float, np.floating, np.integer))
    )
    if not keys:
        return dict(metrics)
    vals = np.asarray(
        [np.nan if metrics[k] is None else float(metrics[k]) for k in keys],
        np.float64,
    )
    rows = _allgather_rows(vals)  # (P, K)
    out = dict(metrics)

    def reduce_col(col, w=None):
        ok = np.isfinite(col)
        if not ok.any():
            return None
        if w is not None:
            denom = max(w[ok].sum(), 1.0)
            return float((col[ok] * w[ok]).sum() / denom)
        s = col[ok].sum()
        return float(s / ok.sum()) if average else float(s)

    if weight_key is not None and weight_key in keys:
        w = np.nan_to_num(rows[:, keys.index(weight_key)])  # per-host counts
        for i, k in enumerate(keys):
            if k == weight_key:
                out[k] = float(w.sum())
            else:
                out[k] = reduce_col(rows[:, i], w)
        return out
    for i, k in enumerate(keys):
        out[k] = reduce_col(rows[:, i])
    return out


def sync_epoch_row(
    metrics: Dict[str, Optional[float]],
    n_batches: int,
    weight_key: str = "n_train_batches",
):
    """Epoch-log sync shared by the SSL CLIs: count-weight the host-local
    epoch means across processes and report whether THIS process is the
    log writer (process 0). Single-process: identity, always a writer.
    The `epoch` key passes through un-reduced."""
    if _process_count() < 2:
        return dict(metrics), True
    epoch = metrics.get("epoch")
    row = dict(metrics)
    row[weight_key] = float(n_batches)
    row = sync_metrics(row, weight_key=weight_key)
    row["epoch"] = epoch
    return row, distributed.is_primary()


def global_min_int(value: int) -> int:
    """Smallest `value` across processes (1-process: identity).

    Multi-host training loops MUST agree on how many collective steps they
    run: stride-sharded image lists give hosts unequal batch counts under
    drop_last, and a host that launches one more sharded step than its
    peers deadlocks the run (the reference's DistributedSampler pads ranks
    to equal length instead). Every per-epoch iteration bound in the CLIs
    goes through this.
    """
    if _process_count() < 2:
        return int(value)
    rows = _allgather_rows(np.asarray([float(value)], np.float64))
    return int(rows[:, 0].min())


def mesh_metric_mean(x: torch.Tensor, mesh) -> torch.Tensor:
    """Mean of `x` over the ranks of `mesh` (a new tensor, the same bits
    on every rank): one all-reduce, then a division by the rank count.
    No mesh (one process): `x`."""
    if mesh is None:
        return x
    out = x.detach().clone()
    dist.all_reduce(out, group=mesh.group)
    return out / mesh.size


class SmoothedValue:
    """Windowed meter: median/avg over the last `window_size` updates,
    global_avg over everything (reference utils.py:229-287).
    `synchronize_between_processes` reduces (count, total) only — the
    deque stays process-local, same caveat as the reference."""

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
        if _process_count() < 2:
            return
        red = sync_metrics(
            {"count": float(self.count), "total": self.total}, average=False
        )
        self.count = int(red["count"])
        self.total = float(red["total"])

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
    """Named SmoothedValue meters with cross-process sync
    (reference utils.py:316-405)."""

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
