"""Tracing and profiling of the port: `snuffy_tpu/utils/profiling.py` on
torch.profiler.

  * `StageTimer` — nested wall-clock scopes with a JSONL sink, a copy of
    the JAX package's (stdlib only);
  * `device_trace` — a torch.profiler trace of the block, written under
    `log_dir` as Chrome/Perfetto JSON (`*.pt.trace.json`), where the JAX
    package writes an XLA trace for TensorBoard/Perfetto;
  * `annotate` — a named span inside such a trace, as
    `jax.profiler.TraceAnnotation` is;
  * `device_profile` and `traced` — the device time of a function by
    torch.profiler's kernel times, the readings of `tools/profile_*` and
    chip_smoke.py. torch.profiler has recorded no device time at all on
    one H100 machine, from a run's first trace on; `traced` tries once
    more, then returns None, and its callers report "not traced".

`device_trace` and `annotate` do nothing without a `log_dir`, or outside a
trace.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, Optional

import torch

# calls of the function a device profile averages over
ITERS = 5


class StageTimer:
    """Nested named timers with aggregate stats and optional JSONL sink."""

    def __init__(self, sink_path: Optional[str] = None):
        self.sink_path = sink_path
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self._stack = []

    @contextlib.contextmanager
    def stage(self, name: str):
        full = "/".join([*self._stack, name])
        self._stack.append(name)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self._stack.pop()
            self.totals[full] = self.totals.get(full, 0.0) + dt
            self.counts[full] = self.counts.get(full, 0) + 1
            if self.sink_path:
                os.makedirs(os.path.dirname(self.sink_path) or ".",
                            exist_ok=True)
                with open(self.sink_path, "a") as f:
                    f.write(json.dumps({"stage": full, "seconds": dt}) + "\n")

    def summary(self) -> Dict[str, dict]:
        return {
            name: {
                "total_s": self.totals[name],
                "count": self.counts[name],
                "mean_s": self.totals[name] / self.counts[name],
            }
            for name in sorted(self.totals)
        }


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]):
    """Write a torch.profiler trace of the block under log_dir when it is
    set (`<host>_<pid>.<id>.pt.trace.json`); no-op otherwise. It traces the
    host, and the GPU wherever a CUDA device is available: there a profiler
    that cannot trace CUDA raises rather than trace the host alone."""
    if not log_dir:
        yield
        return
    from torch.profiler import (
        ProfilerActivity,
        profile,
        supported_activities,
        tensorboard_trace_handler,
    )

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        if ProfilerActivity.CUDA not in supported_activities():
            raise RuntimeError("a CUDA device is available but torch.profiler "
                               "cannot trace it")
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


def annotate(name: str):
    """Named span inside a device trace (record_function)."""
    return torch.profiler.record_function(name)


class NoDeviceTime(RuntimeError):
    """torch.profiler traced the calls but recorded no device time."""


def _self_device_us(e) -> float:
    t = getattr(e, "self_device_time_total", None)
    return float(t if t is not None else e.self_cuda_time_total)


def device_profile(fn):
    """(busy ms per call, [(op, self device ms per call, calls)] for host
    ops, [(kernel, ms per call)]) from a torch.profiler trace of ITERS
    calls; busy is the sum of the kernels' and copies' times. Raises
    NoDeviceTime where the profiler recorded none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(ITERS):
            fn()
        torch.cuda.synchronize()
    ops, kernels = [], []
    for e in prof.key_averages():
        ms = _self_device_us(e) / 1e3 / ITERS
        if getattr(e, "is_user_annotation", False):
            # a record_function range drawn on the device timeline (the
            # optimizer's step): it spans kernels counted on their own,
            # and the gaps between them
            continue
        if e.device_type == DeviceType.CUDA:
            kernels.append((e.key, ms))
        elif ms > 0:
            ops.append((e.key, ms, e.count / ITERS))
    busy = sum(ms for _, ms in kernels)
    if busy <= 0:
        raise NoDeviceTime("the profiler recorded no device time; it cannot "
                           "trace this GPU")
    ops.sort(key=lambda r: -r[1])
    kernels.sort(key=lambda r: -r[1])
    return busy, ops, kernels


def traced(fn):
    """`device_profile(fn)`, or None where torch.profiler records no device
    time at a second try either."""
    for _ in range(2):
        try:
            return device_profile(fn)
        except NoDeviceTime:
            pass
    return None
