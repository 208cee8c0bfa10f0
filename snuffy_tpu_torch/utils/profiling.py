"""Tracing and profiling of the port: `snuffy_tpu/utils/profiling.py` on
torch.profiler.

  * `device_trace` — a torch.profiler trace of the block, written under
    `log_dir` as Chrome/Perfetto JSON (`*.pt.trace.json`), where the JAX
    package writes an XLA trace for TensorBoard/Perfetto;
  * `annotate` — a named span of the program: its host seconds into a
    `timings` dict, and, while a profiler records, a range in the trace
    (as `jax.profiler.TraceAnnotation` is) carrying its request's id;
  * `stream_edges` — while a profiler records, a CUDA event pair on the
    current stream around a block inside a span (the copy alone of
    `serve.upload`, the embedder's call of `serve.forward`), summed by
    `stream_seconds`;
  * `device_profile` and `traced` — the device time of a function by
    torch.profiler's kernel times, the readings of `tools/profile_*` and
    chip_smoke.py. torch.profiler has recorded no device time at all on
    one H100 machine, from a run's first trace on; `traced` tries once
    more, then returns None, and its callers report "not traced".

`device_trace` does nothing without a `log_dir`; outside a trace,
`annotate` only adds host seconds.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import os
import time
from typing import List, Optional, Tuple

import torch
from torch.autograd import profiler as _autograd_profiler

# calls of the function a device profile averages over
ITERS = 5

# Request ids, drawn only while a profiler records: the process's counter,
# and the id of the request whose spans are open in this thread or task.
_REQUEST_IDS = itertools.count(1)
_REQUEST: contextvars.ContextVar = contextvars.ContextVar("request",
                                                          default=None)


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
    with profile(activities=activities, record_shapes=True,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


class annotate:
    """A named span: `with annotate("serve.upload", timings): ...`.

    With no profiler recording it adds its host seconds (`perf_counter`)
    to `into["<the name's last part>_s"]` (`timings["upload_s"]`) where
    `into` is a dict, and does nothing else. While a profiler records it
    also opens a range of that name in the trace (a `user_annotation` on
    the device's clock, nested by call) whose one input is the id of its
    request (the trace shows it as "Concrete Inputs" where the profiler
    records shapes, as `device_trace` does): `request=True` opens a new
    request, the spans inside it carry its id."""

    __slots__ = ("name", "into", "key", "request", "_t0", "_range",
                 "_token")

    def __init__(self, name: str, into: Optional[dict] = None, *,
                 request: bool = False):
        self.name = name
        self.into = into
        self.key = name.rsplit(".", 1)[-1] + "_s"
        self.request = request
        self._range = None

    def __enter__(self):
        if _autograd_profiler._is_profiler_enabled:
            self._open()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        if self._range is not None:
            self._close()
        if self.into is not None:
            self.into[self.key] = self.into.get(self.key, 0.0) + dt
        return False

    def _open(self):
        if self.request:
            rid = next(_REQUEST_IDS)
            self._token = _REQUEST.set(rid)
        else:
            rid = _REQUEST.get()
        # record_function's `args` string reaches no trace; an int input
        # does (as "Concrete Inputs" where shapes are recorded)
        self._range = torch.autograd._record_function_with_args_enter(
            self.name, *(() if rid is None else (rid,)))

    def _close(self):
        torch.autograd._record_function_with_args_exit(self._range)
        self._range = None
        if self.request:
            _REQUEST.reset(self._token)


@contextlib.contextmanager
def stream_edges(pairs: Optional[list]):
    """While a profiler records and `pairs` is a list (the caller passes
    one only for a CUDA device): a CUDA event pair recorded on the current
    stream at the block's edges, appended to `pairs` for `stream_seconds`
    to read once the stream has passed it. Otherwise nothing."""
    if pairs is None or not _autograd_profiler._is_profiler_enabled:
        yield
        return
    start = torch.cuda.Event(enable_timing=True)
    start.record()
    yield
    end = torch.cuda.Event(enable_timing=True)
    end.record()
    pairs.append((start, end))


def stream_seconds(pairs: List[Tuple[torch.cuda.Event, torch.cuda.Event]]
                   ) -> float:
    """The seconds between each event pair of `stream_edges`' list,
    summed; the streams must have passed them."""
    return sum(a.elapsed_time(b) for a, b in pairs) / 1e3


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
