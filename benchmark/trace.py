"""The traced part of a `--trace 1` run: torch.profiler over a bounded
stretch of the window, read in this process.

`Tracer.start` opens the profiler and a span `bench.traced` around the
stretch; `Tracer.stop` synchronises, closes both, writes the Chrome trace
under `TMPDIR`, reads it and deletes it. What it reads:

  busy_s      the union of the device's kernel, copy and set intervals
  window_s    the span's length on the trace's clock (the stretch is
              synchronised at both ends)
  device_ops  device time summed by operation name
  idle_gaps   the device's idle time inside the span, summed by what the
              host was doing at each gap's middle (the innermost host
              event or span open there; "host idle" where none is)
  kernel_s    device time of each kernel of the program's registry, by the
              fragments of its passes' names

A trace that holds no device operation is "not traced"; the caller tries
once more, as chip_smoke does.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Dict, List, Optional, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
             "python_function")
SPAN = "bench.traced"
TOP = 10


class TraceSummary:
    def __init__(self, busy_s, window_s, device_ops, idle_gaps, kernel_s,
                 n_device_events):
        self.busy_s = busy_s
        self.window_s = window_s
        self.device_ops = device_ops
        self.idle_gaps = idle_gaps
        self.kernel_s = kernel_s
        self.n_device_events = n_device_events

    def breakdown(self) -> dict:
        return {"device_ops": self.device_ops[:TOP],
                "idle_gaps": self.idle_gaps[:TOP]}


def _union(intervals: List[Tuple[float, float]]):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _host_names(points: List[float], host: List[Tuple[float, float, str]]
                ) -> List[str]:
    """For each time in `points` (ascending), the innermost host event open
    there: a sweep that keeps the open events on a stack."""
    host = sorted(host)
    names, stack, i = [], [], 0
    for t in points:
        while i < len(host) and host[i][0] <= t:
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        names.append(stack[-1][2] if stack else "host idle")
    return names


def summarize(events: list, kernel_passes: Dict[str, tuple],
              window_s: float) -> TraceSummary:
    """Read Chrome-trace events (µs) into a TraceSummary."""
    span = [e for e in events if e.get("name") == SPAN
            and e.get("cat") == "user_annotation"]
    device, host = [], []
    by_op: Dict[str, float] = {}
    kernel_s = {name: 0.0 for name in kernel_passes}
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a, d = float(e["ts"]), float(e["dur"])
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            device.append((a, a + d))
            name = e.get("name", "?")[:200]
            by_op[name] = by_op.get(name, 0.0) + d * 1e-6
            for kernel, passes in kernel_passes.items():
                if cat == "kernel" and any(p in name for p in passes):
                    kernel_s[kernel] += d * 1e-6
        elif cat in HOST_CATS and e.get("name") != SPAN:
            host.append((a, a + d, e.get("name", "?")[:200]))
    merged = _union(device)
    if span:
        lo = float(span[0]["ts"])
        hi = lo + float(span[0]["dur"])
        merged = [[max(a, lo), min(b, hi)] for a, b in merged
                  if b > lo and a < hi]
        window_s = (hi - lo) * 1e-6
    else:
        lo = merged[0][0] if merged else 0.0
        hi = merged[-1][1] if merged else 0.0
    busy = sum(b - a for a, b in merged) * 1e-6
    spans = []
    edges = [lo] + [x for ab in merged for x in ab] + [hi]
    for a, b in zip(edges[0::2], edges[1::2]):
        a, b = max(a, lo), min(b, hi)
        if b > a:
            spans.append((a, b))
    gaps: Dict[str, float] = {}
    names = _host_names([0.5 * (a + b) for a, b in spans], host)
    for (a, b), name in zip(spans, names):
        gaps[name] = gaps.get(name, 0.0) + (b - a) * 1e-6
    ops = sorted(([k, v] for k, v in by_op.items()), key=lambda kv: -kv[1])
    idle = sorted(([k, v] for k, v in gaps.items()), key=lambda kv: -kv[1])
    return TraceSummary(busy, window_s, ops, idle, kernel_s, len(device))


class Tracer:
    """One profiled stretch at a time; `stop` returns its TraceSummary, or
    None where the profiler recorded no device operation."""

    def __init__(self, kernel_passes: Dict[str, tuple], device):
        self.kernel_passes = kernel_passes
        self.device = torch.device(device)
        self._prof = None
        self._span = None
        self._t0 = 0.0

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self._sync()
        self._prof = profile(activities=activities)
        self._prof.__enter__()
        self._span = torch.profiler.record_function(SPAN)
        self._span.__enter__()
        self._t0 = time.perf_counter()

    def stop(self) -> Optional[TraceSummary]:
        self._sync()
        window_s = time.perf_counter() - self._t0
        self._span.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(suffix=".pt.trace.json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.unlink(path)
        self._prof = None
        summary = summarize(events, self.kernel_passes, window_s)
        return summary if summary.n_device_events else None
