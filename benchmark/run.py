"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The cell's configuration, traffic mix, limits
and per-layer metric readers are found by name (README.md). Set-up,
then a window of `--seconds`, then the check of the window's outputs
against the plain reference; the last line of standard output is one JSON
object: correct, attempted, failed, metrics, device (and, traced,
breakdown), `kernel_build_s` (the part of `setup_s` that nvcc took: above
0 only in a checkout's first run), then `checks`, each compared number
beside its limit.

Exit codes: 0 a result was printed; 2 no CUDA card, or fewer than the
cell asks for; 3 JAX or the JAX package was loaded; 4 torch.profiler
recorded no device time twice (`--trace 1`); anything else, a failure.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "benchmark"
FORBIDDEN = ("jax", "jaxlib", "flax", "snuffy_tpu")


def setup_environment() -> None:
    """Fixed cache directories inside the checkout, few host threads, and
    no JAX pulled in by a library."""
    cache = ROOT / "build" / "bench_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_ext"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("OMP_NUM_THREADS", "4")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def forbidden_modules(modules=None) -> list:
    """Top-level names of loaded modules that are JAX or the JAX package,
    compared whole (`snuffy_tpu_torch` is not `snuffy_tpu`)."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None
                                       else modules)}
    return sorted(names & set(FORBIDDEN))


def refuse_forbidden() -> None:
    found = forbidden_modules()
    if found:
        raise Forbidden(f"loaded in the run's process: {found}")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(
        "bench_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One workload of BENCHMARK.json with everything it names."""

    def __init__(self, name: str, root: Path = ROOT):
        manifest = load_json(root / "BENCHMARK.json")
        self.manifest = manifest
        self.entry = next((w for w in manifest["workloads"]
                           if w["name"] == name), None)
        if self.entry is None:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        cfg = next(c for c in manifest["configs"]
                   if c["name"] == self.entry["config"])
        self.config = load_json(root / cfg["file"])
        bench = root / "benchmark"
        self.traffic = load_json(bench / "traffic" /
                                 f"{self.entry['traffic']}.json")
        self.limits = load_json(bench / "limits" / f"{name}.json")
        self.driver = load_module(bench / "drivers" /
                                  f"{self.traffic['driver']}.py")
        self.end_to_end = [m for m in manifest["end_to_end"]
                           if name in m.get("workloads", [name])]
        e2e_names = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in manifest["per_layer"]
                          if name in m.get("workloads", [name])
                          and m["moves"] in e2e_names]
        self.readers = {m["name"]: load_module(bench / "metrics" /
                                               f"{m['name']}.py")
                        for m in self.per_layer}


def card(chips: int) -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips}


def power_line(device) -> str:
    from benchmark import roofline

    limit = "unknown"
    if device.type == "cuda":
        try:
            out = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True,
                timeout=30)
            limit = out.stdout.strip().splitlines()[0]
        except (OSError, subprocess.SubprocessError, IndexError):
            pass
    return (f"card: {limit}; peaks: {roofline.PEAK_BF16_FLOPS / 1e12} "
            f"TFLOP/s bf16, {roofline.PEAK_HBM_BYTES / 1e12} TB/s HBM")


def execute(cell: Cell, seed: int, seconds: float, trace: bool,
            device, t_start: float = None) -> dict:
    """Set-up, window and check of one run → the result object (without
    `device.kind`, which main() adds)."""
    import torch

    from benchmark import program
    from benchmark.trace import Tracer

    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    job = cell.driver.Job(cell.config, cell.traffic, seed, device)
    job.setup()
    setup_s = time.perf_counter() - t_start
    build_s = program.kernel_build_s()
    tracer = Tracer(program.kernel_passes(), device) if trace else None
    job.window(seconds, tracer)
    refuse_forbidden()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    attempted, failed = job.counts()
    metrics, dev = {}, {"memory_peak_bytes": int(peak)}
    if trace:
        if job.trace is None:
            raise NotTraced()
        for m in cell.per_layer:
            value = cell.readers[m["name"]].read(job)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
        dev.update(busy_s=job.trace.busy_s, window_s=job.trace.window_s)
    else:
        e2e = job.results()
        e2e["setup_s"] = setup_s
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": float(e2e[m["name"]]),
                                  "unit": m["unit"]}
    job.release()
    checks = {}
    for name, value in job.check().items():
        checks[name] = {"value": float(value),
                        "limit": float(cell.limits[name])}
    refuse_forbidden()
    correct = failed == 0 and all(c["value"] <= c["limit"]
                                  for c in checks.values())
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if trace:
        result["breakdown"] = job.trace.breakdown()
    result["kernel_build_s"] = build_s
    result["checks"] = checks
    return result


class NotTraced(RuntimeError):
    pass


class Forbidden(RuntimeError):
    pass


def main(argv=None) -> int:
    setup_environment()
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = Cell(args.workload)

    import torch

    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA card(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    print(power_line(device), flush=True)
    try:
        result = execute(cell, args.seed, args.seconds, bool(args.trace),
                         device, T_START)
    except Forbidden as err:
        print(f"refused: {err}", file=sys.stderr)
        return 3
    except NotTraced:
        print("not traced: torch.profiler recorded no device time in two "
              "tries", file=sys.stderr)
        return 4
    result["device"] = {**card(chips), **result["device"]}
    result["checks"] = result.pop("checks")
    print(f"nvcc in the set-up: {result['kernel_build_s']!r} s",
          file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
