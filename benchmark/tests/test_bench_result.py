"""A whole run at a size the CPU holds: the result object's keys and their
order, each check beside its limit; and the command refusing a machine
without a card, or a directory without the program."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import run
from benchmark.tests.conftest import ROOT

BIG = 2**31 + 4242


def test_result_keys(serve_cell):
    res = run.execute(serve_cell, BIG, 5.0, False, "cpu")
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "kernel_build_s", "checks"]
    assert res["kernel_build_s"] == 0.0     # the CPU builds no kernel
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 1
    assert set(res["metrics"]) == {"slide_p90_s", "tiles_per_s", "setup_s"}
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(res["checks"]) == set(serve_cell.limits)
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(res)


def test_traced_run_needs_device_time(serve_cell):
    # the CPU profiler records no device operation: "not traced"
    with pytest.raises(run.NotTraced):
        run.execute(serve_cell, BIG, 5.0, True, "cpu")


def test_trace_summary_reads_busy_idle_and_kernels():
    from benchmark.trace import SPAN, summarize

    ev = [{"ph": "X", "cat": "user_annotation", "name": SPAN, "ts": 0,
           "dur": 100},
          {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0,
           "dur": 30},
          {"ph": "X", "cat": "cpu_op", "name": "predict", "ts": 40,
           "dur": 40},
          {"ph": "X", "cat": "kernel", "name": "x_row_stats_tc_kernel",
           "ts": 10, "dur": 20},
          {"ph": "X", "cat": "kernel", "name": "gemm", "ts": 25, "dur": 15},
          {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 60,
           "dur": 10}]
    s = summarize(ev, {"sparse_attention_fwd": ("row_stats",)}, 1.0)
    assert s.busy_s == pytest.approx(40e-6)
    assert s.window_s == pytest.approx(100e-6)
    assert s.kernel_s["sparse_attention_fwd"] == pytest.approx(20e-6)
    gaps = dict(map(tuple, s.idle_gaps))
    assert gaps["aten::mm"] == pytest.approx(10e-6)
    assert gaps["predict"] == pytest.approx(20e-6)
    assert gaps["host idle"] == pytest.approx(30e-6)
    assert s.device_ops[0][0] == "x_row_stats_tc_kernel"


def _python(args, cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_no_card_exits_without_a_result():
    out = _python(["benchmark/run.py", "--workload", "vits16.serve",
                   "--seed", str(BIG), "--seconds", "1", "--trace", "0"],
                  ROOT)
    assert out.returncode == 2
    assert "correct" not in out.stdout


def test_a_directory_of_the_benchmark_alone_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys, runpy; sys.argv = ['run.py', '--workload', "
            "'vits16.serve', '--seed', '1', '--seconds', '1'];"
            "import benchmark.run as r;"
            "c = r.Cell('vits16.serve');"
            "r.execute(c, 1, 1.0, False, 'cpu')")
    env = dict(os.environ, PYTHONPATH=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "snuffy_tpu_torch" in out.stderr
    assert "correct" not in out.stdout
