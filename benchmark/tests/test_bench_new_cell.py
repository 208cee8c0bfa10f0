"""A configuration, a traffic mix, a per-layer metric, an embedder
architecture and a cell added as new files only (and their entries in
BENCHMARK.json) are found by name; no file that was there is edited."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

from benchmark import run
from benchmark.tests.conftest import ROOT


def digest(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "benchmark").rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def copy_benchmark(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return tmp_path / "benchmark", digest(tmp_path)


def add_cell(root, cell, config, traffic, config_file):
    """The manifest entries of a new configuration and cell, which reports
    the serve cells' end-to-end metrics."""
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    manifest["configs"].append({
        "name": config, "source": "https://example.org",
        "file": f"benchmark/configs/{config_file}", "reduced": [],
        "why": "a test"})
    manifest["workloads"].append({
        "name": cell, "config": config, "traffic": traffic, "chips": 1,
        "why": "a test"})
    for m in manifest["end_to_end"]:
        if "workloads" in m and "vits16.serve" in m["workloads"]:
            m["workloads"].append(cell)
    return manifest


def test_cell_added_as_files(tmp_path):
    b, before = copy_benchmark(tmp_path)
    cfg = json.loads((b / "configs" / "snuffy-dino-vits16.json").read_text())
    cfg["milnet"]["big_lambda"] = 256
    (b / "configs" / "snuffy-dino-vits16-l256.json").write_text(
        json.dumps(cfg))
    traffic = json.loads((b / "traffic" / "slides.json").read_text())
    traffic["tiles_max"] = 3000
    (b / "traffic" / "short_slides.json").write_text(json.dumps(traffic))
    (b / "limits" / "vits16l256.short.json").write_text(
        (b / "limits" / "vits16.serve.json").read_text())
    (b / "metrics" / "tiles_traced.serve.py").write_text(
        "def read(job):\n    return float(len(job.traced))\n")
    manifest = add_cell(tmp_path, "vits16l256.short",
                        "snuffy-dino-vits16-l256", "short_slides",
                        "snuffy-dino-vits16-l256.json")
    manifest["per_layer"].append({
        "name": "tiles_traced.serve", "unit": "requests", "better": "higher",
        "source": "program_counter", "layer": "embedder",
        "moves": "tiles_per_s", "workloads": ["vits16l256.short"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))

    cell = run.Cell("vits16l256.short", root=tmp_path)
    assert cell.config["milnet"]["big_lambda"] == 256
    assert cell.traffic["tiles_max"] == 3000
    assert cell.driver.__file__.endswith("serve.py")
    assert set(cell.readers) == {"tiles_traced.serve"}
    assert {m["name"] for m in cell.end_to_end} == {
        "slide_p90_s", "tiles_per_s", "setup_s"}
    after = digest(tmp_path)
    assert all(after[p] == h for p, h in before.items())


# Run in the copy: its `benchmark` package ahead of the repository's.
NEW_ARCH_RUN = """
import json
from benchmark import flops, program, run
from benchmark.tests.conftest import tiny_serve_cell
cell = tiny_serve_cell("vitwide.serve")
e = cell.config["embedder"]
res = run.execute(cell, 2**31 + 99, 3.0, False, "cpu")
print(json.dumps({"reference": program.embedder_reference(e).__name__,
                  "flops": flops.embedder_flops_per_tile(e),
                  "correct": res["correct"], "checks": list(res["checks"])}))
"""


def test_architecture_added_as_files(tmp_path):
    """A new embedder architecture is two new files, `arch/<arch>.py` and
    `reference/<arch>.py`, which a new configuration names: here the ViT's
    files under another name. A cell on it runs, checked against its own
    reference, with no file of the benchmark edited."""
    b, before = copy_benchmark(tmp_path)
    (b / "reference" / "vitwide.py").write_text(
        (b / "reference" / "vit.py").read_text())
    arch_src = (b / "arch" / "vit.py").read_text()
    old = "from benchmark.reference import vit as reference"
    assert old in arch_src
    (b / "arch" / "vitwide.py").write_text(arch_src.replace(
        old, "from benchmark.reference import vitwide as reference"))
    cfg = json.loads((b / "configs" / "snuffy-dino-vits16.json").read_text())
    cfg["embedder"]["arch"] = "vitwide"
    (b / "configs" / "vitwide.json").write_text(json.dumps(cfg))
    (b / "limits" / "vitwide.serve.json").write_text(
        (b / "limits" / "vits16.serve.json").read_text())
    manifest = add_cell(tmp_path, "vitwide.serve", "vitwide", "slides",
                        "vitwide.json")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))

    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.pathsep.join([str(tmp_path), str(ROOT)]))
    out = subprocess.run([sys.executable, "-c", NEW_ARCH_RUN], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["reference"] == "benchmark.reference.vitwide"
    assert res["flops"] > 0
    assert res["correct"] is True
    assert set(res["checks"]) == set(json.loads(
        (b / "limits" / "vitwide.serve.json").read_text()))
    after = digest(tmp_path)
    assert all(after[p] == h for p, h in before.items())
