"""BENCHMARK.json against the benchmark's contract, and every file it
names present."""

import json
import re

import pytest

from benchmark.tests.conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def manifest():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def test_top_level(manifest):
    assert set(manifest) == KEYS
    assert 1 <= manifest["run_seconds"] <= 51
    assert manifest["command"][:2] == ["python3", "benchmark/run.py"]
    assert manifest["paths"] == ["benchmark"]


def test_names_and_units(manifest):
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in manifest[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((group, entry["name"]))
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
            for key in ("why", "layer", "source"):
                if key in entry:
                    assert 1 <= len(entry[key]) <= 200
                    assert "\n" not in entry[key] and "\t" not in entry[key]
    for group in ("configs", "workloads"):
        group_names = [n for g, n in names if g == group]
        assert len(group_names) == len(set(group_names))
    metrics = [n for g, n in names if g in ("end_to_end", "per_layer")]
    assert len(metrics) == len(set(metrics))


def test_end_to_end(manifest):
    cells = {w["name"] for w in manifest["workloads"]}
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    for cell in cells:
        reported = [m for m in e2e.values()
                    if cell in m.get("workloads", [cell])]
        assert len(reported) >= 2, cell


def test_per_layer_metrics_move_what_their_cells_report(manifest):
    cells = {w["name"] for w in manifest["workloads"]}
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    layers = set()
    for m in manifest["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        for cell in m["workloads"]:
            assert cell in cells
            assert cell in e2e[m["moves"]].get("workloads", [cell])
        layers.add(m["layer"])
        if m["unit"] == "%" and "roofline" in m["name"]:
            assert m["name"].split(".")[0].endswith("_roofline")
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").exists()
    for cell in cells:
        assert any(cell in m["workloads"] for m in manifest["per_layer"])


def test_files_named_by_cells(manifest):
    configs = {c["name"]: c for c in manifest["configs"]}
    files = [c["file"] for c in configs.values()]
    assert len(files) == len(set(files))
    used = set()
    for w in manifest["workloads"]:
        assert w["chips"] in (1, 4)
        cfg = configs[w["config"]]
        used.add(w["config"])
        assert cfg["file"].startswith("benchmark/")
        with open(ROOT / cfg["file"]) as f:
            assert json.load(f)["reduced"] == cfg["reduced"]
        traffic = ROOT / "benchmark" / "traffic" / f"{w['traffic']}.json"
        with open(traffic) as f:
            driver = json.load(f)["driver"]
        assert (ROOT / "benchmark" / "drivers" / f"{driver}.py").exists()
        assert (ROOT / "benchmark" / "limits" / f"{w['name']}.json").exists()
    assert used == set(configs)
    for cfg in configs.values():
        with open(ROOT / cfg["file"]) as f:
            arch = json.load(f)["embedder"]["arch"]
        for part in ("arch", "reference"):
            assert (ROOT / "benchmark" / part / f"{arch}.py").exists()
    pairs = [(w["config"], w["traffic"]) for w in manifest["workloads"]]
    assert len(pairs) == len(set(pairs))
