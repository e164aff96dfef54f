"""BENCHMARK.json against the benchmark's contract, every configuration,
traffic, cell and metric file found by name, a cell added as data alone
found too, and the import guard: no file of the benchmark imports JAX or
the JAX package (top-level names compared whole), and the reference
imports nothing of the program either."""

import ast
import json
import os
import re
import shutil
import sys

import pytest

from benchmark import harness

ROOT = harness.ROOT
BENCH = os.path.join(ROOT, "benchmark")
SPEC = harness.load_json(ROOT, "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")


def test_top_level_keys_and_limits():
    assert list(SPEC) == ["command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"]
    assert len(json.dumps(SPEC)) <= 64 * 1024
    assert SPEC["paths"] == ["benchmark"] and SPEC["command"][1] == "benchmark/run.py"
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    assert 1 <= len(SPEC["configs"]) <= 24 and 1 <= len(SPEC["workloads"]) <= 24
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(SPEC["workloads"]) // 4)


def test_names_units_and_lines():
    names = [c["name"] for c in SPEC["configs"]] + [w["name"] for w in SPEC["workloads"]] \
        + [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert all(NAME.match(n) for n in names)
    assert len(set(c["name"] for c in SPEC["configs"])) == len(SPEC["configs"])
    assert len(set(w["name"] for w in SPEC["workloads"])) == len(SPEC["workloads"])
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    assert len(set(m["name"] for m in metrics)) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert LINE.match(c["source"]) and LINE.match(c["why"])
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert LINE.match(w["why"]) and w["chips"] in (1, 4)
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(set(pairs)) == len(pairs)
    assert {c["name"] for c in SPEC["configs"]} == {w["config"] for w in SPEC["workloads"]}


def test_metrics():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and LINE.match(m["layer"])
        assert set(m.get("workloads", cells)) <= cells
        assert os.path.isfile(os.path.join(BENCH, "metrics", m["name"] + ".py"))
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for w in cells:  # every cell reports a per-layer metric
        assert harness.metric_readers(SPEC, w)


def reported(cell):
    """The end-to-end metrics a cell reports."""
    return {m["name"] for m in SPEC["end_to_end"]
            if cell in m.get("workloads", [cell])}


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_each_cell_reports_its_rate_and_what_its_layers_move(cell):
    rate = harness.find_cell(cell)[4]["rate_metric"]
    assert reported(cell) == {rate, "setup_s"}
    for m in SPEC["per_layer"]:
        if cell in m.get("workloads", [cell]):
            assert m["moves"] in reported(cell), (cell, m["name"])


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_loads_by_name(cell):
    spec, w, cfg, traffic, c = harness.find_cell(cell)
    assert cfg["name"] == w["config"] and traffic["name"] == w["traffic"]
    assert set(c["counters"].values()) <= {"steps", "some", "none"}
    assert "steps" in c["counters"].values()
    multi = bool(cfg["sites"].get("quadrupoles"))
    numbers = {"start_r", "start_v", "force", "step_r", "step_v", "temperature",
               "upot", "pressure", "molecules"}
    if multi:
        numbers |= {"start_q", "torque", "step_q", "step_L"}
    assert set(c["limits"]) == numbers and c["limits"]["molecules"] == 0
    for k, v in c["limits"].items():
        assert 0 <= v < 1, k
    for key in ("reduced", "assumed", "source", "start"):
        assert key in cfg


def test_a_cell_added_as_data_is_found(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads(json.dumps(SPEC))
    spec["workloads"].append({"name": "lj_liquid_4m.added", "config": "lj_liquid_4m",
                              "traffic": "nvt_added", "chips": 1, "why": "a test"})
    spec["end_to_end"][0]["workloads"].append("lj_liquid_4m.added")
    spec["per_layer"].append({"name": "added_metric", "unit": "ms", "better": "lower",
                              "source": "device_trace", "layer": "device",
                              "moves": "mol_updates_per_s",
                              "workloads": ["lj_liquid_4m.added"]})
    idle = [m for m in spec["per_layer"] if m["name"] == "device.idle_share"][0]
    idle["workloads"].append("lj_liquid_4m.added")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    (root / "benchmark" / "traffic" / "nvt_added.json").write_text(
        json.dumps({"name": "nvt_added", "force_mode": "auto", "print_every": 10}))
    shutil.copy(root / "benchmark" / "cells" / "lj_liquid_4m.rmm.json",
                root / "benchmark" / "cells" / "lj_liquid_4m.added.json")
    (root / "benchmark" / "metrics" / "added_metric.py").write_text(
        "def read(trace):\n    return 1.5\n")
    _, w, cfg, traffic, cell = harness.find_cell("lj_liquid_4m.added", root=str(root))
    assert traffic["print_every"] == 10 and cfg["name"] == "lj_liquid_4m"
    readers = harness.metric_readers(spec, "lj_liquid_4m.added", root=str(root))
    assert readers["added_metric"][1](None) == 1.5
    assert "k1_roofline" not in readers and "device.idle_share" in readers


def imports_of(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def benchmark_files():
    for d, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_file_imports_jax_or_the_jax_package():
    found = {}
    for path in benchmark_files():
        for mod in imports_of(path):
            if mod.split(".")[0] in harness.FORBIDDEN:
                found[path] = mod
    assert not found


def test_the_reference_imports_nothing_of_the_program():
    ref = os.path.join(BENCH, "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            tops = {m.split(".")[0] for m in imports_of(os.path.join(ref, f))}
            assert tops <= {"__future__", "math", "itertools", "torch", "benchmark"}, f
            for m in imports_of(os.path.join(ref, f)):
                if m.startswith("benchmark"):
                    assert m.startswith("benchmark.reference"), (f, m)


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    for name in ("ls1_mardyn_tpu_torch", "ls1_mardyn_tpu_torch.ops", "jaxtyping",
                 "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert harness.forbidden_modules() == [] or "jax" in sys.modules
    monkeypatch.setitem(sys.modules, "ls1_mardyn_tpu.ops", sys)
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    got = harness.forbidden_modules()
    assert "ls1_mardyn_tpu" in got and "jax" in got
