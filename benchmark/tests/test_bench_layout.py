"""BENCHMARK.json against the limits of its format, every entry found by
name, and a configuration, a traffic mix and a per-layer metric added as
new files with no edit to the harness."""
from __future__ import annotations

import json
import re

import pytest
import torch

from benchmark.harness import spec
from benchmark.tests import tiny

torch.set_num_threads(1)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return spec.Bench(tiny.REPO)


def test_top_level_keys_and_limits(bench):
    d = bench.data
    assert set(d) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert d["command"] == ["python3", "benchmark/run.py"] and d["paths"] == ["benchmark"]
    cells = len(d["workloads"])
    assert 1 <= cells <= 24 and 1 <= d["run_seconds"] <= 51
    # a check of 24 cells fits its time: 2 + 14 x 24 runs of run_seconds + 60 s, 180 s a cell to compile, 1200 s spare
    assert (2 + 14 * 24) * (d["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(d)) <= 64 * 1024
    names = [e["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for e in d[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)


def test_entries(bench):
    d = bench.data
    cells = {w["name"] for w in d["workloads"]}
    e2e = {m["name"] for m in d["end_to_end"]}
    assert "setup_s" in e2e
    for c in d["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and c["reduced"] == []
        cfg = bench.config(c["name"])
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
        bench.mesh_module(cfg["mesh"])
    for w in d["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
        bench.traffic(w["traffic"])
        assert len(bench.metrics("end_to_end", w["name"])) >= 2
        assert bench.metrics("per_layer", w["name"])
    for m in d["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") and m["source"] == "host_clock"
        assert 0.01 <= m["bound"] <= 0.25
    assert next(m for m in d["end_to_end"] if m["name"] == "setup_s")["bound"] == 0.25
    for m in d["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        assert callable(bench.reader(m))


def test_every_reader_file_says_what_it_reads(bench):
    """Readers kept for cells not yet in BENCHMARK.json load too."""
    for path in sorted((bench.dir / "metrics").glob("*.py")):
        m = spec.load_module(path)
        assert UNIT.match(m.UNIT) and m.LAYER and m.MOVES in {e["name"] for e in bench.data["end_to_end"]}
        assert callable(m.read)


def test_added_files_need_no_edit(tmp_path):
    """A new configuration, traffic mix and per-layer metric, each a new
    file with its entry in BENCHMARK.json, run with the harness as it is."""
    root = tiny.checkout(tmp_path)
    b = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((root / "benchmark/configs/voxel_1m.json").read_text()) | {"cells": [3, 3, 24],
                                                                                 "dof": tiny.dof([3, 3, 24])}
    (root / "benchmark/configs/added.json").write_text(json.dumps(cfg))
    mix = {"entry": "solve_many", "mesh": "shared", "load": "components", "load_scale": 1.0,
           "load_components": [[0.0, 0.0], [0.0, 0.0], [-2.0, -1.0]], "cases": 3,
           "warmup_requests": 1, "trace_requests": 1, "check_requests": 1}
    (root / "benchmark/traffic/added_mix.json").write_text(json.dumps(mix))
    (root / "benchmark/metrics/cases_per_request.py").write_text(
        'UNIT = "cases"\nLAYER = "Krylov loop"\nMOVES = "solved_dof_per_s"\n\n\n'
        "def read(run):\n    return sum(r.cases for r in run.requests) / len(run.requests)\n")
    b["configs"].append(dict(name="added", source="test", file="benchmark/configs/added.json", reduced=["cells"],
                             why="added"))
    b["workloads"].append(dict(name="added.mix", config="added", traffic="added_mix", chips=1, why="added"))
    b["per_layer"].append(dict(name="cases_per_request", unit="cases", better="higher", source="program_counter",
                               layer="Krylov loop", moves="solved_dof_per_s", workloads=["added.mix"]))
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    rc, lines, _ = tiny.run(root, "added.mix", trace=1)
    res = tiny.result(lines)
    assert rc == 0 and res["correct"] and res["metrics"]["cases_per_request"]["value"] == 3
    rc, lines, _ = tiny.run(root, "added.mix", trace=0)
    assert rc == 0 and set(tiny.result(lines)["metrics"]) == {
        "solved_dof_per_s", "request_s_p95", "peak_device_gb", "setup_s"}
