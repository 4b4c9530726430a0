"""A copy of the benchmark in a temporary checkout, with tiny
configurations beside the real ones, for the CPU tests: the harness
finds them by name like any other."""
from __future__ import annotations

import contextlib
import io
import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
TINY = {"tiny_voxel": ("voxel_1m", [4, 4, 32]), "tiny_curv": ("curv_812k", [4, 4, 16])}
MIXES = ("batch8", "loadcases", "fresh")


def dof(cells: list) -> int:
    """DOF of a box of ``cells`` hex8 elements."""
    nx, ny, nz = cells
    return 3 * (nx + 1) * (ny + 1) * (nz + 1)


def checkout(tmp: Path, cases: int = 4) -> Path:
    """``tmp`` holding BENCHMARK.json and benchmark/ with tiny copies of
    the configurations (cells cut) and of the traffic mixes (fewer cases,
    no warm-up), and a cell of each pair."""
    shutil.copy(REPO / "BENCHMARK.json", tmp / "BENCHMARK.json")
    shutil.copytree(REPO / "benchmark", tmp / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((tmp / "BENCHMARK.json").read_text())
    for name, (base, cells) in TINY.items():
        cfg = json.loads((tmp / "benchmark/configs" / f"{base}.json").read_text()) | {"cells": cells,
                                                                                     "dof": dof(cells)}
        (tmp / "benchmark/configs" / f"{name}.json").write_text(json.dumps(cfg))
        bench["configs"].append(dict(name=name, source="test", file=f"benchmark/configs/{name}.json",
                                     reduced=["cells"], why="a CPU test"))
    for mix in MIXES:
        m = json.loads((tmp / "benchmark/traffic" / f"{mix}.json").read_text())
        m |= {"warmup_requests": 0, "trace_requests": 1, "check_requests": 2}
        if m["entry"] == "solve_many":
            m["cases"] = cases
        (tmp / "benchmark/traffic" / f"tiny_{mix}.json").write_text(json.dumps(m))
        for name in TINY:
            bench["workloads"].append(dict(name=f"{name}.{mix}", config=name, traffic=f"tiny_{mix}", chips=1,
                                           why="a CPU test"))
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


def run(root: Path, cell: str, *, trace: int = 0, seed: int = 2**31 + 11, api=None) -> tuple[int, list, str]:
    """One run of ``cell`` on the CPU: (exit code, standard output lines,
    standard error)."""
    from benchmark import run as harness

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = harness.main(["--workload", cell, "--seed", str(seed), "--seconds", "0.2", "--trace", str(trace)],
                          root=root, device="cpu", api=api)
    return rc, out.getvalue().splitlines(), err.getvalue()


def result(lines: list) -> dict:
    return json.loads(lines[-1])
