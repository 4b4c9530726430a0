"""What a run reads by name: ``BENCHMARK.json`` at the root of the
checkout, and beside it, under ``benchmark/``, a configuration's file,
its mesh generator (``meshes/<mesh>.py``), a traffic mix
(``traffic/<mix>.json``) and a per-layer metric's reader
(``metrics/<metric>.py``). Adding any of them takes new files and new
entries in ``BENCHMARK.json``, and no edit here.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path


def load_module(path: Path):
    """The Python file ``path``, loaded under a name of its own."""
    name = "benchmark_" + "_".join(path.with_suffix("").parts[-2:]).replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Bench:
    """``BENCHMARK.json`` of the checkout at ``root``."""

    def __init__(self, root: Path):
        self.root = Path(root)
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())
        self.dir = self.root / "benchmark"

    @staticmethod
    def _named(entries: list, name: str, what: str) -> dict:
        for e in entries:
            if e["name"] == name:
                return e
        raise SystemExit(f"benchmark: no {what} named {name!r} in BENCHMARK.json")

    def cell(self, name: str) -> dict:
        return self._named(self.data["workloads"], name, "workload")

    def config(self, name: str) -> dict:
        entry = self._named(self.data["configs"], name, "configuration")
        return json.loads((self.root / entry["file"]).read_text())

    def traffic(self, name: str) -> dict:
        return json.loads((self.dir / "traffic" / f"{name}.json").read_text())

    def mesh_module(self, name: str):
        return load_module(self.dir / "meshes" / f"{name}.py")

    def metrics(self, kind: str, cell: str) -> list[dict]:
        """The ``kind`` (``end_to_end`` or ``per_layer``) metrics that
        ``cell`` reports: those that list it, and those that list none."""
        return [m for m in self.data[kind] if cell in m.get("workloads", [cell])]

    def reader(self, metric: dict):
        """The reader of a per-layer metric, held to its entry."""
        module = load_module(self.dir / "metrics" / f"{metric['name']}.py")
        for key, attr in (("unit", "UNIT"), ("layer", "LAYER"), ("moves", "MOVES")):
            if getattr(module, attr) != metric[key]:
                raise SystemExit(f"benchmark: {metric['name']}.py says {attr} = {getattr(module, attr)!r}, "
                                 f"BENCHMARK.json {key} = {metric[key]!r}")
        return module.read
