"""The curvilinear cells' program readers in the result line of a traced
run of the tiny curvilinear cells."""
from __future__ import annotations

import json
import sys

import torch

from benchmark.tests import tiny

torch.set_num_threads(1)


def test_curvilinear_readers_in_a_traced_line(tmp_path, monkeypatch):
    """The curvilinear cells' program readers, listed for the tiny
    curvilinear cells, in the line of a traced run with the large-grid
    routes let in at this size: each reads a finite value (the build's
    spans in the fresh cell, where every request builds; these mixes have
    no warm-up request, so the loadcases window's first request builds
    too), and the rooflines, which find no card launch on the CPU, are
    left out."""
    import fea_tpu_torch  # noqa: F401

    monkeypatch.setattr(sys.modules["fea_tpu_torch.solve"], "_STRUCTURED_MIN_DOF", 0)
    root = tiny.checkout(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    names = {"fcg_iterations.curv", "certify_passes_per_case.curv", "curv_build_ms_per_request",
             "f64_apply_roofline.curv", "f32_apply_roofline.curv"}
    for m in bench["per_layer"]:
        if m["name"] in names:
            m["workloads"] += ["tiny_curv.loadcases", "tiny_curv.fresh"]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    for cell in ("tiny_curv.loadcases", "tiny_curv.fresh"):
        rc, lines, err = tiny.run(root, cell, trace=1)
        res = tiny.result(lines)
        assert rc == 0 and res["correct"] and res["failed"] == 0, err
        got = {k: v["value"] for k, v in res["metrics"].items() if k in names}
        assert set(got) == names - {"f64_apply_roofline.curv", "f32_apply_roofline.curv"}, got
        assert all(v >= 0 for v in got.values()) and got["fcg_iterations.curv"] >= 1, got
        assert got["curv_build_ms_per_request"] > 0 or cell.endswith("loadcases"), got
