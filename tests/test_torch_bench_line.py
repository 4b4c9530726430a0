"""``bench_torch.py``'s final line with its nine families, on the CPU.

The families of ``bench_torch.FAMILIES`` under their own names, each cut
to a small shape of its own module (``many`` at 4x4x40 with 8 cases,
``unstructured`` and its escalation at 6x6x24, ...), each a child
process as on the card: every family ran, converged, and sits in the
last line, which stays within ``FINAL_LINE_BYTES``. The line's trimming,
which drops the family entries' extras before anything a gate reads, is
held on a record too long for it.
"""
import json
import math
from pathlib import Path

import bench_torch
from torch_pin import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
CURV = ["--nx", "6", "--ny", "6", "--nz", "24", "--repeats", "1"]
# each family's module at a small shape, and the DOF that gives
SMALL = {
    "extruded": (["-m", "fea_tpu_torch.bench.tube", "--segments", "16", "--layers", "16", "--repeats", "1"], 1632),
    "curvilinear": (["-m", "fea_tpu_torch.bench.curv", *CURV], 3675),
    "canonicalized": (["-m", "fea_tpu_torch.bench.canon", *CURV], 3675),
    "arbitrary": (["-m", "fea_tpu_torch.bench.arbitrary", "--nx", "8", "--ny", "8", "--nz", "24", "--repeats", "1"],
                  4779),
    "many": (["-m", "fea_tpu_torch.bench.many", "--nx", "4", "--ny", "4", "--nz", "40", "--cases", "8"], 3075),
    "unstructured": (["-m", "fea_tpu_torch.bench.unstructured", *CURV], 3675),
    "curvilinear_812k": (["-m", "fea_tpu_torch.bench.curv", *CURV], 3675),
    "unstructured_812k": (["-m", "fea_tpu_torch.bench.unstructured", *CURV], 3675),
    "capacity_8m": ([str(ROOT / "bench_torch.py"), "--nx", "4", "--ny", "4", "--nz", "24", "--repeats", "1",
                     "--no-families", "--skip-numerics-check"], 1875),
}


def test_final_line_holds_every_family(monkeypatch):
    assert [name for name, _ in bench_torch.FAMILIES] == list(SMALL)
    assert bench_torch.ESCALATIONS == ("curvilinear_812k", "unstructured_812k", "capacity_8m")
    monkeypatch.setattr(bench_torch, "FAMILIES", tuple((name, argv) for name, (argv, _) in SMALL.items()))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    result = bench_torch.main(["--device", "cpu", "--nx", "8", "--ny", "8", "--nz", "64", "--repeats", "1"])
    fam = result["families"]
    assert list(fam) == list(SMALL)
    for name, (_, n_dof) in SMALL.items():
        entry = fam[name]
        assert "error" not in entry and "skipped" not in entry, (name, entry)
        assert entry["converged"] and entry["n_dof"] == n_dof and entry["relative_residual"] <= 1e-8, name
    # the batch's summary: its worst case, its batch wall and its cases
    assert fam["many"]["cases"] == 8 and fam["many"]["wall_s"] > 0 and isinstance(fam["many"]["iterations"], int)
    assert fam["unstructured"]["n_aggregates"] == 447
    assert bench_torch.exit_code(result) == 0
    text = bench_torch.final_line(result)
    assert len(text.encode()) <= bench_torch.FINAL_LINE_BYTES
    line = json.loads(text)
    assert list(line["families"]) == list(SMALL)
    assert all(line["families"][name]["converged"] for name in SMALL)


def test_final_line_trims_family_extras_first():
    """Nine families with long routes on a flagship of card-sized numbers:
    the line drops the flagship's stage split and the like, then the
    families' extras in ``DROPPABLE``'s order, and keeps every key a gate
    reads (n_dof, converged, relative_residual, iterations)."""
    family = {"n_dof": 811_923, "iterations": 48, "converged": True, "relative_residual": 5.9491234e-09,
              "wall_s": 0.0595123, "dof_per_s": 13_640_123.0, "route": "x" * 60, "n_aggregates": 592,
              "cases": 8, "per_case_s": 0.051234, "amortized_ratio": 0.41234}
    result = {"metric": "assemble_solve_dof_per_s", "value": 7_190_123.0, "vs_baseline": 32981.2, "converged": True,
              "n_dof": 1_048_707, "n_elements": 327_680, "iterations": 11, "relative_residual": 1.3991234e-09,
              "wall_s": 0.1291234, "first_wall_s": 0.5651234, "spread_s": 0.0121234,
              "stage_s": {"operator_build": 0.04, "multigrid_build": 0.06, "solve": 0.03},
              "tip_deflection_m": 0.0008360555897321743, "tip_beam_theory_m": 0.0008466660268258952,
              "tip_ratio": 0.9875, "solver": "staged", "numerics_check": 6.27e-16, "f64_apply_ms": 0.0419,
              "hbm_share": 0.1771, "peak_mem_gb": 0.232, "device": "NVIDIA H100 80GB HBM3, 700.00 W",
              "families": {name: dict(family) for name in SMALL}}
    line = json.loads(bench_torch.final_line(result))
    assert "stage_s" not in line and "route" not in line["families"]["many"]
    for entry in line["families"].values():
        assert {"n_dof", "iterations", "converged", "relative_residual", "wall_s"} <= set(entry)
    assert math.isclose(line["tip_ratio"], 0.9875)
