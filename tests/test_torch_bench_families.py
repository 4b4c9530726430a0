"""Port parity, the family benches: each ``fea_tpu_torch.bench`` module
against its tool in the JAX package's ``tools/`` at a small shape, on the
CPU, and ``bench_torch.py``'s running of the families.

The tools run as child processes (``--cpu``, ``JAX_PLATFORMS=cpu``), the
port's modules in process through ``main(argv)`` with ``--device cpu``.
Each pair builds the same scene: equal DOF and element counts and the
same route; the port converges with a true residual at most tol
recomputed on the host in NumPy f64 (``host_ku``), and its tip and
reaction figures are within 1e-6 of the tool's. Iterations are no more
than the tool's plus the margin the port's own test of that route allows
(named beside each case). At these shapes the canonicalized and
arbitrary scenes are under the 50,000-DOF threshold of the grid and
unstructured routes, so both packages' ``solve()`` take Jacobi PCG there.
"""
import json
import re

import pytest

import fea_tpu_torch.bench.arbitrary
import fea_tpu_torch.bench.canon
import fea_tpu_torch.bench.curv
import fea_tpu_torch.bench.tube
from torch_pin import one_torch_thread  # noqa: F401
from torch_tools import ROOT, run_all

TOL = 1e-8
# family -> (port module, JAX tool, shape arguments, iteration margin over the tool's)
CASES = {
    # tests/test_torch_extruded.py::test_solve_extruded_matches_jax: no more than JAX's
    "tube": (fea_tpu_torch.bench.tube, "tube_bench.py", ["--segments", "16", "--layers", "16"], 0.0),
    # tests/test_torch_curvilinear.py::test_curvilinear_solve_matches_jax: no more than JAX's
    "curv": (fea_tpu_torch.bench.curv, "curv_bench.py", ["--nx", "6", "--ny", "6", "--nz", "24"], 0.0),
    # Jacobi PCG: tests/test_torch_small.py::test_cubebeam_anchor_matches_jax, within 2% of JAX's
    "canon": (fea_tpu_torch.bench.canon, "canon_bench.py", ["--nx", "6", "--ny", "6", "--nz", "24"], 0.02),
    "arbitrary": (fea_tpu_torch.bench.arbitrary, "arbitrary_bench.py", ["--nx", "8", "--ny", "8", "--nz", "24"],
                  0.02),
}


@pytest.fixture(scope="module")
def tools():
    """Each tool's run, all at once: name -> (its record, its stderr)."""
    return run_all({name: (f"tools/{tool}", [*shape, "--repeats", "1"]) for name, (_, tool, shape, _) in CASES.items()})


@pytest.mark.parametrize("name", list(CASES))
def test_family_matches_its_tool(tools, name):
    module, _, shape, margin = CASES[name]
    ref, ref_err = tools[name]
    got = module.main([*shape, "--repeats", "1", "--device", "cpu", "--deadline-s", "0"])
    assert not got.get("partial"), got.get("error")
    assert (got["n_dof"], got["n_elements"]) == (ref["n_dof"], ref["n_elements"])
    assert got.get("route") == ref.get("route")
    assert got["converged"] and ref["converged"]
    assert got["relative_residual"] <= TOL
    assert got["iterations"] <= ref["iterations"] * (1.0 + margin)
    assert got["device"] == "cpu" and not any(got["launches"].values())
    if name == "tube":
        assert got["tip_uy_m"] == pytest.approx(ref["tip_uy_m"], rel=1e-6)
        assert got["metric"] == ref["metric"] == "tube_extruded_solve_s"
    if name == "canon":  # the tool prints the balance on stderr
        balance = float(re.search(r"reaction balance (\S+)", ref_err).group(1))
        assert abs(got["reaction_balance"] - balance) <= 1e-6
    for key in ref:
        if key not in ("backend", "fine_apply_ms"):  # the TPU's own keys
            assert key in got, key


@pytest.mark.parametrize("name", list(CASES))
def test_family_without_a_card_raises(name, monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CASES[name][0].main(CASES[name][2])


def test_bench_runs_every_family_and_marks_each_failure(monkeypatch):
    """``bench_torch.py`` with a family list of small runs: each family in
    its own process and its summary in the last line; a family that exits
    non-zero with its record (a tol no solve meets), with a partial record
    (a scene its tool refuses) or without one (a module that does not
    exist) is marked with its error and the exit code is 1; the capacity child (``bench_torch.py`` itself) maps onto a
    family summary; a budget too small for the families skips them, which
    is a failure too, and ``--no-families`` exits 0."""
    import bench_torch

    tube = ["-m", "fea_tpu_torch.bench.tube", *CASES["tube"][2], "--repeats", "1"]
    small = [("extruded", tube),
             ("unconverged", tube + ["--tol", "1e-30"]),
             ("partial", ["-m", "fea_tpu_torch.bench.arbitrary", "--nx", "1", "--ny", "1", "--nz", "2"]),
             ("crashed", ["-m", "fea_tpu_torch.bench.no_such_family"]),
             ("capacity_8m", [str(ROOT / "bench_torch.py"), "--nx", "4", "--ny", "4", "--nz", "24", "--repeats", "1",
                              "--no-families", "--skip-numerics-check"])]
    monkeypatch.setattr(bench_torch, "FAMILIES", tuple(small))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    args = ["--device", "cpu", "--nx", "4", "--ny", "4", "--nz", "16", "--repeats", "1", "--skip-numerics-check"]
    result = bench_torch.main(args)
    fam = result["families"]
    assert list(fam) == [name for name, _ in small]
    for name in ("extruded", "capacity_8m"):
        assert "error" not in fam[name] and fam[name]["converged"] and fam[name]["relative_residual"] <= TOL, name
    assert fam["extruded"]["n_dof"] == 1632 and fam["capacity_8m"]["n_dof"] == 3 * 5 * 5 * 25
    assert fam["unconverged"]["converged"] is False and fam["unconverged"]["error"] == "rc=1"
    assert fam["partial"]["error"] == "ValueError: the L-domain must defeat canonicalization"
    assert "no_such_family" in fam["crashed"]["error"]
    assert bench_torch.exit_code(result) == 1
    line = json.loads(bench_torch.final_line(result))
    assert line["families"]["unconverged"]["error"] == "rc=1" and line["families"]["extruded"]["converged"]

    skipped = bench_torch.main(args + ["--budget-s", "1"])
    assert all("skipped" in entry for entry in skipped["families"].values())
    assert bench_torch.exit_code(skipped) == 1
    assert bench_torch.exit_code(bench_torch.main(args + ["--no-families"])) == 0
