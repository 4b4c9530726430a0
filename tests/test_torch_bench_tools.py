"""Port parity, the measurement tools that solve: each of
``fea_tpu_torch.bench``'s ``many``, ``unstructured`` and ``scipy_compare``
against its tool in the JAX package's ``tools/`` at a small shape, on the
CPU, and every tool module's refusal to run without a card
(``tests/test_torch_bench_pieces.py`` holds ``spmv``, ``microbench``,
``profile`` and ``prewarm``).

The tools run as child processes, all at once (``--cpu``,
``JAX_PLATFORMS=cpu``); the port's modules in process through
``main(argv)`` with ``--device cpu``, where every kernel wrapper runs its
plain version. Each pair builds the same scene (equal DOF, element and
aggregate counts); the port's solves converge with a true residual at
most 1e-8 recomputed on the host in NumPy f64 and take no more iterations
than the tool's; every key of a tool's line is in the port's, but for the
keys a module's docstring names as dropped or renamed.
"""
import importlib
import json
import re

import pytest

import fea_tpu_torch.bench.many
import fea_tpu_torch.bench.scipy_compare
import fea_tpu_torch.bench.unstructured
from torch_pin import one_torch_thread  # noqa: F401
from torch_tools import CPU, no_kernel_ran, run_all

TOL = 1e-8
# name -> (JAX tool, shape arguments of both)
TOOLS = {
    "many": ("tools/many_bench.py", ["--nx", "4", "--ny", "4", "--nz", "40", "--cases", "3"]),
    "unstructured": ("tools/unstructured_bench.py", ["--nx", "6", "--ny", "6", "--nz", "24", "--repeats", "1"]),
    "scipy_compare": ("tools/scipy_compare.py", ["--nx", "4", "--ny", "4", "--nz", "40"]),
}


@pytest.fixture(scope="module")
def tools():
    """Each tool's run, all at once: name -> (its record, its stderr)."""
    return run_all(TOOLS)


def test_many_matches_its_tool(tools):
    ref, ref_err = tools["many"]
    # the tool prints its iterations on stderr only
    ref_iters = json.loads(re.search(r"iterations (\[[\d, ]+\])", ref_err).group(1))
    got = fea_tpu_torch.bench.many.main([*TOOLS["many"][1], *CPU])
    assert not got.get("partial"), got.get("error")
    assert (got["n_dof"], got["cases"]) == (ref["n_dof"], ref["cases"]) == (3075, 3)
    assert got["converged"] and ref["converged"]
    assert len(got["relative_residuals"]) == 3 and max(got["relative_residuals"]) == got["worst_relative_residual"]
    assert got["worst_relative_residual"] <= TOL
    assert all(g <= r for g, r in zip(got["iterations"], ref_iters, strict=True))
    assert got["case0_vs_single_rel"] <= 1e-6
    assert no_kernel_ran(got) and got["batch_launches"] == {"f32": 0, "f64": 0}
    assert set(ref) <= set(got)


def test_unstructured_matches_its_tool(tools):
    ref, _ = tools["unstructured"]
    got = fea_tpu_torch.bench.unstructured.main([*TOOLS["unstructured"][1], *CPU])
    assert not got.get("partial"), got.get("error")
    assert (got["n_dof"], got["n_elements"], got["n_aggregates"]) == (ref["n_dof"], ref["n_elements"],
                                                                       ref["n_aggregates"]) == (3675, 864, 447)
    assert got["operator_kind"] == "hex8_matfree"
    assert got["converged"] and ref["converged"]
    assert got["iterations"] <= ref["iterations"]
    assert got["relative_residual"] <= TOL
    assert got["backend"] == "cpu" and no_kernel_ran(got)
    assert set(ref) <= set(got)


def test_scipy_compare_matches_its_tool(tools):
    ref, _ = tools["scipy_compare"]
    got = fea_tpu_torch.bench.scipy_compare.main([*TOOLS["scipy_compare"][1], "--device", "cpu"])
    assert got["n_dof"] == ref["n_dof"] == 3075
    assert got["displacement_rel_diff"] <= 1e-8 and ref["displacement_rel_diff"] <= 1e-8
    # under 50,000 DOF solve() takes Jacobi PCG in both packages
    assert got["route"] == "cg" and got["converged"] and got["launches"] == {"f32": 0, "f64": 0}
    assert got["relative_residual"] <= 1e-10 and got["scipy_relative_residual"] <= 1e-10
    assert got["scipy_total_s"] == pytest.approx(got["scipy_assembly_s"] + got["scipy_spsolve_s"])
    assert set(ref) <= set(got)


MODULES = ("many", "unstructured", "scipy_compare", "spmv", "microbench", "profile", "prewarm")


@pytest.mark.parametrize("name", MODULES)
def test_tool_without_a_card_raises(name, monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    module = importlib.import_module(f"fea_tpu_torch.bench.{name}")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        module.main(["--nx", "2", "--ny", "2", "--nz", "4"])
