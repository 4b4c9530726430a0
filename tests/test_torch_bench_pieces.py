"""Port parity, the measurement tools that time pieces: each of
``fea_tpu_torch.bench``'s ``spmv`` and ``microbench`` against its tool in
the JAX package's ``tools/`` at a small shape, on the CPU, ``profile``'s
solve against ``bench.py``'s and the port's own ``solve()``, and
``prewarm``'s run of the benchmark (``tests/test_torch_bench_tools.py``
holds the tools that solve).

The JAX scripts run as child processes, all at once (``--cpu``,
``JAX_PLATFORMS=cpu``); the port's modules in process through
``main(argv)`` with ``--device cpu``, where every kernel wrapper runs its
plain version. Each pair builds the same scene (equal DOF and element
counts); every mode or key of a tool's line has its counterpart in the
port's, but for the keys a module's docstring names as dropped.
"""
import math
import sys

import pytest

import fea_tpu_torch.bench.microbench
import fea_tpu_torch.bench.prewarm
import fea_tpu_torch.bench.profile
import fea_tpu_torch.bench.spmv
from fea_tpu_torch.bench import scenes
from torch_pin import one_torch_thread  # noqa: F401
from torch_tools import CPU, no_kernel_ran, run_all

TOL = 1e-8
SHAPE = ["--nx", "8", "--ny", "8", "--nz", "32"]
# name -> (JAX script, its arguments; the port module takes the same shape)
TOOLS = {
    "spmv": ("tools/spmv_bench.py", SHAPE),
    "microbench": ("tools/t_microbench.py", [*SHAPE, "--k", "4"]),
    # profile's witness: bench.py's staged solve of the same cantilever
    "bench": ("bench.py", [*SHAPE, "--no-families", "--probe-timeout-s", "0", "--skip-numerics-check",
                           "--repeats", "1"]),
}
# microbench's keys of the tool that measure TPU workarounds (its docstring)
MICROBENCH_DROPPED = {"split_combine_ms", "f64_apply_T_ms", "f64_transpose_ms", "f32_transpose_ms",
                      "dd_masked_apply_ms", "dd_raw_apply_ms", "f32_pallas_raw_ms"}


@pytest.fixture(scope="module")
def tools():
    """Each JAX script's run, all at once: name -> (its record, its stderr)."""
    return run_all(TOOLS)


def test_spmv_matches_its_tool(tools):
    ref, _ = tools["spmv"]
    spmv = fea_tpu_torch.bench.spmv
    got = spmv.main([*SHAPE, *CPU])
    assert not got.get("partial"), got.get("error")
    for key in ("n_dof", "n_elements", "stored_n_elements"):
        assert got[key] == ref[key], key
    assert (got["n_dof"], got["stored_n_elements"]) == (8019, 256)
    # every mode of the tool has its port mode (the module's table)
    tool_modes = {k[: -len("_ms")] for k in ref if k.endswith("_ms")}
    assert tool_modes == set(spmv.TOOL_MODES)
    for mode in spmv.TOOL_MODES.values():
        assert got[f"{mode}_ms"] > 0 and got["checks"][mode] <= spmv.CHECK_TOL, mode
    assert got["checks_passed"] and not spmv.failed(got)
    assert got["csr_ms"] > 0 and got["stencil_hbm_gbps_min"] > 0 and no_kernel_ran(got)
    assert spmv.failed(dict(got, checks_passed=False))


def test_microbench_keeps_the_tools_keys(tools):
    ref, _ = tools["microbench"]
    mb = fea_tpu_torch.bench.microbench
    got = mb.main([*TOOLS["microbench"][1], *CPU])
    assert not got.get("partial"), got.get("error")
    assert (got["n_dof"], got["k"]) == (ref["n_dof"], ref["k"]) == (8019, 4)
    assert set(mb.KEYS) == set(ref) - MICROBENCH_DROPPED - {"backend", "n_dof", "k"}
    assert all(math.isfinite(got[k]) and got[k] > 0 for k in mb.KEYS)
    assert not set(got) & MICROBENCH_DROPPED
    assert got["timing"] == "host wall of k calls" and not mb.failed(got) and no_kernel_ran(got)


def test_profile_solve_matches_the_ports_solve(tools, monkeypatch):
    """The JAX tool raises on the CPU at its pair apply (a Pallas kernel
    with no interpret mode there), so ``profile``'s solve is held against
    the JAX package's staged solve of the same cantilever in ``bench.py``
    (the same DOF count, no more iterations, both host true residuals
    <= 1e-8), and against the port's own ``solve()`` of it, the voxel
    route forced at this size (the same iterations)."""
    import fea_tpu_torch

    ref, _ = tools["bench"]
    prof = fea_tpu_torch.bench.profile
    got = prof.main([*SHAPE, "--reps", "2", *CPU])
    assert not got.get("partial"), got.get("error")
    monkeypatch.setattr(sys.modules["fea_tpu_torch.solve"], "_STRUCTURED_MIN_DOF", 0)
    scene, _ = scenes.cantilever((8, 8, 32), device="cpu")
    sol = fea_tpu_torch.solve(scene, tol=1e-8)
    assert got["n_dof"] == scene.n_dof == ref["n_dof"] == 8019
    assert got["fpcg_converged"] and sol.stats.converged and ref["converged"]
    assert sol.route == "fpcg-multigrid"
    assert got["fpcg_iterations"] <= ref["iterations"] and ref["relative_residual"] <= TOL
    assert got["fpcg_iterations"] == sol.stats.iterations
    assert got["fpcg_relative_residual"] <= TOL
    assert got["fpcg_per_iter_ms"] == pytest.approx(got["fpcg_solve_ms"] / got["fpcg_iterations"])
    assert all(math.isfinite(got[f"{p}_ms"]) for p in prof.PIECES)
    assert not prof.failed(got) and no_kernel_ran(got)


def test_prewarm_runs_the_benchmark_and_passes_its_code_on():
    got = fea_tpu_torch.bench.prewarm.main(["--nx", "4", "--ny", "4", "--nz", "16", "--device", "cpu"])
    assert got["rc"] == 0 and "build_s" not in got
    assert got["bench"]["converged"] and got["bench"]["n_dof"] == 1275
