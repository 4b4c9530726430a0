"""The NaN sanitizer, ``solve(debug_nans=True)``: the counterpart of
tests/test_guards.py's debug_nans cases. A clean solve under it gives the
same answer as without it, bit for bit (the sanitizer only reads); a NaN
load raises ``FloatingPointError`` at the first operation that makes a
NaN, where the same scene without the flag returns converged False.
"""
import sys

import numpy as np
import pytest
import torch

import fea_tpu_torch as ftt
from fea_tpu_torch import sanitize
from torch_pin import one_torch_thread  # noqa: F401


def small_case(nx=2, ny=2, nz=6, lz=0.6):
    mat = ftt.Material(E=1e7, nu=0.3)
    nodes, elements = ftt.mesh.box_hex_mesh(nx, ny, nz, 0.1, 0.1, lz)
    fixed = ftt.fix_where(nodes, lambda p: p[:, 2] == 0.0, 3)
    loads = np.zeros_like(nodes)
    loads[nodes[:, 2] == nodes[:, 2].max(), 1] = 1.0
    return nodes, elements, fixed, loads, mat


def _scene(nodes, elements, fixed, loads, mat):
    return ftt.make_scene(nodes, elements, fixed, loads, mat, dtype=torch.float64, device="cpu")


@pytest.mark.parametrize("how", ["flag", "config"])
def test_clean_cg_solve_is_unchanged_under_the_sanitizer(how):
    scene = _scene(*small_case())
    plain = ftt.solve(scene, method="cg", tol=1e-8, max_iters=2000)
    if how == "flag":
        checked = ftt.solve(scene, method="cg", tol=1e-8, max_iters=2000, debug_nans=True)
    else:
        checked = ftt.solve(scene, config=ftt.SolverConfig(debug_nans=True, method="cg", tol=1e-8), max_iters=2000)
    assert checked.stats.converged and checked.stats == plain.stats
    assert torch.equal(checked.displacements, plain.displacements)
    assert torch.equal(checked.reactions, plain.reactions)
    assert not sanitize.active()


def test_voxel_route_at_53k_dof_is_unchanged_under_the_sanitizer():
    """The large voxel route (structured operator, multigrid, the staged
    FCG loop, certification) makes no NaN anywhere; under the sanitizer
    the staged loop runs its eager step and keeps no plan."""
    nodes, elements, fixed, loads, mat = small_case(12, 12, 104, lz=0.8)
    scene = _scene(nodes, elements, fixed, loads, mat)
    assert scene.n_dof >= 50_000
    plain = ftt.solve(scene, tol=1e-8)
    staged = sys.modules["fea_tpu_torch.solve.staged"]
    plans = dict(staged._PLANS)
    ftt.clear_build_cache()  # so that the builds run under the sanitizer too
    checked = ftt.solve(scene, tol=1e-8, debug_nans=True)
    assert staged._PLANS.keys() <= plans.keys()
    assert checked.stats.converged and checked.stats == plain.stats
    assert torch.equal(checked.displacements, plain.displacements)


def test_nan_load_raises_at_its_source_and_without_the_flag_does_not_converge():
    nodes, elements, fixed, loads, mat = small_case()
    loads = loads.copy()
    loads[0, 0] = np.nan
    bad = _scene(nodes, elements, fixed, loads, mat)
    with pytest.raises(FloatingPointError, match="nan"):
        ftt.solve(bad, method="cg", tol=1e-8, max_iters=50, debug_nans=True, on_nonconverged="ignore")
    assert not sanitize.active()  # scoped: off again after the raise
    sol = ftt.solve(bad, method="cg", tol=1e-8, max_iters=50, on_nonconverged="ignore")
    assert not sol.stats.converged


def test_what_the_sanitizer_checks():
    """Outputs of every operation, infs passing; never views, nor memory
    nothing has written yet."""
    x = torch.tensor([1.0, 0.0, -1.0], dtype=torch.float64)
    with sanitize.debug_nans():
        assert sanitize.active()
        assert torch.isinf(x[::2] / 0.0).all()  # inf passes, 0/0 is caught below
        torch.empty(1000, dtype=torch.float32)
        torch.empty_like(x)[:2]
        with pytest.raises(FloatingPointError, match="aten.div"):
            x / x
        with pytest.raises(FloatingPointError, match="aten.sqrt"):
            torch.sqrt(x)
        with pytest.raises(FloatingPointError, match="kernel_name"):
            sanitize.check("kernel_name", torch.tensor([float("nan")]))
        sanitize.check("ints", torch.tensor([1, 2]))
    assert not sanitize.active()
    torch.sqrt(x)  # off: NaN is an ordinary value again
