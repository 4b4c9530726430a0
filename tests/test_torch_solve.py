"""Port parity, the whole slice: ``fea_tpu_torch.solve`` against
``fea_tpu.solve`` on the voxel route, the routes of other scenes, and
what the port does not take yet.

The scene is the slender cantilever of tests/test_refine.py at 8x8x64
(15,795 DOF): large enough for a two-level V-cycle (4x4x8 at 2,475 DOF
would be only the dense coarse solve), with ``_STRUCTURED_MIN_DOF``
lowered to 0 in both packages so that both take the voxel route. Both
run here on the CPU; the port's stencil takes its plain torch version.
Convergence is judged by a true residual recomputed in NumPy f64, never
by a solver's recurrence (its f64 recurrence drifts from the true
residual by ~eps * kappa).
"""
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fea_tpu as ft
from fea_tpu.ops.structured import stencil_apply_np

import fea_tpu_torch as ftt
from fea_tpu_torch.elements.hex8 import stiffness_matrix_np
from torch_pin import one_torch_thread  # noqa: F401

DIMS = (8, 8, 64)
TOL = 1e-8


@pytest.fixture
def voxel_route_for_small_scenes(monkeypatch):
    # sys.modules, not `import fea_tpu.solve`: each package re-exports
    # the function under the module's name
    monkeypatch.setattr(sys.modules["fea_tpu.solve"], "_STRUCTURED_MIN_DOF", 0)
    monkeypatch.setattr(sys.modules["fea_tpu_torch.solve"], "_STRUCTURED_MIN_DOF", 0)


def _cantilever(prescribed: bool):
    nodes, elements = ft.mesh.box_hex_mesh(*DIMS, 0.05, 0.05, 1.0)
    fixed = ft.fix_where(nodes, lambda p: p[:, 2] == 0.0, 3)
    loads = np.zeros_like(nodes)
    tip = nodes[:, 2] == 1.0
    loads[tip, 1] = 100.0 / tip.sum()
    presc = None
    if prescribed:
        # a root displacement field on the fixed face, of the tip's order
        presc = np.where(fixed, 1e-6 * np.random.default_rng(3).normal(size=nodes.shape), 0.0)
    return nodes, elements, fixed, loads, presc


def _true_rel_residual(ke, fixed, loads, presc, u):
    """||F (loads - K u)|| / ||b|| in NumPy f64, b the masked rhs."""
    Z, Y, X = DIMS[2] + 1, DIMS[1] + 1, DIMS[0] + 1
    F = 1.0 - fixed.astype(np.float64)
    xp = (1.0 - F) * (0.0 if presc is None else presc)
    K = lambda v: stencil_apply_np(ke, v.reshape(Z, Y, X, 3), DIMS).reshape(-1, 3)  # noqa: E731
    b = F * (loads - K(xp)) + xp
    return np.linalg.norm(F * (loads - K(u))) / np.linalg.norm(b)


@pytest.mark.parametrize("prescribed", [False, True], ids=["loads", "prescribed"])
def test_voxel_solve_matches_jax(prescribed, voxel_route_for_small_scenes):
    nodes, elements, fixed, loads, presc = _cantilever(prescribed)
    mat = dict(E=10_000_000 * ft.units.psi, nu=0.3)
    jsc = ft.make_scene(nodes, elements, fixed, loads, ft.Material(**mat), prescribed=presc, dtype=jnp.float64)
    tsc = ftt.make_scene(nodes, elements, fixed, loads, ftt.Material(**mat), prescribed=presc, dtype=torch.float64,
                         device="cpu")
    ref = ft.solve(jsc, tol=TOL)
    sol = ftt.solve(tsc, tol=TOL)

    u_ref = np.asarray(ref.displacements)
    u = sol.displacements.numpy()
    assert sol.stats.converged
    # same algorithm and hierarchy; f32 summation order in the V-cycle
    # may cost one iteration at the edge of the tolerance
    assert sol.stats.iterations <= int(ref.stats.iterations) + 1
    ke = stiffness_matrix_np(nodes[elements[0]], ftt.Material(**mat))
    rel = _true_rel_residual(ke, fixed, loads, presc, u)
    assert rel <= TOL
    # the port reports the same true residual: two f64 recomputes at a
    # ~1e-8 cancellation, whose rounding is ~1e-4 of the residual
    assert sol.stats.relative_residual == pytest.approx(rel, rel=1e-3)
    if presc is not None:
        assert np.array_equal(u[fixed], presc[fixed])
    # both meet tol in the true residual: displacements and reactions
    # agree to the level of tol
    assert np.max(np.abs(u - u_ref)) <= 10 * TOL * np.max(np.abs(u_ref))
    r_ref = np.asarray(ref.reactions)
    assert np.max(np.abs(sol.reactions.numpy() - r_ref)) <= 10 * TOL * np.max(np.abs(r_ref))


def test_routes_not_ported_raise_with_their_name():
    mat = ftt.Material(E=1e7, nu=0.3)
    nodes, elements = ftt.mesh.box_hex_mesh(4, 4, 8, 0.1, 0.1, 0.5)
    fixed = ftt.fix_where(nodes, lambda p: p[:, 2] == 0.0, 3)
    box = ftt.make_scene(nodes, elements, fixed, np.ones_like(nodes), mat, dtype=torch.float64, device="cpu")
    assert box.n_dof < 2000
    # one device, so sharded=True takes the one-device voxel route
    assert ftt.solve(box, config=ftt.SolverConfig(sharded=True)).stats.converged
    # the sanitizer is ported: a clean solve under it gives the same answer
    plain, checked = ftt.solve(box), ftt.solve(box, debug_nans=True)
    assert checked.stats == plain.stats
    assert torch.equal(checked.displacements, plain.displacements)
    with pytest.raises(ValueError, match="on_nonconverged"):
        ftt.solve(box, on_nonconverged="sometimes")
    # the element-by-element routes (item 8) are ported: they solve
    assert ftt.solve(box).stats.converged
    assert ftt.solve(box, method="cg").stats.converged


def test_large_non_voxel_scene_raises(voxel_route_for_small_scenes, monkeypatch):
    """A large tube takes the extruded route (it raised while the route
    was not ported, hence the name) and meets tol in the true residual of
    the oracle's K."""
    from oracle import assemble_sparse

    monkeypatch.setattr(sys.modules["fea_tpu_torch.solve.cache"], "_BUILD_CACHE", {})
    mat = ftt.Material(E=1e7, nu=0.3)
    n2, q = ftt.mesh.annulus_section(26, 0.099, 0.1016)
    nodes, elements = ftt.mesh.extrude_quads(n2, q, np.linspace(0.0, 1.0, 50))
    fixed = ftt.fix_where(nodes, lambda p: p[:, 2] == 0.0, 3)
    loads = np.ones_like(nodes)
    tube = ftt.make_scene(nodes, elements, fixed, loads, mat, dtype=torch.float64, device="cpu")
    solve_mod = sys.modules["fea_tpu_torch.solve"]
    taken = []
    real = solve_mod.solve_extruded
    monkeypatch.setattr(solve_mod, "solve_extruded", lambda *a, **kw: taken.append(1) or real(*a, **kw))
    sol = ftt.solve(tube, tol=TOL)
    assert taken == [1] and sol.stats.converged
    K = assemble_sparse(nodes, elements, 1e7, 0.3)
    F = 1.0 - fixed.astype(np.float64)
    u = sol.displacements.numpy()
    r = F * (loads - (K @ u.reshape(-1)).reshape(u.shape))
    assert np.linalg.norm(r) <= TOL * np.linalg.norm(F * loads)


def test_nonconverged_solve_is_never_silent(voxel_route_for_small_scenes):
    nodes, elements = ftt.mesh.box_hex_mesh(4, 4, 8, 0.1, 0.1, 0.5)
    fixed = ftt.fix_where(nodes, lambda p: p[:, 2] == 0.0, 3)
    box = ftt.make_scene(nodes, elements, fixed, np.ones_like(nodes), ftt.Material(E=1e7, nu=0.3),
                         dtype=torch.float64, device="cpu")
    with pytest.raises(RuntimeError, match="did not converge"):
        ftt.solve(box, max_iters=0, on_nonconverged="raise")
    with pytest.warns(RuntimeWarning, match="did not converge"):
        sol = ftt.solve(box, max_iters=0)
    assert not sol.stats.converged and sol.stats.iterations == 0


def test_cuda_device_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    nodes, elements = ftt.mesh.box_hex_mesh(1, 1, 1, 1.0, 1.0, 1.0)
    box = ftt.make_scene(nodes, elements, np.zeros_like(nodes), np.zeros_like(nodes),
                         ftt.Material(E=1e7, nu=0.3), dtype=torch.float64, device="cpu")
    with pytest.raises((AssertionError, RuntimeError)):
        ftt.solve(box, device="cuda")


def test_small_unrouted_hex8_scene_under_sharded_takes_the_dense_route():
    """A hex8 scene under 50k DOF that no grid route takes (a box with its
    last element removed) falls through to the dense/CG tail under
    ``sharded=True`` too, as in the reference, instead of raising."""
    nodes, elements = ftt.mesh.box_hex_mesh(3, 3, 4, 0.1, 0.1, 0.4)
    elements = elements[:-1]
    fixed = ftt.fix_where(nodes, lambda p: p[:, 2] == 0.0, 3)
    orphan = np.setdiff1d(np.arange(nodes.shape[0]), elements.ravel())
    fixed[orphan] = True
    loads = np.zeros_like(nodes)
    loads[nodes[:, 2] == 0.4, 1] = 1.0
    loads[orphan] = 0.0
    sc = ftt.make_scene(nodes, elements, fixed, loads, ftt.Material(E=1e7, nu=0.3), dtype=torch.float64,
                        device="cpu")
    assert sc.n_dof == 240
    one = ftt.solve(sc)
    sharded = ftt.solve(sc, config=ftt.SolverConfig(sharded=True))
    assert one.stats.converged and sharded.stats.converged
    assert sharded.stats.iterations == one.stats.iterations
    u = one.displacements.numpy()
    assert np.max(np.abs(sharded.displacements.numpy() - u)) <= 1e-12 * np.max(np.abs(u))


def test_top_level_exports_match_the_reference():
    assert ftt.solve_operator_fpcg is sys.modules["fea_tpu_torch.solve"].solve_operator_fpcg
    assert "solve_operator_fpcg" in ftt.__all__
    assert callable(ftt.solve_many) and "solve_many" in ftt.__all__
    for name in ("solve_operator_fpcg", "solve_many"):
        assert hasattr(ft, name)
