"""Port parity: the staged FCG loop (``fea_tpu_torch/solve/staged.py``).

Here on the CPU the step runs eagerly on the plain kernels: the same step
function a CUDA graph captures on the card. The reference is
``fea_tpu.solve.solve_operator_fpcg_t_staged`` on tests/test_staged.py's
2x2x6 scene (two levels, degree 2: the coarse limit is lowered so that the
hierarchy has a second level), and the port's own Python loop
(``solve_operator_fpcg``). Tolerances: iterations within one of the
reference (the rotated start may move the last step at the edge of tol),
displacements and reactions within 10 tol of their scale.
"""
import copy
import dataclasses
import gc
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fea_tpu as ft
from fea_tpu.ops.structured import build_structured_operator as jax_structured_operator
from fea_tpu.ops.structured import structured_scene as jax_structured_scene
from fea_tpu.ops.transposed import build_multigrid_t
from fea_tpu.solve import solve_operator_fpcg_t_staged

import fea_tpu_torch as ftt
from fea_tpu_torch.ops.multigrid import build_multigrid
from fea_tpu_torch.ops.structured import build_structured_operator
from fea_tpu_torch.solve import solve_operator_fpcg, solve_operator_fpcg_staged
from torch_pin import one_torch_thread  # noqa: F401
from torch_tools import ShiftedRhs

STAGED = sys.modules["fea_tpu_torch.solve.staged"]
MAT = dict(E=1e7, nu=0.3)
TOL = 1e-6


def _reference_case():
    """tests/test_staged.py's scene, loads and prescribed root motion."""
    jsc, dims = jax_structured_scene(2, 2, 6, 0.1, 0.1, 0.5, ft.Material(**MAT), dtype=jnp.float64)
    nodes = np.asarray(jsc.nodes)
    loads = np.zeros_like(nodes)
    tip = nodes[:, 2] == nodes[:, 2].max()
    loads[tip, 1] = 10.0 / tip.sum()
    presc = np.zeros_like(nodes)
    presc[nodes[:, 2] == 0.0, 1] = 1e-5
    return nodes, np.asarray(jsc.elements), np.asarray(jsc.fixed), loads, presc, dims


def _port(nodes, elements, fixed, loads, dims, **mg_kw):
    sc = ftt.make_scene(nodes, elements, fixed, loads, ftt.Material(**MAT), dtype=torch.float64, device="cpu")
    op = build_structured_operator(sc, dims, dtype=torch.float64)
    mg = build_multigrid(op.astype(torch.float32), dtype=torch.float32, free_np=1.0 - fixed.astype(np.float64),
                         **mg_kw)
    return sc, op, mg


@pytest.fixture(scope="module")
def reference():
    nodes, elements, fixed, loads, presc, dims = _reference_case()
    jsc = ft.make_scene(nodes, elements, fixed, loads, ft.Material(**MAT), dtype=jnp.float64)
    jop = jax_structured_operator(jsc, dims, dtype=jnp.float64)
    mg_t = build_multigrid_t(jop.astype(jnp.float32), dtype=jnp.float32, use_pallas=False,
                             free_np=1.0 - fixed.astype(np.float64), max_levels=2, degree=2, coarse_dof_limit=100)
    want = {
        "loads": solve_operator_fpcg_t_staged(jop, jsc.loads, None, mg_t, tol=TOL, use_pallas=False),
        "prescribed": solve_operator_fpcg_t_staged(jop, jsc.loads, jnp.asarray(presc), mg_t, tol=TOL,
                                                   use_pallas=False),
    }
    return nodes, elements, fixed, loads, presc, dims, want


@pytest.mark.parametrize("case", ["loads", "prescribed"])
def test_staged_matches_jax_staged(reference, case):
    nodes, elements, fixed, loads, presc, dims, want = reference
    sc, op, mg = _port(nodes, elements, fixed, loads, dims, max_levels=2, degree=2, coarse_dof_limit=100)
    assert len(mg.levels) == 2
    p = torch.as_tensor(presc) if case == "prescribed" else None
    got = solve_operator_fpcg_staged(op, sc.loads, p, mg, tol=TOL)
    ref = want[case]
    assert got.stats.converged
    assert got.stats.iterations <= int(ref.stats.iterations) + 1
    for mine, theirs in ((got.displacements, ref.displacements), (got.reactions, ref.reactions)):
        theirs = np.asarray(theirs)
        assert np.max(np.abs(mine.numpy() - theirs)) <= 10 * TOL * np.max(np.abs(theirs))
    if p is not None:
        mask = fixed.astype(bool)
        assert np.array_equal(got.displacements.numpy()[mask], presc[mask])


@pytest.fixture(scope="module")
def slender():
    """A 4x4x32 cantilever over a three-level hierarchy: enough iterations
    for the loop's bookkeeping to matter."""
    nodes, elements = ftt.mesh.box_hex_mesh(4, 4, 32, 0.05, 0.05, 1.0)
    fixed = ftt.fix_where(nodes, lambda q: q[:, 2] == 0.0, 3)
    loads = np.zeros_like(nodes)
    loads[nodes[:, 2] == 1.0, 1] = 1.0
    sc, op, mg = _port(nodes, elements, fixed, loads, (4, 4, 32), coarse_dof_limit=300)
    assert len(mg.levels) >= 3
    return sc, op, mg


def _counts_zeroed():
    for key in STAGED.COUNTS:
        STAGED.COUNTS[key] = 0
    return STAGED.COUNTS


def test_a_second_solve_replays_the_plan_and_matches_the_python_loop(slender):
    """A second solve on one (op, mg) takes the first one's plan, restarts
    every static buffer, and gives the same bits; both agree with the
    Python loop."""
    sc, op, mg = slender
    presc = sc.prescribed_or_zero(torch.float64)
    runs, plans = [], []
    for _ in range(2):
        counts = _counts_zeroed()
        runs.append(solve_operator_fpcg_staged(op, sc.loads, presc, mg, tol=1e-8))
        plans.append(STAGED._PLANS[id(mg)])
        # the CPU reads every round at once: no step runs past a halt
        assert counts["past"] == 0 and counts["steps"] == counts["live"] == runs[-1].stats.iterations
    a, b = runs
    assert plans[0] is plans[1]
    assert a.stats == b.stats
    assert torch.equal(a.displacements, b.displacements) and torch.equal(a.reactions, b.reactions)
    loop = solve_operator_fpcg(op, sc.loads, presc, mg, tol=1e-8)
    assert abs(a.stats.iterations - loop.stats.iterations) <= 1
    u = loop.displacements
    assert float((a.displacements - u).abs().max()) <= 10 * 1e-8 * float(u.abs().max())
    assert a.stats.converged and a.stats.relative_residual <= 1e-8


def test_a_hierarchy_keeps_one_plan_and_drops_it_when_it_goes(slender):
    sc, op, mg = slender
    mine = copy.copy(mg)  # a hierarchy of its own, over the same levels
    key = id(mine)
    solve_operator_fpcg_staged(op, sc.loads, None, mine, tol=1e-6)
    first = STAGED._PLANS[key]
    assert first.op is op and len(first.cases) == 1
    other = dataclasses.replace(op)  # another operator object: the plan is made anew
    solve_operator_fpcg_staged(other, sc.loads, None, mine, tol=1e-6)
    assert STAGED._PLANS[key] is not first and STAGED._PLANS[key].op is other
    del mine
    gc.collect()
    assert key not in STAGED._PLANS


def test_impossible_tol_is_reported_not_converged(slender):
    sc, op, mg = slender
    got = solve_operator_fpcg_staged(op, sc.loads, None, mg, tol=1e-30, max_iters=2)
    assert not got.stats.converged
    assert 2 <= got.stats.iterations <= 4  # tests/test_staged.py's bound
    assert torch.isfinite(got.displacements).all()


def test_zero_rhs_takes_no_iteration(slender):
    sc, op, mg = slender
    got = solve_operator_fpcg_staged(op, torch.zeros_like(sc.loads), None, mg, tol=1e-9)
    assert got.stats.converged and got.stats.iterations == 0
    assert float(got.displacements.abs().max()) == 0.0


def test_max_iters_is_exact(slender):
    sc, op, mg = slender
    counts = _counts_zeroed()
    got = solve_operator_fpcg_staged(op, sc.loads, None, mg, tol=1e-30, max_iters=5)
    assert got.stats.iterations == 5 and not got.stats.converged
    assert counts["live"] == 5


def test_a_first_pass_just_above_tol_is_certified_by_its_correction(slender):
    """A case whose first pass lands at about 3 tol (true) is certified by
    one correction pass: the correction's displacement is read after its
    pass has run and takes the true residual down by the tenth the pass is
    asked for. The reported residual is the true one, recomputed here from
    u by the element-by-element operator (K7, not the stencil the solve
    used)."""
    sc, op, mg = slender
    tol = 1e-8
    b = op.rhs(sc.loads, torch.zeros_like(sc.loads))
    v = op.free * torch.as_tensor(np.random.default_rng(3).standard_normal(tuple(b.shape)))
    shifted = ShiftedRhs(op, 3 * tol * float(b.norm()) / float(v.norm()) * v)
    utils = sys.modules["fea_tpu_torch.utils"]
    utils.reset()
    got = solve_operator_fpcg_staged(shifted, sc.loads, None, mg, tol=tol)
    counts = utils.counters()
    assert got.stats.converged and got.stats.relative_residual <= tol
    assert counts["certify.passes"] == 1
    assert "certify.stalled" not in counts and "certify.uncertified" not in counts
    k = ftt.build_operator(sc, dtype=torch.float64)
    true = float((op.free * (sc.loads - k.apply_raw(got.displacements))).norm()) / float(b.norm())
    assert true <= tol and abs(true - got.stats.relative_residual) <= 1e-3 * tol


def test_sharded_vectors_are_refused(slender):
    """The sharded solve keeps the Python loop: a capture of its shard
    vectors is never attempted."""
    from fea_tpu_torch.parallel import build_zsharded_solver

    sc, op, mg = slender
    solver = build_zsharded_solver(op, mg, ["cpu"] * 2)
    with pytest.raises(TypeError, match="sharded solve runs solve_operator_fpcg"):
        solve_operator_fpcg_staged(solver.op, solver.scatter(sc.loads), None, solver.precondition)


def test_a_sharded_solve_certifies_through_a_correction_pass(slender):
    """The z-sharded solve certifies its Shards through the same
    ``refine_true``: a rhs shifted by 3 tol forces a correction pass, which
    adds into u shard by shard, and the true residual recomputed from the
    gathered u by the element-by-element operator meets tol."""
    from fea_tpu_torch.parallel import build_zsharded_solver

    sc, op, mg = slender
    tol = 1e-8
    solver = build_zsharded_solver(op, mg, ["cpu"] * 2)
    b = op.rhs(sc.loads, torch.zeros_like(sc.loads))
    v = op.free * torch.as_tensor(np.random.default_rng(3).standard_normal(tuple(b.shape)))
    solver.op = ShiftedRhs(solver.op, solver.scatter(3 * tol * float(b.norm()) / float(v.norm()) * v))
    utils = sys.modules["fea_tpu_torch.utils"]
    utils.reset()
    got = solver.solve(sc.loads, tol=tol)
    counts = utils.counters()
    assert got.stats.converged and got.stats.relative_residual <= tol
    assert counts["certify.passes"] >= 1 and "certify.uncertified" not in counts
    k = ftt.build_operator(sc, dtype=torch.float64)
    true = float((op.free * (sc.loads - k.apply_raw(got.displacements))).norm()) / float(b.norm())
    assert true <= tol and abs(true - got.stats.relative_residual) <= 1e-3 * tol


@pytest.fixture
def large_routes_for_small_scenes(monkeypatch):
    monkeypatch.setattr(sys.modules["fea_tpu_torch.solve"], "_STRUCTURED_MIN_DOF", 0)


@pytest.mark.parametrize("route", ["voxel", "curvilinear"])
def test_solve_runs_the_staged_loop(route, large_routes_for_small_scenes, monkeypatch):
    nodes, elements = ftt.mesh.box_hex_mesh(4, 4, 16, 0.1, 0.1, 0.4)
    if route == "curvilinear":
        interior = (nodes[:, 2] > 0) & (nodes[:, 2] < 0.4)
        nodes = nodes + 0.25 * 0.025 * np.random.default_rng(2).uniform(-1, 1, nodes.shape) * interior[:, None]
    fixed = ftt.fix_where(nodes, lambda q: np.isclose(q[:, 2], 0.0), 3)
    loads = np.zeros_like(nodes)
    loads[np.isclose(nodes[:, 2], 0.4), 1] = 1.0
    sc = ftt.make_scene(nodes, elements, fixed, loads, ftt.Material(**MAT), dtype=torch.float64, device="cpu")
    calls = []
    staged_solve = STAGED.solve_operator_fpcg_staged
    monkeypatch.setattr(STAGED, "solve_operator_fpcg_staged",
                        lambda *a, **kw: calls.append(1) or staged_solve(*a, **kw))
    monkeypatch.setattr(sys.modules["fea_tpu_torch.solve"], "solve_operator_fpcg",
                        lambda *a, **kw: pytest.fail("the Python loop was taken"))
    sol = ftt.solve(sc, tol=1e-8)
    assert calls == [1]
    assert sol.stats.converged and sol.stats.relative_residual <= 1e-8
