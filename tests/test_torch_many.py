"""Port parity: ``fea_tpu_torch.solve_many`` against ``fea_tpu.solve_many``
and single solves (the cases of tests/test_solve_many.py), and the build
cache of the curvilinear and canonicalized routes (``solve/cache.py``).

Tolerances: a batch case and a single solve of it both meet tol in the
true residual, so they agree to 1e-7 of the displacements' scale at tol
1e-10; against the JAX batch, 10 tol of scale.
"""
import dataclasses
import gc
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fea_tpu as ft

import fea_tpu_torch as ftt
from test_torch_curvilinear import distorted
from torch_pin import one_torch_thread  # noqa: F401

CACHE = sys.modules["fea_tpu_torch.solve.cache"]
CURV = sys.modules["fea_tpu_torch.solve.curv"]
MAT = dict(E=1e7, nu=0.3)
TOL = 1e-10


def _batch_loads(nodes, k, seed=0):
    rng = np.random.default_rng(seed)
    tip = nodes[:, 2] == nodes[:, 2].max()
    loads = np.zeros((k, nodes.shape[0], 3))
    for i in range(k):
        loads[i, tip, 1] = rng.uniform(0.5, 2.0)
        loads[i, tip, 0] = rng.uniform(-1.0, 1.0)
    return loads


def _scene(nodes, elements, fixed, loads, prescribed=None):
    return ftt.make_scene(nodes, elements, fixed, loads, ftt.Material(**MAT), prescribed=prescribed,
                          dtype=torch.float64, device="cpu")


def _box(nx, ny, nz, lz):
    nodes, elements = ftt.mesh.box_hex_mesh(nx, ny, nz, 0.1, 0.1, lz)
    return nodes, elements, ftt.fix_where(nodes, lambda q: q[:, 2] == 0.0, 3)


def _close(a, b, rel):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) <= rel * np.max(np.abs(b))


def test_voxel_batch_matches_jax_and_single_solves():
    nodes, elements, fixed = _box(4, 4, 16, 0.4)
    loads = _batch_loads(nodes, 4)
    sol = ftt.solve_many(_scene(nodes, elements, fixed, np.zeros_like(nodes)), loads, tol=TOL)
    assert sol.displacements.shape == sol.reactions.shape == (4, nodes.shape[0], 3)
    assert sol.stats.iterations.shape == sol.stats.converged.shape == (4,)
    assert sol.stats.converged.all() and (sol.stats.relative_residual <= TOL).all()
    jsc = ft.make_scene(nodes, elements, fixed, np.zeros_like(nodes), ft.Material(**MAT), dtype=jnp.float64)
    ref = ft.solve_many(jsc, loads, tol=TOL)
    for i in range(4):
        assert _close(sol.displacements[i], ref.displacements[i], 10 * TOL)
        single = ftt.solve(_scene(nodes, elements, fixed, loads[i]), tol=TOL)
        assert _close(sol.displacements[i], single.displacements, 1e-7)
        # the reactions balance the case's load
        root = nodes[:, 2] == 0.0
        ly = loads[i, :, 1].sum()
        assert abs(sol.reactions[i].numpy()[root, 1].sum() + ly) < 1e-8 * max(abs(ly), 1.0)


def test_curvilinear_batch_matches_single_solves():
    nodes, elements, fixed, _ = distorted(4, 4, 16, seed=2)
    loads = _batch_loads(nodes, 3)
    sol = ftt.solve_many(_scene(nodes, elements, fixed, np.zeros_like(nodes)), loads, tol=TOL)
    assert sol.stats.converged.all()
    for i in (0, 2):
        ref = ftt.solve(_scene(nodes, elements, fixed, loads[i]), method="dense")
        assert _close(sol.displacements[i], ref.displacements, 1e-7)


def test_prescribed_batch_runs_through_the_same_loop():
    nodes, elements, fixed = _box(3, 3, 12, 0.4)
    loads = _batch_loads(nodes, 2, seed=5)
    presc = np.zeros_like(loads)
    root = nodes[:, 2] == 0.0
    presc[0, root, 1] = 1e-5
    presc[1, root, 0] = -2e-5
    sol = ftt.solve_many(_scene(nodes, elements, fixed, np.zeros_like(nodes)), loads, tol=TOL,
                         prescribed_batch=presc)
    assert sol.stats.converged.all()
    for i in range(2):
        u = sol.displacements[i].numpy()
        assert np.array_equal(u[fixed], presc[i][fixed])
        ref = ftt.solve(_scene(nodes, elements, fixed, loads[i], presc[i]), method="dense")
        assert _close(u, ref.displacements, 1e-7)


def test_bad_shapes_raise():
    nodes, elements, fixed = _box(2, 2, 4, 0.2)
    scene = _scene(nodes, elements, fixed, np.zeros_like(nodes))
    with pytest.raises(ValueError, match="loads_batch"):
        ftt.solve_many(scene, np.zeros((2, 5, 3)))
    with pytest.raises(ValueError, match="loads_batch"):
        ftt.solve_many(scene, np.zeros((nodes.shape[0], 3)))
    with pytest.raises(ValueError, match="prescribed_batch"):
        ftt.solve_many(scene, np.zeros((2, nodes.shape[0], 3)), prescribed_batch=np.zeros((1, nodes.shape[0], 3)))
    with pytest.raises(ValueError, match="on_nonconverged"):
        ftt.solve_many(scene, np.zeros((2, nodes.shape[0], 3)), on_nonconverged="sometimes")


def test_nonconvergence_warns_raises_or_is_ignored():
    nodes, elements, fixed = _box(3, 3, 9, 0.3)
    scene = _scene(nodes, elements, fixed, np.zeros_like(nodes))
    loads = _batch_loads(nodes, 2)
    with pytest.warns(RuntimeWarning, match=r"2/2 case\(s\) did not converge \(indices \[0, 1\]"):
        sol = ftt.solve_many(scene, loads, tol=1e-30, max_iters=2)
    assert not sol.stats.converged.any() and (sol.stats.iterations == 2).all()
    with pytest.raises(RuntimeError, match="did not converge"):
        ftt.solve_many(scene, loads, tol=1e-30, max_iters=2, on_nonconverged="raise")
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        ftt.solve_many(scene, loads, tol=1e-30, max_iters=2, on_nonconverged="ignore")


def _tube():
    n2, q = ftt.mesh.annulus_section(26, 0.099, 0.1016)
    return ftt.mesh.extrude_quads(n2, q, np.linspace(0.0, 1.0, 50))


def _l_shape():
    return ftt.mesh.l_hex_mesh(6, 4, 12, 0.1, 0.1, 0.4)


def _broken_box():
    nodes, elements = ftt.mesh.box_hex_mesh(3, 3, 8, 0.1, 0.1, 0.3)
    elements = elements.copy()
    elements[[0, 1]] = elements[[1, 0]]  # the element order of no grid route
    return nodes, elements


def test_extruded_mesh_raises_item_12(monkeypatch):
    """solve_many takes the extruded route on a tube (it raised while the
    route was not ported, hence the name), from the build solve() caches:
    one build for the batch and the single solves, every case within tol
    in the true residual of the oracle's K and within 1e-7 of scale of
    its single solve. At tol 1e-8: the true f64 residual of this thin tube
    floors at ~2e-10 (JAX's ``solve_extruded(krylov="f64")`` at tol 1e-10
    reports 8.8e-13 by its recurrence and 2.2e-10 by the oracle)."""
    from oracle import assemble_sparse

    monkeypatch.setattr(CACHE, "_BUILD_CACHE", {})
    monkeypatch.setattr(sys.modules["fea_tpu_torch.solve"], "_STRUCTURED_MIN_DOF", 0)
    ext = sys.modules["fea_tpu_torch.solve.extruded"]
    builds = []
    real = ext.build_extruded
    monkeypatch.setattr(ext, "build_extruded", lambda *a, **kw: builds.append(1) or real(*a, **kw))
    nodes, elements = _tube()
    fixed = ftt.fix_where(nodes, lambda q: q[:, 2] == 0.0, 3)
    scene = _scene(nodes, elements, fixed, np.zeros_like(nodes))
    loads = _batch_loads(nodes, 2)
    sol = ftt.solve_many(scene, loads, tol=1e-8)
    assert bool(sol.stats.converged.all())
    K = assemble_sparse(nodes, elements, MAT["E"], MAT["nu"])
    F = 1.0 - fixed.astype(np.float64)
    for i in range(2):
        u = sol.displacements[i].numpy()
        r = F * (loads[i] - (K @ u.reshape(-1)).reshape(u.shape))
        assert np.linalg.norm(r) <= 1e-8 * np.linalg.norm(F * loads[i])
        one = ftt.solve(dataclasses.replace(scene, loads=torch.as_tensor(loads[i])), tol=1e-8)
        assert _close(sol.displacements[i], one.displacements, 1e-7)
    assert len(builds) == 1


@pytest.mark.parametrize("mesh, build_fn", [(_l_shape, "fea_tpu_torch.solve.embed:build_subgrid_embedded"),
                                           (_broken_box, "fea_tpu_torch.ops.twolevel:build_two_level_cheb")],
                         ids=["box-subset", "broken-connectivity"])
def test_box_subset_and_broken_connectivity_take_their_routes(mesh, build_fn, monkeypatch):
    """solve_many embeds a box subset in its box and sends a mesh of no
    grid and no box subset to the two-level preconditioner, as the
    reference does; every case meets tol in the true residual and agrees
    with a dense solve of it."""
    monkeypatch.setattr(CACHE, "_BUILD_CACHE", {})
    module, name = build_fn.split(":")
    built = []
    real = getattr(sys.modules[module], name)
    monkeypatch.setattr(sys.modules[module], name, lambda *a, **kw: built.append(name) or real(*a, **kw))
    nodes, elements = mesh()
    fixed = ftt.fix_where(nodes, lambda q: q[:, 2] == 0.0, 3)
    scene = _scene(nodes, elements, fixed, np.zeros_like(nodes))
    loads = _batch_loads(nodes, 2)
    sol = ftt.solve_many(scene, loads, tol=TOL)
    assert built == [name] and sol.stats.converged.all() and (sol.stats.relative_residual <= TOL).all()
    op = ftt.build_operator(scene, dtype=torch.float64)
    zero = torch.zeros_like(scene.loads)
    for i in range(2):
        dense = ftt.solve_operator(op, torch.as_tensor(loads[i]), zero, method="dense").displacements
        assert _close(sol.displacements[i].numpy(), dense.numpy(), 10 * TOL)


@pytest.fixture
def counted_builds(monkeypatch):
    """An empty build cache, and a count of the curvilinear builds."""
    monkeypatch.setattr(CACHE, "_BUILD_CACHE", {})
    monkeypatch.setattr(sys.modules["fea_tpu_torch.solve"], "_STRUCTURED_MIN_DOF", 0)
    builds = []
    build = CURV.build_curvilinear
    monkeypatch.setattr(CURV, "build_curvilinear", lambda *a, **kw: builds.append(1) or build(*a, **kw))
    return builds


def test_one_mesh_many_loads_builds_once(counted_builds):
    nodes, elements, fixed, loads = distorted(4, 4, 16)
    first = _scene(nodes, elements, fixed, loads)
    second = dataclasses.replace(first, loads=torch.as_tensor(-3.0 * loads + 0.5 * np.roll(loads, 1, axis=1)))
    for scene in (first, second):
        sol = ftt.solve(scene, tol=1e-8)
        fresh = ftt.solve(_scene(nodes, elements, fixed, scene.loads.numpy()), tol=1e-8)
        assert torch.allclose(sol.displacements, fresh.displacements, rtol=0,
                              atol=1e-12 * float(fresh.displacements.abs().max()))
    assert len(counted_builds) == 1 + 2  # the two fresh scenes build; the second solve of `first`'s mesh does not


def test_a_third_mesh_evicts_the_least_recently_used(counted_builds):
    scenes = [_scene(*distorted(4, 4, 16, seed=s)) for s in (1, 2, 3)]
    for scene in scenes:
        ftt.solve(scene, tol=1e-8)
    assert len(counted_builds) == 3
    (kind,) = [k for k in CACHE._BUILD_CACHE if k != "route"]  # beside the route's verdicts
    assert len(CACHE._BUILD_CACHE[kind]) == 2 and len(CACHE._BUILD_CACHE["route"]) == 2
    ftt.solve(scenes[2], tol=1e-8)  # still cached
    assert len(counted_builds) == 3
    ftt.solve(scenes[0], tol=1e-8)  # evicted: built again
    assert len(counted_builds) == 4


def test_renumbered_scene_takes_its_own_loads_each_time(counted_builds):
    nodes, elements, fixed, loads = distorted(4, 4, 16, seed=4)
    rng = np.random.default_rng(5)
    N = nodes.shape[0]
    pi = rng.permutation(N)  # original node k is renumbered pi[k]
    inv = np.empty_like(pi)
    inv[pi] = np.arange(N)
    el_r = pi[elements][rng.permutation(elements.shape[0])]
    renumbered = _scene(nodes[inv], el_r, fixed[inv], loads[inv])
    other = 2.0 * np.roll(loads, 3, axis=1)
    for case_loads in (loads, other):
        scene = dataclasses.replace(renumbered, loads=torch.as_tensor(case_loads[inv]))
        sol = ftt.solve(scene, tol=1e-8)
        ref = ftt.solve(_scene(nodes, elements, fixed, case_loads), tol=1e-8)
        u = sol.displacements.numpy()[pi]
        assert np.allclose(u, ref.displacements.numpy(), rtol=0, atol=1e-12 * np.abs(u).max())
    assert len(counted_builds) == 1 + 2


def test_solve_many_takes_the_build_of_solve(counted_builds):
    """``solve_many`` on a mesh ``solve()`` has built takes the cached
    build, and its cases agree with single solves."""
    nodes, elements, fixed, loads = distorted(4, 4, 16, seed=6)
    scene = _scene(nodes, elements, fixed, loads)
    single = ftt.solve(scene, tol=1e-8)
    batch = np.stack([loads, -2.0 * loads])
    sol = ftt.solve_many(scene, batch, tol=1e-8)
    assert len(counted_builds) == 1
    assert _close(sol.displacements[0], single.displacements, 1e-7)
    assert _close(sol.displacements[1], -2.0 * single.displacements.numpy(), 1e-7)


def test_clear_build_cache_drops_the_builds_and_their_plans(counted_builds):
    staged = sys.modules["fea_tpu_torch.solve.staged"]
    nodes, elements, fixed, loads = distorted(4, 4, 16, seed=7)
    scene = _scene(nodes, elements, fixed, loads)
    ftt.solve(scene, tol=1e-8)
    (kind,) = [k for k in CACHE._BUILD_CACHE if k != "route"]  # beside the route's verdict
    (entry,) = CACHE._BUILD_CACHE[kind]
    key = id(entry[2][1])  # the cached hierarchy keys its captured plan
    del entry
    assert key in staged._PLANS
    ftt.clear_build_cache()
    gc.collect()
    assert key not in staged._PLANS and not any(CACHE._BUILD_CACHE.values())
    ftt.solve(scene, tol=1e-8)
    assert len(counted_builds) == 2
