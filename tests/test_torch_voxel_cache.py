"""The voxel route's entry in the build cache (``solve/cache.py``): a repeat
``solve()`` or ``solve_many`` on one box mesh skips the routing, the
structured operator and V-cycle builds and, on the card, the FCG capture.

The key is the identity and version of the scene's ``nodes``, ``elements``
and ``fixed`` tensors and (E, nu); loads and prescribed values are taken
fresh each call. Each answer is held against a solve of a freshly made
scene of the same mesh and loads, within 1e-12 of max |u| (the same build
arithmetic, so the same iterates).
"""
import dataclasses
import gc
import sys
import weakref

import numpy as np
import pytest
import torch

import fea_tpu_torch as ftt
from fea_tpu_torch import utils
from fea_tpu_torch.parallel import halo
from torch_pin import one_torch_thread  # noqa: F401

SOLVE = sys.modules["fea_tpu_torch.solve"]
CACHE = sys.modules["fea_tpu_torch.solve.cache"]
STAGED = sys.modules["fea_tpu_torch.solve.staged"]
STRUCTURED = sys.modules["fea_tpu_torch.ops.structured"]
MULTIGRID = sys.modules["fea_tpu_torch.ops.multigrid"]
MAT = dict(E=1e7, nu=0.3)
TOL = 1e-8


def _mesh(nx=4, ny=4, nz=16, lz=0.4):
    nodes, elements = ftt.mesh.box_hex_mesh(nx, ny, nz, 0.1, 0.1, lz)
    return nodes, elements, ftt.fix_where(nodes, lambda q: q[:, 2] == 0.0, 3)


def _tip_loads(nodes, seed):
    rng = np.random.default_rng(seed)
    loads = np.zeros_like(nodes)
    tip = nodes[:, 2] == nodes[:, 2].max()
    loads[tip, 0] = rng.uniform(-1.0, 1.0)
    loads[tip, 1] = rng.uniform(0.5, 2.0)
    return loads


def _scene(nodes, elements, fixed, loads, **mat):
    return ftt.make_scene(nodes, elements, fixed, loads, ftt.Material(**(mat or MAT)), dtype=torch.float64,
                          device="cpu")


def _close(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) <= 1e-12 * np.max(np.abs(b))


@pytest.fixture
def builds(monkeypatch):
    """An empty build cache, the large routes for small scenes, and the
    voxel route's builds as they happen: "op" for each structured
    operator, "mg" for each V-cycle."""
    monkeypatch.setattr(CACHE, "_BUILD_CACHE", {})
    monkeypatch.setattr(SOLVE, "_STRUCTURED_MIN_DOF", 0)
    made = []
    for module, name, tag in ((STRUCTURED, "build_structured_operator", "op"),
                              (MULTIGRID, "build_multigrid", "mg")):
        real = getattr(module, name)
        monkeypatch.setattr(module, name, lambda *a, _real=real, _tag=tag, **kw: made.append(_tag) or _real(*a, **kw))
    return made


def _voxel_entries():
    return CACHE._BUILD_CACHE.get("voxel", [])


def test_one_mesh_three_load_cases_builds_once(builds):
    nodes, elements, fixed = _mesh()
    scene = _scene(nodes, elements, fixed, np.zeros_like(nodes))
    cases = [_tip_loads(nodes, seed) for seed in (1, 2, 3)]
    utils.reset()
    sols = []
    for i, loads in enumerate(cases):
        sol = ftt.solve(dataclasses.replace(scene, loads=torch.as_tensor(loads)), tol=TOL)
        assert sol.route == "fpcg-multigrid" and sol.stats.converged
        sols.append(sol)
        if i == 0:
            first = len(utils.spans())
    assert builds == ["op", "mg"]
    assert utils.counters() == {"build_cache.miss.route": 1, "build_cache.hit.route": 2,
                                "build_cache.miss.voxel": 1, "build_cache.hit.voxel": 2}
    hits = utils.spans()[first:]
    roots = [s for s in hits if s.parent is None]
    assert [s.name for s in roots] == ["fea.solve", "fea.solve"]
    names = {s.name for s in hits}
    assert not any(n.startswith("fea.build.") for n in names) and "fea.route" not in names
    assert "fea.fcg.run" in names and "fea.certify" in names
    for loads, sol in zip(cases, sols):
        fresh = ftt.solve(_scene(nodes, elements, fixed, loads), tol=TOL)
        assert _close(sol.displacements, fresh.displacements)
        assert _close(sol.reactions, fresh.reactions)


def test_solve_many_after_solve_takes_the_same_entry(builds):
    nodes, elements, fixed = _mesh()
    loads = _tip_loads(nodes, 4)
    scene = _scene(nodes, elements, fixed, loads)
    single = ftt.solve(scene, tol=TOL)
    (entry,) = _voxel_entries()
    batch = ftt.solve_many(scene, np.stack([loads, -2.0 * loads, _tip_loads(nodes, 5)]), tol=TOL)
    assert builds == ["op", "mg"] and _voxel_entries() == [entry]
    assert bool(batch.stats.converged.all())
    assert torch.allclose(batch.displacements[0], single.displacements, rtol=0,
                          atol=1e-7 * float(single.displacements.abs().max()))
    fresh = ftt.solve_many(_scene(nodes, elements, fixed, loads), np.stack([loads, -2.0 * loads,
                                                                             _tip_loads(nodes, 5)]), tol=TOL)
    assert _close(batch.displacements, fresh.displacements)


def test_solve_after_solve_many_takes_the_same_entry(builds):
    nodes, elements, fixed = _mesh()
    loads = _tip_loads(nodes, 6)
    scene = _scene(nodes, elements, fixed, loads)
    utils.reset()
    ftt.solve_many(scene, np.stack([loads, 3.0 * loads]), tol=TOL)
    sol = ftt.solve(scene, tol=TOL)
    assert builds == ["op", "mg"]
    assert utils.counters() == {"build_cache.miss.route": 1, "build_cache.hit.route": 1,
                                "build_cache.miss.voxel": 1, "build_cache.hit.voxel": 1}
    assert _close(sol.displacements, ftt.solve(_scene(nodes, elements, fixed, loads), tol=TOL).displacements)


def test_an_in_place_edit_of_the_nodes_misses_and_rebuilds(builds):
    nodes, elements, fixed = _mesh()
    loads = _tip_loads(nodes, 7)
    scene = _scene(nodes, elements, fixed, loads)
    ftt.solve(scene, tol=TOL)
    utils.reset()
    scene.nodes.mul_(2.0)
    sol = ftt.solve(scene, tol=TOL)
    assert builds == ["op", "mg"] * 2
    assert utils.counters() == {"build_cache.miss.route": 1, "build_cache.miss.voxel": 1}
    assert len(_voxel_entries()) == 1  # the stale entry can never hit again: the lookup dropped it
    fresh = ftt.solve(_scene(2.0 * nodes, elements, fixed, loads), tol=TOL)
    assert _close(sol.displacements, fresh.displacements)


def test_an_in_place_edit_of_the_supports_misses(builds):
    nodes, elements, fixed = _mesh()
    loads = _tip_loads(nodes, 8)
    scene = _scene(nodes, elements, fixed, loads)
    ftt.solve(scene, tol=TOL)
    tip = torch.as_tensor(nodes[:, 2] == nodes[:, 2].max())
    scene.fixed[tip, 0] = True  # a roller on the tip face: x held there too
    sol = ftt.solve(scene, tol=TOL)
    assert sol.stats.converged
    assert builds == ["op", "mg"] * 2
    fresh = ftt.solve(_scene(nodes, elements, scene.fixed.numpy(), loads), tol=TOL)
    assert _close(sol.displacements, fresh.displacements)


def test_another_material_misses(builds):
    nodes, elements, fixed = _mesh()
    loads = _tip_loads(nodes, 9)
    scene = _scene(nodes, elements, fixed, loads)
    ftt.solve(scene, tol=TOL)
    utils.reset()
    softer = dataclasses.replace(scene, material=ftt.Material(E=5e6, nu=0.3))
    sol = ftt.solve(softer, tol=TOL)
    assert builds == ["op", "mg"] * 2
    assert utils.counters() == {"build_cache.miss.route": 1, "build_cache.miss.voxel": 1}
    ftt.solve(scene, tol=TOL)  # both materials are kept
    assert builds == ["op", "mg"] * 2
    assert utils.counters() == {"build_cache.miss.route": 1, "build_cache.hit.route": 1,
                                "build_cache.miss.voxel": 1, "build_cache.hit.voxel": 1}
    fresh = ftt.solve(_scene(nodes, elements, fixed, loads, E=5e6, nu=0.3), tol=TOL)
    assert _close(sol.displacements, fresh.displacements)


def test_clear_build_cache_drops_the_voxel_entry_and_its_plan(builds):
    nodes, elements, fixed = _mesh()
    scene = _scene(nodes, elements, fixed, _tip_loads(nodes, 10))
    ftt.solve(scene, tol=TOL)
    (entry,) = _voxel_entries()
    key = id(entry[2][1])  # the cached hierarchy keys its plan
    del entry
    assert key in STAGED._PLANS
    ftt.clear_build_cache()
    gc.collect()
    assert key not in STAGED._PLANS and not _voxel_entries()
    ftt.solve(scene, tol=TOL)
    assert builds == ["op", "mg"] * 2


def test_a_mesh_the_caller_dropped_is_dropped_with_its_plan(builds):
    """A new mesh every call (each scene dropped after its solve) keeps
    no earlier build alive past the next lookup: the entries hold their
    key tensors weakly."""
    nodes, elements, fixed = _mesh()
    scene = _scene(nodes, elements, fixed, _tip_loads(nodes, 13))
    ftt.solve(scene, tol=TOL)
    (entry,) = _voxel_entries()
    mg, plan = weakref.ref(entry[2][1]), weakref.ref(STAGED._PLANS[id(entry[2][1])])
    del entry, scene
    gc.collect()
    other = _scene(nodes, elements, fixed, _tip_loads(nodes, 14))
    ftt.solve(other, tol=TOL)
    gc.collect()
    (entry,) = _voxel_entries()
    assert entry[0][0]() is other.nodes and mg() is None and plan() is None
    assert builds == ["op", "mg"] * 2


def test_a_non_voxel_scene_adds_no_voxel_entry(builds):
    from test_torch_curvilinear import distorted

    nodes, elements, fixed, loads = distorted(4, 4, 16)
    utils.reset()
    sol = ftt.solve(_scene(nodes, elements, fixed, loads), tol=TOL)
    assert sol.route == "fpcg-curvilinear-multigrid"
    assert list(CACHE._BUILD_CACHE) == ["route", ("curvilinear", 2, True)] and builds == []
    assert not any("voxel" in name for name in utils.counters())


def test_the_z_sharded_route_keeps_no_entry(builds, monkeypatch):
    monkeypatch.setattr(SOLVE, "_device_count", lambda device: 4)
    calls = []
    real = halo.ZShardedSolver.solve
    monkeypatch.setattr(halo.ZShardedSolver, "solve", lambda self, *a, **k: calls.append(1) or real(self, *a, **k))
    nodes, elements, fixed = _mesh(2, 2, 16, 1.0)
    scene = _scene(nodes, elements, fixed, _tip_loads(nodes, 11))
    for _ in range(2):
        sol = ftt.solve(scene, config=ftt.SolverConfig(sharded=True), tol=TOL)
        assert sol.route == "fpcg-multigrid-zsharded" and sol.stats.converged
    assert calls == [1, 1] and builds == ["op", "mg"] * 2 and not _voxel_entries()


def test_a_scene_of_inference_tensors_is_kept_on_identity(builds):
    """An inference tensor has no version counter: the entry keys on the
    tensors' identity alone, and a repeat solve builds nothing."""
    nodes, elements, fixed = _mesh()
    loads = _tip_loads(nodes, 12)
    with torch.inference_mode():
        scene = _scene(nodes, elements, fixed, loads)
    assert scene.nodes.is_inference() and scene.host_nodes is scene.host_nodes  # one host copy a scene
    utils.reset()
    sols = [ftt.solve(scene, tol=TOL) for _ in range(2)]
    assert builds == ["op", "mg"] and len(_voxel_entries()) == 1
    assert utils.counters()["build_cache.hit.voxel"] == 1
    assert torch.equal(sols[1].displacements, sols[0].displacements)
    assert _close(sols[0].displacements, ftt.solve(_scene(nodes, elements, fixed, loads), tol=TOL).displacements)


def test_a_curvilinear_scene_of_inference_tensors_does_not_rebuild(builds, monkeypatch):
    from test_torch_curvilinear import distorted

    curv = sys.modules["fea_tpu_torch.solve.curv"]
    made = []
    real = curv.build_curvilinear
    monkeypatch.setattr(curv, "build_curvilinear", lambda *a, **kw: made.append(1) or real(*a, **kw))
    nodes, elements, fixed, loads = distorted(4, 4, 16)
    with torch.inference_mode():
        scene = _scene(nodes, elements, fixed, loads)
    utils.reset()
    sols = [ftt.solve(scene, tol=TOL) for _ in range(2)]
    assert all(sol.route == "fpcg-curvilinear-multigrid" for sol in sols)
    assert made == [1]
    assert utils.counters()["build_cache.hit.route"] == 1 and utils.counters()["build_cache.hit.curvilinear"] == 1
    assert torch.equal(sols[1].displacements, sols[0].displacements)
