"""Port parity, routing: the canonicalized route of fea_tpu_torch.solve
against the curvilinear solve of the un-renumbered scene and against
fea_tpu's detector, and the extruded route, which a z-extruded box mesh
takes instead of the curvilinear one. Everything runs on the CPU."""
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fea_tpu as ft
from fea_tpu.ops.canonical import infer_renumbered_grid as jax_infer_renumbered_grid
from fea_tpu.ops.extruded import infer_extruded as jax_infer_extruded

import fea_tpu_torch as ftt
from fea_tpu_torch.ops.canonical import infer_renumbered_grid
from fea_tpu_torch.ops.curvilinear import curv_coarsenable, infer_topo_dims
from fea_tpu_torch.ops.extruded import infer_extruded

from test_torch_curvilinear import MAT, TOL, distorted, true_rel_residual
from torch_pin import one_torch_thread  # noqa: F401


@pytest.fixture
def large_routes_for_small_scenes(monkeypatch):
    monkeypatch.setattr(sys.modules["fea_tpu_torch.solve"], "_STRUCTURED_MIN_DOF", 0)


def _scene(nodes, elements, fixed, loads):
    return ftt.make_scene(nodes, elements, fixed, loads, ftt.Material(**MAT), dtype=torch.float64, device="cpu")


def test_renumbered_grid_takes_the_canonicalized_route(large_routes_for_small_scenes):
    dims = (8, 8, 32)
    nodes, elements, fixed, loads = distorted(*dims)
    rng = np.random.default_rng(5)
    N = nodes.shape[0]
    pi = rng.permutation(N)  # original node k is renumbered pi[k]
    inv = np.empty_like(pi)
    inv[pi] = np.arange(N)
    el_r = pi[elements][rng.permutation(elements.shape[0])]
    renumbered = _scene(nodes[inv], el_r, fixed[inv], loads[inv])
    assert infer_topo_dims(renumbered) is None
    det = infer_renumbered_grid(renumbered)
    jsc = ft.make_scene(nodes[inv], el_r, fixed[inv], loads[inv], ft.Material(**MAT), dtype=jnp.float64)
    jdet = jax_infer_renumbered_grid(jsc)
    assert det[0] == jdet[0] == dims and np.array_equal(det[1], jdet[1])
    assert np.array_equal(det[1][pi], np.arange(N))  # node pi[k] is grid node k

    sol = ftt.solve(renumbered, tol=TOL)
    ref = ftt.solve(_scene(nodes, elements, fixed, loads), tol=TOL)
    assert sol.stats.converged
    # the canonical scene is the original one: the same arithmetic
    assert sol.stats.iterations == ref.stats.iterations
    u = sol.displacements.numpy()[pi]
    assert np.allclose(u, ref.displacements.numpy(), rtol=0, atol=1e-12 * np.abs(u).max())
    assert np.allclose(sol.reactions.numpy()[pi], ref.reactions.numpy(), rtol=0,
                       atol=1e-12 * np.abs(ref.reactions.numpy()).max())
    assert true_rel_residual(nodes, dims, fixed, loads, None, u) <= TOL


def test_z_extruded_box_mesh_raises_item_12(large_routes_for_small_scenes, monkeypatch):
    """A box-connectivity mesh whose section is distorted alike in every
    layer matches the extruded and the curvilinear detectors; the
    reference takes the extruded route, so the port must take it too
    (it raised while the route was not ported, hence the name), never the
    curvilinear one, and meet tol in the true residual."""
    solve_mod = sys.modules["fea_tpu_torch.solve"]
    monkeypatch.setattr(sys.modules["fea_tpu_torch.solve.cache"], "_BUILD_CACHE", {})
    dims = (6, 6, 24)
    nodes, elements = ftt.mesh.box_hex_mesh(*dims, 0.1, 0.1, 0.4)
    n2 = 7 * 7
    section = nodes[:n2, :2] + 0.2 * (0.1 / 6) * np.random.default_rng(3).uniform(-1, 1, (n2, 2))
    nodes[:, :2] = np.tile(section, (25, 1))
    fixed = ftt.fix_where(nodes, lambda q: q[:, 2] == 0.0, 3)
    loads = np.ones_like(nodes)
    scene = _scene(nodes, elements, fixed, loads)
    assert infer_topo_dims(scene) == dims and curv_coarsenable(dims)
    assert infer_extruded(scene) is not None
    jsc = ft.make_scene(nodes, elements, fixed, loads, ft.Material(**MAT), dtype=jnp.float64)
    assert jax_infer_extruded(jsc) is not None

    def must_not_run(*args, **kwargs):
        raise AssertionError("the curvilinear route was taken")

    taken = []
    real = solve_mod.solve_extruded
    monkeypatch.setattr(solve_mod, "solve_curvilinear", must_not_run)
    monkeypatch.setattr(solve_mod, "solve_extruded", lambda *a, **kw: taken.append("extruded") or real(*a, **kw))
    sol = ftt.solve(scene, tol=TOL)
    assert taken == ["extruded"] and sol.stats.converged
    assert true_rel_residual(nodes, dims, fixed, loads, None, sol.displacements.numpy()) <= TOL


def test_l_shaped_subset_takes_the_embedded_route(large_routes_for_small_scenes, monkeypatch):
    """No grid detector claims an L-domain; above both thresholds solve()
    embeds it in its box (never the AMG route) and meets tol in the true
    residual."""
    solve_mod = sys.modules["fea_tpu_torch.solve"]
    monkeypatch.setattr(solve_mod, "_BLOCK_PRECOND_MIN_DOF", 0)
    monkeypatch.setattr(sys.modules["fea_tpu_torch.solve.cache"], "_BUILD_CACHE", {})
    nodes, elements = ftt.mesh.l_hex_mesh(6, 6, 18, 0.1, 0.1, 0.4)
    fixed = ftt.fix_where(nodes, lambda q: q[:, 2] == 0.0, 3)
    scene = _scene(nodes, elements, fixed, np.ones_like(nodes))
    assert infer_topo_dims(scene) is None and infer_renumbered_grid(scene) is None
    taken = []
    real = solve_mod.solve_subgrid_embedded

    def spy(*args, **kwargs):
        taken.append("embedded")
        return real(*args, **kwargs)

    def must_not_run(*args, **kwargs):
        raise AssertionError("the AMG route was taken")

    monkeypatch.setattr(solve_mod, "solve_subgrid_embedded", spy)
    monkeypatch.setattr(solve_mod, "_solve_unstructured_amg", must_not_run)
    sol = ftt.solve(scene, tol=TOL)
    assert taken == ["embedded"] and sol.stats.converged
    op = ftt.build_operator(scene, dtype=torch.float64)
    r = op.free * (scene.loads - op.apply_raw(sol.displacements))
    assert float(r.norm() / (op.free * scene.loads).norm()) <= TOL


def test_entry_points_need_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is the card")
    nodes, elements = ftt.mesh.box_hex_mesh(1, 1, 1, 1.0, 1.0, 1.0)
    zeros = np.zeros_like(nodes)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ftt.make_scene(nodes, elements, zeros, zeros, ftt.Material(**MAT))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ftt.scene_from_numpy(nodes, elements, zeros, zeros, MAT["E"], MAT["nu"])
    assert _scene(nodes, elements, zeros, zeros).device == torch.device("cpu")
