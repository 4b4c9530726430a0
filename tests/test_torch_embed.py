"""Port parity, the embedded route: ``assemble_curv_weights(valid=)`` and
the box embedding of a mesh whose cells are a subset of a box grid's
(``solve/embed.py``) against fea_tpu, the element-gather oracle and a
dense f64 solve. Everything runs on the CPU.

Tolerances: f64 weights within 1e-12 of their scale (another summation
order), the embedded apply within 1e-11 of the oracle's, a solve's true
residual <= tol and its displacements within 10 tol of the dense solve's.
"""
import dataclasses
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fea_tpu as ft
from fea_tpu.ops import curvilinear as jcv
from fea_tpu.ops.canonical import infer_subgrid_embedding as jax_infer_subgrid_embedding

import fea_tpu_torch as ftt
from fea_tpu_torch.ops import curvilinear as cv
from fea_tpu_torch.ops.canonical import infer_subgrid_embedding
from fea_tpu_torch.solve import embed

from oracle import assemble_sparse, solve_reduced
from torch_pin import one_torch_thread  # noqa: F401

SOLVE = sys.modules["fea_tpu_torch.solve"]
CACHE = sys.modules["fea_tpu_torch.solve.cache"]
MAT = dict(E=1e7, nu=0.3)
TOL = 1e-8
# fea_tpu.solve(tol=1e-8) of l_arrays(8, 24) with _BLOCK_PRECOND_MIN_DOF at
# 100, JAX on the CPU in f64, the embedded route: 18 iterations, relative
# residual 3.83e-9 (the scene and call of test_solve_routes_to_the_embedding)
EMBED_JAX_ITERS = 18


def l_arrays(nx, nz, *, seed=7, distort=0.2, presc=False):
    """tests/test_amg.py's L-domain: interior nodes moved by ``distort`` h
    U(-1, 1), z = 0 fixed, a +y load of 1 / n_tip on the tip face; with
    ``presc``, the root shifted by 1e-4 along x."""
    lz = 0.1 * nz / nx
    nodes, elements = ftt.mesh.l_hex_mesh(nx, nx, nz, 0.1, 0.1, lz)
    rng = np.random.default_rng(seed)
    interior = (nodes[:, 2] > 1e-12) & (nodes[:, 2] < lz - 1e-12)
    nodes = nodes + distort * (0.1 / nx) * rng.uniform(-1, 1, nodes.shape) * interior[:, None]
    fixed = ftt.fix_where(nodes, lambda q: np.isclose(q[:, 2], 0.0), 3)
    loads = np.zeros_like(nodes)
    tip = np.isclose(nodes[:, 2], lz)
    loads[tip, 1] = 1.0 / tip.sum()
    p = None
    if presc:
        p = np.zeros_like(nodes)
        p[np.isclose(nodes[:, 2], 0.0), 0] = 1e-4
    return nodes, elements, fixed, loads, p


def scene_of(nodes, elements, fixed, loads, presc=None):
    return ftt.make_scene(nodes, elements, fixed, loads, ftt.Material(**MAT), prescribed=presc,
                          dtype=torch.float64, device="cpu")


def dense_u(nodes, elements, fixed, loads, presc=None):
    """Displacements by a direct f64 solve of the oracle's sparse K."""
    K = assemble_sparse(nodes, elements, MAT["E"], MAT["nu"])
    xp = np.zeros_like(nodes) if presc is None else presc * fixed
    f = loads.reshape(-1) - K @ xp.reshape(-1)
    u = solve_reduced(K, f, fixed.reshape(-1)).reshape(nodes.shape)
    return np.where(fixed, xp, u), K


def true_rel(K, fixed, loads, u):
    F = 1.0 - fixed.astype(np.float64)
    r = F * (loads - (K @ u.reshape(-1)).reshape(u.shape))
    return float(np.linalg.norm(r) / np.linalg.norm(F * loads))


@pytest.fixture
def routed(monkeypatch):
    """The embedded route for small scenes, an empty build cache."""
    monkeypatch.setattr(SOLVE, "_BLOCK_PRECOND_MIN_DOF", 100)
    monkeypatch.setattr(CACHE, "_BUILD_CACHE", {})
    return monkeypatch


def _detector_meshes(name):
    nodes, elements, fixed, loads, _ = l_arrays(4, 8)
    if name == "renumbered":
        perm = np.random.default_rng(1).permutation(nodes.shape[0])  # node k becomes node perm[k]
        inv = np.argsort(perm)
        return nodes[inv], perm[elements][np.random.default_rng(2).permutation(elements.shape[0])]
    if name == "twisted":
        elements = elements.copy()
        elements[0] = elements[0][[3, 0, 1, 2, 7, 4, 5, 6]]
    if name == "full-grid":
        return ftt.mesh.box_hex_mesh(3, 4, 5, 0.3, 0.4, 0.5)
    if name == "disconnected":
        n2 = nodes + np.array([1.0, 0.0, 0.0])
        return np.concatenate([nodes, n2]), np.concatenate([elements, elements + nodes.shape[0]])
    return nodes, elements


@pytest.mark.parametrize("name", ["l-domain", "renumbered", "twisted", "full-grid", "disconnected"])
def test_detector_matches_jax(name):
    """The frontier sweep gives the reference's (dims, lat, valid), or
    None where it gives None."""
    nodes, elements = _detector_meshes(name)
    zeros = np.zeros_like(nodes)
    got = infer_subgrid_embedding(scene_of(nodes, elements, zeros, zeros))
    want = jax_infer_subgrid_embedding(ft.make_scene(nodes, elements, zeros, zeros, ft.Material(**MAT),
                                                     dtype=jnp.float64))
    assert (got is None) == (want is None) and (want is None) == (name in ("twisted", "disconnected"))
    if want is not None:
        assert got[0] == want[0]
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])
        assert bool(got[2].all()) == (name == "full-grid")


def test_valid_masked_weights_match_jax():
    """Void cells add exactly zero, and their detJ stays out of the
    minimum; a void lattice site moved anywhere, even onto one point with
    every other (degenerate cells, inf and NaN Ke), changes nothing."""
    nodes, elements, fixed, loads, _ = l_arrays(4, 8)
    scene = scene_of(nodes, elements, fixed, loads)
    dims, lat, valid = infer_subgrid_embedding(scene)
    assert not valid.all()
    carrier = embed.build_subgrid_embedded(scene, (dims, lat, valid))[0]
    emb = carrier.nodes.numpy()
    w, mdj = cv.assemble_curv_weights(torch.as_tensor(emb), dims, ftt.Material(**MAT), valid=valid)
    wj, mdj_j = jcv.assemble_curv_weights(jnp.asarray(emb), dims, ft.Material(**MAT), valid=valid)
    got, want = cv.grid_view(w).numpy(), np.asarray(wj)
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    assert float(mdj) == pytest.approx(float(mdj_j), rel=1e-12)
    assert float(mdj) == pytest.approx(float(ftt.build_operator(scene, torch.float64).geom.min_detj), rel=1e-12)
    void = np.ones(emb.shape[0], bool)
    void[lat] = False
    assert void.any() and not got.reshape(27, -1, 3, 3)[:, void].any()
    degenerate = emb.copy()
    degenerate[void] = emb[void][0]
    w2, mdj2 = cv.assemble_curv_weights(torch.as_tensor(degenerate), dims, ftt.Material(**MAT), valid=valid)
    assert torch.equal(w2, w) and float(mdj2) == float(mdj)


def test_embedded_operator_matches_element_oracle():
    """Restricted to the real DOFs, the embedded stencil is the mesh's
    stiffness."""
    nodes, elements, fixed, loads, _ = l_arrays(4, 8)
    scene = scene_of(nodes, elements, fixed, loads)
    carrier, op, mg, lat = embed.build_subgrid_embedded(scene, infer_subgrid_embedding(scene))
    K = assemble_sparse(nodes, elements, MAT["E"], MAT["nu"])
    u = np.random.default_rng(2).standard_normal(nodes.shape)
    u_emb = torch.zeros((carrier.n_nodes, 3), dtype=torch.float64)
    u_emb[torch.as_tensor(lat)] = torch.as_tensor(u)
    got = op.apply_raw(u_emb).numpy()[lat]
    want = (K @ u.reshape(-1)).reshape(u.shape)
    assert np.abs(got - want).max() <= 1e-11 * np.abs(want).max()
    # every void DOF is fixed: the masked operator is the identity there
    void = np.ones(carrier.n_nodes, bool)
    void[lat] = False
    assert (op.free.numpy()[void] == 0).all()


def test_solve_routes_to_the_embedding(routed):
    """solve() embeds the L-domain (never the AMG route), meets tol in the
    true residual, agrees with the dense solve, and reports K u as its
    reactions (the loads on free rows, support reactions on fixed rows);
    a second solve with other loads takes the cached build and its own
    loads."""
    nodes, elements, fixed, loads, _ = l_arrays(8, 24)
    scene = scene_of(nodes, elements, fixed, loads)
    assert scene.n_dof >= 2000
    taken, builds = [], []
    real_solve, real_build = SOLVE.solve_subgrid_embedded, embed.build_subgrid_embedded

    def must_not_run(*args, **kwargs):
        raise AssertionError("the AMG route was taken")

    routed.setattr(SOLVE, "solve_subgrid_embedded", lambda *a, **kw: taken.append(1) or real_solve(*a, **kw))
    routed.setattr(embed, "build_subgrid_embedded", lambda *a, **kw: builds.append(1) or real_build(*a, **kw))
    routed.setattr(SOLVE, "_solve_unstructured_amg", must_not_run)
    sol = ftt.solve(scene, tol=TOL)
    assert taken == [1] and builds == [1] and sol.stats.converged
    u = sol.displacements.numpy()
    ud, K = dense_u(nodes, elements, fixed, loads)
    assert np.abs(u - ud).max() <= 10 * TOL * np.abs(ud).max()
    assert true_rel(K, fixed, loads, u) <= TOL
    assert sol.stats.iterations <= EMBED_JAX_ITERS + 1
    Ku = (K @ u.reshape(-1)).reshape(u.shape)
    assert np.abs(sol.reactions.numpy() - Ku).max() <= 1e-10 * np.abs(Ku).max()
    sol2 = ftt.solve(dataclasses.replace(scene, loads=2.5 * scene.loads), tol=TOL)
    assert taken == [1, 1] and builds == [1]
    assert np.abs(sol2.displacements.numpy() - 2.5 * ud).max() <= 25 * TOL * np.abs(ud).max()


def test_embedded_prescribed_values_are_exact(routed):
    nodes, elements, fixed, loads, presc = l_arrays(8, 24, presc=True)
    sol = ftt.solve(scene_of(nodes, elements, fixed, loads, presc), tol=TOL)
    u = sol.displacements.numpy()
    np.testing.assert_array_equal(u[fixed], presc[fixed])
    ud, _ = dense_u(nodes, elements, fixed, loads, presc)
    assert sol.stats.converged and np.abs(u - ud).max() <= 10 * TOL * np.abs(ud).max()


def test_solve_many_embedded_case_0_is_its_solve(routed):
    nodes, elements, fixed, loads, _ = l_arrays(8, 24)
    scene = scene_of(nodes, elements, fixed, loads)
    rng = np.random.default_rng(3)
    batch = np.stack([loads, rng.uniform(-1, 1) * loads, np.roll(loads, 1, axis=1)])
    many = ftt.solve_many(scene, batch, tol=TOL)
    assert many.displacements.shape == (3,) + nodes.shape and many.stats.converged.all()
    one = ftt.solve(scene, tol=TOL)
    assert torch.equal(many.displacements[0], one.displacements)
    assert torch.equal(many.reactions[0], one.reactions)
    K = assemble_sparse(nodes, elements, MAT["E"], MAT["nu"])
    for i in range(3):
        assert true_rel(K, fixed, batch[i], many.displacements[i].numpy()) <= TOL


def test_no_embed_takes_the_amg_route(routed):
    routed.setenv("FEA_TPU_NO_EMBED", "1")
    taken = []
    real = SOLVE._solve_unstructured_amg

    def must_not_run(*args, **kwargs):
        raise AssertionError("the embedded route was taken")

    routed.setattr(SOLVE, "_solve_unstructured_amg", lambda *a, **kw: taken.append(1) or real(*a, **kw))
    routed.setattr(SOLVE, "solve_subgrid_embedded", must_not_run)
    nodes, elements, fixed, loads, _ = l_arrays(8, 24)
    sol = ftt.solve(scene_of(nodes, elements, fixed, loads), tol=TOL)
    assert taken == [1] and sol.stats.converged
