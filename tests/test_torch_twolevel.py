"""Port parity, the two-level fallback: the coarse Galerkin matrix, the
Gershgorin bound and both two-level preconditioners (``ops/twolevel.py``)
against fea_tpu's on the CPU, the two-level and block-Jacobi routes of
``solve()``, and the arbitrary branch of ``solve_many``.

Tolerances: f64 coarse matrix and bound within 1e-12 (another summation
order); the additive f64 preconditioner within 1e-10 (two inverses of the
coarse matrix); the f32 Chebyshev preconditioner within 1e-5; a solve's
true residual <= tol and its displacements within 10 tol of the dense
solve's.
"""
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fea_tpu as ft
from fea_tpu.ops import twolevel as jtl

import fea_tpu_torch as ftt
from fea_tpu_torch.ops import twolevel as tl

from test_torch_amg import twisted
from oracle import assemble_sparse
from test_torch_embed import MAT, TOL, dense_u, l_arrays, scene_of, true_rel
from torch_pin import one_torch_thread  # noqa: F401

SOLVE = sys.modules["fea_tpu_torch.solve"]
CACHE = sys.modules["fea_tpu_torch.solve.cache"]
# fea_tpu.solve(tol=1e-8) of l_arrays(8, 24) with _BLOCK_PRECOND_MIN_DOF at
# 100, FEA_TPU_NO_EMBED=1 and FEA_TPU_NO_AMG=1, JAX on the CPU in f64, the
# two-level route: 24 iterations, relative residual 2.64e-9
TWO_LEVEL_JAX_ITERS = 24
# ... and of l_arrays(16, 48) (32,691 DOF): 26 iterations, relative residual 1.87e-9
TWO_LEVEL_JAX_ITERS_32K = 26


def both_ops(nx=6, nz=12):
    nodes, elements, fixed, loads, _ = l_arrays(nx, nz)
    jsc = ft.make_scene(nodes, elements, fixed, loads, ft.Material(**MAT), dtype=jnp.float64)
    tsc = scene_of(nodes, elements, fixed, loads)
    return nodes, ft.build_operator(jsc, dtype=jnp.float64), ftt.build_operator(tsc, dtype=torch.float64)


@pytest.fixture
def routed(monkeypatch):
    """The two-level route for small scenes, an empty build cache."""
    monkeypatch.setattr(SOLVE, "_BLOCK_PRECOND_MIN_DOF", 100)
    monkeypatch.setattr(CACHE, "_BUILD_CACHE", {})
    monkeypatch.setenv("FEA_TPU_NO_EMBED", "1")
    monkeypatch.setenv("FEA_TPU_NO_AMG", "1")
    return monkeypatch


def test_coarse_matrix_and_gershgorin_match_jax():
    nodes, op_j, op_t = both_ops()
    agg, n_aggs = jtl.aggregate_nodes(nodes, 24)
    agg_t, n_t = tl.aggregate_nodes(nodes, 24)
    assert n_t == n_aggs and np.array_equal(agg_t, agg)
    xrel = jtl.rigid_body_geometry(nodes, agg, n_aggs)
    np.testing.assert_array_equal(tl.rigid_body_geometry(nodes, agg, n_aggs), xrel)
    Ac_j, inv_j, lam_j = jtl.coarse_matrix(op_j, agg, n_aggs, xrel, chunk=64, with_gershgorin=True,
                                           dtype=jnp.float64)
    Ac_t, inv_t, lam_t = tl.coarse_matrix(op_t, agg, n_aggs, xrel, chunk=64, with_gershgorin=True)
    assert np.abs(Ac_t.numpy() - Ac_j).max() <= 1e-12 * np.abs(Ac_j).max()
    assert np.abs(inv_t.numpy() - inv_j).max() <= 1e-12 * np.abs(inv_j).max()
    assert lam_t == pytest.approx(lam_j, rel=1e-12)
    inv_sj, lam_sj = jtl.jacobi_gershgorin(op_j, chunk=50)
    inv_st, lam_st = tl.jacobi_gershgorin(op_t, chunk=50)
    assert np.abs(inv_st.numpy() - inv_sj).max() <= 1e-12 * np.abs(inv_sj).max()
    assert lam_st == pytest.approx(lam_sj, rel=1e-12) and lam_st == pytest.approx(lam_t, rel=1e-12)


def test_preconditioners_match_jax():
    nodes, op_j, op_t = both_ops()
    r = np.random.default_rng(6).standard_normal(nodes.shape) * np.asarray(op_j.free)
    add_j = jtl.build_two_level(op_j, nodes, target_aggregates=24)
    add_t = tl.build_two_level(op_t, nodes, target_aggregates=24)
    want = np.asarray(add_j(jnp.asarray(r)))
    assert np.abs(add_t(torch.as_tensor(r)).numpy() - want).max() <= 1e-10 * np.abs(want).max()
    # the reference's f64 build has the 1e-12 ridge; the port masks the
    # coarse correction, so the free rows are the reference's and the fixed
    # rows (the identity block of the masked operator, zero residual) zero
    cheb_j = jtl.build_two_level_cheb(op_j, nodes, target_aggregates=24, build_dtype=jnp.float64)
    cheb_t = tl.build_two_level_cheb(op_t, nodes, target_aggregates=24, ridge=1e-12)
    r32 = r.astype(np.float32)
    want = np.asarray(cheb_j(jnp.asarray(r32)), np.float64)
    got = cheb_t(torch.as_tensor(r32)).numpy()
    free = np.asarray(op_j.free) > 0
    assert got.dtype == np.float32 and (got[~free] == 0).all()
    assert np.abs(got[free] - want[free]).max() <= 1e-5 * np.abs(want).max()


def test_two_level_route_matches_dense(routed):
    taken = []
    real = SOLVE._solve_unstructured_two_level
    routed.setattr(SOLVE, "_solve_unstructured_two_level", lambda *a, **kw: taken.append(1) or real(*a, **kw))
    nodes, elements, fixed, loads, _ = l_arrays(8, 24)
    sol = ftt.solve(scene_of(nodes, elements, fixed, loads), tol=TOL)
    assert taken == [1] and sol.stats.converged
    assert sol.stats.iterations <= TWO_LEVEL_JAX_ITERS + 1
    u = sol.displacements.numpy()
    ud, K = dense_u(nodes, elements, fixed, loads)
    assert np.abs(u - ud).max() <= 10 * TOL * np.abs(ud).max()
    assert true_rel(K, fixed, loads, u) <= TOL


def test_two_level_route_at_32k_dof_meets_tol_in_the_reference_count(routed):
    """At 32,691 DOF an unmasked coarse correction left the fixed rows
    drifting and the certified residual stuck at 1.3e-8 after three
    correction passes; masked, the route converges in the reference's
    count (JAX on the CPU: 26)."""
    nodes, elements, fixed, loads, _ = l_arrays(16, 48)
    sol = ftt.solve(scene_of(nodes, elements, fixed, loads), tol=TOL)
    assert sol.stats.converged and sol.stats.iterations <= TWO_LEVEL_JAX_ITERS_32K + 1
    u = sol.displacements.numpy()
    assert (u[fixed] == 0).all()
    K = assemble_sparse(nodes, elements, MAT["E"], MAT["nu"])
    assert true_rel(K, fixed, loads, u) <= TOL


def test_two_level_build_failure_warns_and_takes_block_jacobi(routed):
    def boom(op, nodes, **kw):
        raise RuntimeError("synthetic two-level failure")

    routed.setattr(tl, "build_two_level_cheb", boom)
    nodes, elements, fixed, loads, _ = l_arrays(8, 24)
    with pytest.warns(RuntimeWarning, match="two-level preconditioner build failed.*synthetic"):
        sol = ftt.solve(scene_of(nodes, elements, fixed, loads), tol=TOL)
    assert sol.stats.converged
    u = sol.displacements.numpy()
    ud, K = dense_u(nodes, elements, fixed, loads)
    assert np.abs(u - ud).max() <= 10 * TOL * np.abs(ud).max()
    assert true_rel(K, fixed, loads, u) <= TOL


def test_solve_many_arbitrary_branch_case_0_is_its_solve(routed):
    """A mesh that embeds in no box: solve_many takes the two-level
    preconditioner from the cache solve() fills, so case 0 is its solve()
    bit for bit."""
    routed.delenv("FEA_TPU_NO_EMBED")
    nodes, elements, fixed, loads = twisted()
    scene = scene_of(nodes, elements, fixed, loads)
    batch = np.stack([loads, -0.5 * loads, np.roll(loads, 1, axis=1)])
    one = ftt.solve(scene, tol=TOL)
    many = ftt.solve_many(scene, batch, tol=TOL)
    assert many.stats.converged.all()
    assert torch.equal(many.displacements[0], one.displacements)
    _, K = dense_u(nodes, elements, fixed, loads)
    for i in range(3):
        assert true_rel(K, fixed, batch[i], many.displacements[i].numpy()) <= TOL
