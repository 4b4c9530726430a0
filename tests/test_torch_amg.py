"""Port parity, the AMG route: block-CSR assembly and apply, the
smoothed-aggregation hierarchy and its V-cycle (``ops/amg.py``) against
fea_tpu's on the CPU, and the route of ``solve()`` (``solve/unstructured.py``)
against a dense f64 solve.

Tolerances: f64 assembly within 1e-12 of its scale (another summation
order) and applies within 1e-13; the f64 hierarchy pieces within 1e-10
(eigendecompositions by two LAPACK routines), the f32 level copies within
f32 rounding; one f32 V-cycle within 1e-5; a solve's true residual <= tol
and its displacements within 10 tol of the dense solve's.
"""
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fea_tpu as ft
from fea_tpu.ops import amg as jamg

import fea_tpu_torch as ftt
from fea_tpu_torch.ops import amg

from test_torch_embed import MAT, TOL, dense_u, l_arrays, scene_of, true_rel
from torch_pin import one_torch_thread  # noqa: F401

SOLVE = sys.modules["fea_tpu_torch.solve"]
CACHE = sys.modules["fea_tpu_torch.solve.cache"]
# fea_tpu.solve(tol=1e-8) of l_arrays(8, 24) with _BLOCK_PRECOND_MIN_DOF at
# 100 and FEA_TPU_NO_EMBED=1, JAX on the CPU in f64, the AMG route: 25
# iterations (its first pass runs to 0.3 tol), relative residual 1.43e-9
AMG_JAX_ITERS = 25


def both_hosts(nx=6, nz=20):
    nodes, elements, fixed, loads, _ = l_arrays(nx, nz)
    hj = jamg.assemble_bcsr(nodes, elements, ft.Material(**MAT), fixed)
    ht = amg.assemble_bcsr(torch.as_tensor(nodes), torch.as_tensor(elements), ftt.Material(**MAT),
                           torch.as_tensor(fixed))
    return nodes, hj, ht


def twisted(nx=8, nz=24):
    """The L-domain with element 0's corner order turned 90 degrees about
    z (tests/test_embed.py): the same cells, on no lattice."""
    nodes, elements, fixed, loads, _ = l_arrays(nx, nz)
    elements = elements.copy()
    elements[0] = elements[0][[3, 0, 1, 2, 7, 4, 5, 6]]
    return nodes, elements, fixed, loads


@pytest.fixture
def routed(monkeypatch):
    """The unstructured routes for small scenes, an empty build cache."""
    monkeypatch.setattr(SOLVE, "_BLOCK_PRECOND_MIN_DOF", 100)
    monkeypatch.setattr(CACHE, "_BUILD_CACHE", {})
    return monkeypatch


def test_assembly_matches_jax():
    _, hj, ht = both_hosts()
    np.testing.assert_array_equal(ht.nbr.numpy(), hj.nbr)
    assert np.abs(ht.W.numpy() - hj.W).max() <= 1e-12 * np.abs(hj.W).max()
    np.testing.assert_array_equal(ht.free.numpy(), hj.free)
    assert ht.min_detj == pytest.approx(hj.min_detj, rel=1e-12)


@pytest.mark.parametrize("masked", [True, False], ids=["masked", "raw"])
def test_apply_matches_jax(masked):
    nodes, hj, ht = both_hosts()
    u = np.random.default_rng(2).standard_normal(nodes.shape)
    want = jamg.bcsr_apply_np(hj, u, masked=masked)
    scale = np.abs(want).max()
    op = amg.BCSROperator.from_blocks(ht.nbr, ht.W, ht.free, torch.float64)
    got = (op.apply if masked else op.apply_raw)(torch.as_tensor(u)).numpy()
    assert np.abs(got - want).max() <= 1e-13 * scale
    op32 = op.astype(torch.float32)
    got32 = (op32.apply if masked else op32.apply_raw)(torch.as_tensor(u, dtype=torch.float32)).numpy()
    assert np.abs(got32 - want).max() <= 1e-5 * scale


def test_hierarchy_matches_jax():
    """The same levels, aggregates and bounds; the f64 prolongation and
    coarse blocks of the first coarsening within 1e-10; every level's f32
    blocks and P within f32 rounding; the coarsest inverse within 1e-9."""
    nodes, hj, ht = both_hosts(8, 24)
    mj, mt = jamg.build_amg(nodes, hj), amg.build_amg(nodes, ht)
    assert len(mt.levels) == len(mj.levels) >= 2
    for lt, lj in zip(mt.levels, mj.levels):
        assert lt.n_aggs == lj.n_aggs and lt.lam_max == pytest.approx(float(lj.lam_max), rel=1e-6)
        N, b, V, _ = lt.op.Wt.shape
        np.testing.assert_array_equal(lt.op.nbr.numpy(), np.asarray(lj.op.nbrT).T)
        wj = np.asarray(lj.op.W2).reshape(V, b, b, N).transpose(3, 0, 2, 1)  # (N, V, i, j)
        wt = lt.op.Wt.numpy().transpose(0, 2, 1, 3)
        assert np.abs(wt - wj).max() <= 1e-6 * np.abs(wj).max()
        if lt.P is not None:
            np.testing.assert_array_equal(lt.agg.numpy(), np.asarray(lj.agg))
            assert np.abs(lt.P.numpy() - np.asarray(lj.P)).max() <= 1e-6 * np.abs(np.asarray(lj.P)).max()
    cj = np.asarray(mj.coarse_inv)
    assert np.abs(mt.coarse_inv.numpy() - cj).max() <= 1e-9 * np.abs(cj).max()
    # the f64 pieces of the first coarsening, from the same aggregates
    agg, n_aggs = mt.levels[0].agg.numpy(), mt.levels[0].n_aggs
    nbr_j, W_j = jamg._self_first(hj.nbr, hj.W, hj.nbr.shape[0])
    nbr_t, W_t = amg._self_first(ht.nbr, ht.W, ht.nbr.shape[0])
    np.testing.assert_array_equal(nbr_t.numpy(), nbr_j)
    B = np.random.default_rng(4).standard_normal((nodes.shape[0], 3, 6))
    Pj, Bcj, weak_j = jamg._tentative_P(agg, n_aggs, B, hj.free)
    Pt, Bct, weak_t = amg._tentative_P(torch.as_tensor(agg, dtype=torch.int64), n_aggs, torch.as_tensor(B), ht.free)
    np.testing.assert_array_equal(weak_t.numpy(), weak_j)
    assert np.abs(Pt.numpy() - Pj).max() <= 1e-10 * np.abs(Pj).max()
    assert np.abs(Bct.numpy() - Bcj).max() <= 1e-10 * np.abs(Bcj).max()
    nc_j, Wc_j = jamg._galerkin_bcsr(nbr_j, W_j, hj.free, Pj, agg, n_aggs)
    nc_t, Wc_t = amg._galerkin_bcsr(nbr_t, W_t, ht.free, torch.as_tensor(Pj),
                                    torch.as_tensor(agg, dtype=torch.int64), n_aggs)
    np.testing.assert_array_equal(nc_t.numpy(), nc_j)
    assert np.abs(Wc_t.numpy() - Wc_j).max() <= 1e-10 * np.abs(Wc_j).max()


def test_one_vcycle_matches_jax():
    nodes, hj, ht = both_hosts(8, 24)
    mj, mt = jamg.build_amg(nodes, hj), amg.build_amg(nodes, ht)
    r = (np.random.default_rng(5).standard_normal(nodes.shape) * hj.free).astype(np.float32)
    want = np.asarray(mj(jnp.asarray(r)), np.float64)
    got = mt(torch.as_tensor(r))
    assert got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("mesh", ["l-domain", "twisted"])
def test_amg_route_matches_dense(mesh, routed):
    """The L-domain with the embedding switched off, and a mesh that embeds
    in no box with it on, take the AMG route."""
    if mesh == "l-domain":
        routed.setenv("FEA_TPU_NO_EMBED", "1")
        nodes, elements, fixed, loads, _ = l_arrays(8, 24)
    else:
        nodes, elements, fixed, loads = twisted()
    taken = []
    real = SOLVE._solve_unstructured_amg

    def must_not_run(*args, **kwargs):
        raise AssertionError("the embedded route was taken")

    routed.setattr(SOLVE, "_solve_unstructured_amg", lambda *a, **kw: taken.append(1) or real(*a, **kw))
    routed.setattr(SOLVE, "solve_subgrid_embedded", must_not_run)
    sol = ftt.solve(scene_of(nodes, elements, fixed, loads), tol=TOL)
    assert taken == [1] and sol.stats.converged
    u = sol.displacements.numpy()
    ud, K = dense_u(nodes, elements, fixed, loads)
    assert np.abs(u - ud).max() <= 10 * TOL * np.abs(ud).max()
    assert true_rel(K, fixed, loads, u) <= TOL
    assert sol.stats.relative_residual == pytest.approx(true_rel(K, fixed, loads, u), rel=1e-6)
    if mesh == "l-domain":
        assert sol.stats.iterations <= AMG_JAX_ITERS + 1


def test_amg_route_prescribed_values_are_exact(routed):
    routed.setenv("FEA_TPU_NO_EMBED", "1")
    nodes, elements, fixed, loads, presc = l_arrays(8, 24, presc=True)
    sol = ftt.solve(scene_of(nodes, elements, fixed, loads, presc), tol=TOL)
    u = sol.displacements.numpy()
    np.testing.assert_array_equal(u[fixed], presc[fixed])
    ud, _ = dense_u(nodes, elements, fixed, loads, presc)
    assert sol.stats.converged and np.abs(u - ud).max() <= 10 * TOL * np.abs(ud).max()


def test_amg_build_failure_warns_and_takes_the_two_level_route(routed):
    routed.setenv("FEA_TPU_NO_EMBED", "1")

    def boom(scene, **kw):
        raise RuntimeError("synthetic AMG failure")

    taken = []
    real = SOLVE._solve_unstructured_two_level
    routed.setattr(SOLVE, "build_amg_setup", boom)
    routed.setattr(SOLVE, "_solve_unstructured_two_level", lambda *a, **kw: taken.append(1) or real(*a, **kw))
    nodes, elements, fixed, loads, _ = l_arrays(8, 24)
    with pytest.warns(RuntimeWarning, match="AMG setup failed.*synthetic AMG failure"):
        sol = ftt.solve(scene_of(nodes, elements, fixed, loads), tol=TOL)
    assert taken == [1] and sol.stats.converged
