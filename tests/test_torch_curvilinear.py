"""Port parity, the curvilinear route: detection, weight assembly, the
variable-weight apply (the plain version of K4/K5), Galerkin RAP, the
V-cycle and the whole solve of fea_tpu_torch against fea_tpu.

The scenes are distorted box grids (grid connectivity, interior nodes
moved by up to a quarter cell), the mesh family of the route. Inputs
come from NumPy seeds and go through both packages on the CPU; JAX's
Pallas kernels run in interpret mode. Convergence is judged by a true
residual recomputed in NumPy f64.
"""
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fea_tpu as ft
from fea_tpu.ops import curvilinear as jcv

import fea_tpu_torch as ftt
from fea_tpu_torch.ops import curvilinear as cv
from fea_tpu_torch.ops.cuda_varstencil import var_apply
from fea_tpu_torch.ops.multigrid import MultigridPreconditioner
from torch_pin import one_torch_thread  # noqa: F401

MAT = dict(E=1e7, nu=0.3)
TOL = 1e-8


@pytest.fixture
def large_routes_for_small_scenes(monkeypatch):
    monkeypatch.setattr(sys.modules["fea_tpu.solve"], "_STRUCTURED_MIN_DOF", 0)
    monkeypatch.setattr(sys.modules["fea_tpu_torch.solve"], "_STRUCTURED_MIN_DOF", 0)


def distorted(nx, ny, nz, *, seed=7, amp=0.25):
    """A box grid with interior nodes moved by ``amp`` cells (the scene of
    tests/test_curvilinear.py), as host arrays."""
    lz = 0.1 * nz / nx
    nodes, elements = ft.mesh.box_hex_mesh(nx, ny, nz, 0.1, 0.12, lz)
    rng = np.random.default_rng(seed)
    h = 0.1 / nx
    interior = (nodes[:, 2] > 0) & (nodes[:, 2] < lz)
    nodes = nodes + amp * h * rng.uniform(-1, 1, nodes.shape) * interior[:, None]
    fixed = ft.fix_where(nodes, lambda q: np.isclose(q[:, 2], 0.0), 3)
    loads = np.zeros_like(nodes)
    tip = np.isclose(nodes[:, 2], lz)
    loads[tip, 1] = 1.0 / tip.sum()
    return nodes, elements, fixed, loads


def both_scenes(nodes, elements, fixed, loads, prescribed=None):
    jsc = ft.make_scene(nodes, elements, fixed, loads, ft.Material(**MAT), prescribed=prescribed,
                        dtype=jnp.float64)
    tsc = ftt.make_scene(nodes, elements, fixed, loads, ftt.Material(**MAT), prescribed=prescribed,
                         dtype=torch.float64, device="cpu")
    return jsc, tsc


def true_rel_residual(nodes, dims, fixed, loads, presc, u):
    """||F (loads - K u)|| / ||b|| in NumPy f64 from a host-assembled
    field, b the masked rhs."""
    nx, ny, nz = dims
    w = jcv.assemble_curv_weights_np(nodes, dims, ft.Material(**MAT))
    K = lambda v: jcv.curv_apply_np(w, v.reshape(nz + 1, ny + 1, nx + 1, 3)).reshape(-1, 3)  # noqa: E731
    F = 1.0 - fixed.astype(np.float64)
    xp = (1.0 - F) * (0.0 if presc is None else presc)
    b = F * (loads - K(xp)) + xp
    return np.linalg.norm(F * (loads - K(u))) / np.linalg.norm(b)


def test_infer_topo_dims_matches_jax():
    nodes, elements, fixed, loads = distorted(3, 4, 6)
    jsc, tsc = both_scenes(nodes, elements, fixed, loads)
    assert cv.infer_topo_dims(tsc) == jcv.infer_topo_dims(jsc) == (3, 4, 6)
    # the same mesh with two element rows swapped is not the grid as given
    el = elements.copy()
    el[[0, 1]] = el[[1, 0]]
    jsc, tsc = both_scenes(nodes, el, fixed, loads)
    assert cv.infer_topo_dims(tsc) is None and jcv.infer_topo_dims(jsc) is None
    # an annulus extrusion wraps around: not a box grid
    n2, q2 = ft.mesh.annulus_section(8, 0.05, 0.08)
    n3, e3 = ft.mesh.extrude_quads(n2, q2, np.linspace(0, 0.2, 4))
    jsc, tsc = both_scenes(n3, e3, np.zeros(n3.shape, bool), np.zeros(n3.shape))
    assert cv.infer_topo_dims(tsc) is None and jcv.infer_topo_dims(jsc) is None


@pytest.mark.parametrize("chunk_elems", [24, 8192], ids=["slabs", "whole"])
def test_weight_assembly_matches_jax(chunk_elems):
    dims = (3, 4, 6)
    nodes, elements, fixed, loads = distorted(*dims)
    want = jcv.assemble_curv_weights_np(nodes, dims, ft.Material(**MAT))
    w, min_detj = cv.assemble_curv_weights(torch.as_tensor(nodes), dims, ftt.Material(**MAT),
                                           chunk_elems=chunk_elems)
    got = cv.grid_view(w).numpy()
    assert float(min_detj) > 0
    assert got.shape == want.shape
    # two f64 integrations in another summation order
    assert np.max(np.abs(got - want)) <= 1e-12 * np.max(np.abs(want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_assembly_on_a_cpu_tensor_is_the_plain_version(dtype):
    """On a CPU tensor ``assemble_curv_weights`` is the plain chunked
    assembly symmetrized, bit for bit, with and without a void mask, and
    launches no kernel; the kernel's wrapper refuses a CPU tensor; a dtype
    the kernel lacks raises TypeError on either."""
    from fea_tpu_torch.ops import cuda_curv_weights

    dims = (3, 4, 6)
    nodes = torch.as_tensor(distorted(*dims)[0])
    mat = ftt.Material(**MAT)
    valid = (np.random.default_rng(5).random((6, 4, 3)) < 0.7).astype(np.uint8)
    n0 = dict(cuda_curv_weights.LAUNCHES)
    for v in (None, valid):
        got, mdj = cv.assemble_curv_weights(nodes, dims, mat, dtype=dtype, chunk_elems=24, valid=v)
        want, want_mdj = cv.assemble_curv_weights_plain(nodes, dims, mat, dtype=dtype, chunk_elems=24, valid=v)
        assert got.dtype == dtype and torch.equal(got, cv.symmetrize_field(want)) and torch.equal(mdj, want_mdj)
    assert cuda_curv_weights.LAUNCHES == n0
    with pytest.raises(ValueError, match="no kernel"):
        cuda_curv_weights.curv_weights(nodes, dims, mat, dtype=dtype)
    with pytest.raises(TypeError):
        cv.assemble_curv_weights(nodes, dims, mat, dtype=torch.float16)
    with pytest.raises(TypeError):
        cuda_curv_weights.curv_weights(nodes, dims, mat, dtype=torch.float16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_var_apply_plain_matches_jax(dtype, rng):
    """The plain version that K4 (f32) and K5 (f64) are held against, on
    the CPU, against the host oracle and JAX's Pallas kernels (interpret
    mode) at a tiny shape."""
    from fea_tpu.ops import pallas_varstencil as pv

    dims = (3, 4, 6)
    nx, ny, nz = dims
    nodes = distorted(*dims)[0]
    w64 = jcv.assemble_curv_weights_np(nodes, dims, ft.Material(**MAT))
    g = rng.standard_normal((nz + 1, ny + 1, nx + 1, 3))
    want = jcv.curv_apply_np(w64, g)
    scale = np.abs(want).max()
    w = cv.CurvilinearOperator.from_numpy(w64, np.ones((g.size // 3, 3)), device="cpu").w.to(dtype)
    got = var_apply(w, torch.as_tensor(g).to(dtype)).double().numpy()
    xT = jnp.asarray(np.transpose(g, (3, 1, 2, 0)))
    if dtype == torch.float32:
        # f32 rounding of inputs, weights and 243 products per node
        assert np.max(np.abs(got - want)) <= 2e-5 * scale
        jk = pv.var_apply_transposed(pv.var_fields_f32(jnp.asarray(w64)), xT.astype(jnp.float32),
                                     interpret=True)
        jk = np.transpose(np.asarray(jk, np.float64), (3, 1, 2, 0))
        assert np.max(np.abs(got - jk)) <= 2e-5 * scale
    else:
        assert np.max(np.abs(got - want)) <= 1e-13 * scale
        hi = xT.astype(jnp.float32)
        lo = (xT - hi.astype(jnp.float64)).astype(jnp.float32)
        oh, ol = pv.var_apply_transposed_dd(pv.var_fields_dd(jnp.asarray(w64)), hi, lo, interpret=True)
        jk = np.transpose(np.asarray(oh, np.float64) + np.asarray(ol, np.float64), (3, 1, 2, 0))
        # the TPU kernel's double-f32 accuracy, ~1e-11
        assert np.max(np.abs(got - jk)) <= 1e-9 * scale


@pytest.mark.parametrize("dims", [(4, 4, 8), (6, 5, 12)], ids=["full", "semi"])
def test_rap_matches_jax(dims):
    step = cv.coarsen_dims_partial(dims)
    assert step == jcv.coarsen_dims_partial(dims)
    assert cv.curv_coarsenable(dims, max_coarse_dof=500) == jcv.curv_coarsenable(dims, max_coarse_dof=500)
    axes = step[1]
    assert np.array_equal(cv.rap_coeffs(axes), jcv.rap_coeffs(axes))
    w = jcv.assemble_curv_weights_np(distorted(*dims)[0], dims, ft.Material(**MAT))
    want = jcv.rap_np(w, axes)
    scale = np.abs(want).max()
    got = cv.grid_view(cv.rap_dev(cv.CurvilinearOperator.from_numpy(w, np.ones((1, 3)), device="cpu").w,
                                  axes)).numpy()
    assert np.max(np.abs(got - want)) <= 1e-13 * scale
    assert np.max(np.abs(got - np.asarray(jcv.rap_dev(jnp.asarray(w), axes=axes)))) <= 1e-13 * scale


def test_gershgorin_matches_jax():
    dims = (3, 4, 6)
    nodes, _, fixed, _ = distorted(*dims)
    w = jcv.assemble_curv_weights_np(nodes, dims, ft.Material(**MAT))
    free = (1.0 - fixed.astype(np.float64)).reshape(7, 5, 4, 3)
    inv_want, lam_want = jcv._gershgorin_np(w, free)
    wt = cv.CurvilinearOperator.from_numpy(w, np.ones((1, 3)), device="cpu").w
    inv_dev, lam_dev = cv._gershgorin_dev(wt, torch.as_tensor(free))
    assert lam_dev == pytest.approx(lam_want, rel=1e-13)
    assert np.allclose(inv_dev.numpy(), inv_want, rtol=1e-13, atol=0)


def _jax_levels(mg):
    return [
        dict(w=np.asarray(lv.w), free=np.asarray(lv.free), inv_diag=np.asarray(lv.inv_diag),
             lam=float(lv.lam_max), dims=lv.dims, dtype=np.asarray(lv.w).dtype)
        for lv in mg.levels
    ]


def test_vcycle_matches_jax():
    """One V-cycle of a random f32 residual on (8, 8, 32), with
    ``f64_below_dof`` lowered so that an f32 coarse level exists: through
    the reference's own hierarchy (``from_numpy``) and the port's build."""
    dims = (8, 8, 32)
    nodes, elements, fixed, loads = distorted(*dims)
    jsc, tsc = both_scenes(nodes, elements, fixed, loads)
    free_np = 1.0 - fixed.astype(np.float64)
    jop = jcv.build_curv_operator(jsc, dims, dtype=jnp.float64)
    kw = dict(degree=2, f64_below_dof=1000)
    mg_j = jcv.build_curv_multigrid(nodes, dims, free_np, jsc.material, w0=jop.w, **kw)
    top = cv.build_curv_operator(tsc, dims)
    mg_own = cv.build_curv_multigrid(top.w, dims, free_np, **kw)
    mg_from = MultigridPreconditioner.from_numpy(_jax_levels(mg_j), np.asarray(mg_j.coarse_inv), degree=2,
                                                 device="cpu", coarsen_axes=mg_j.coarsen_axes,
                                                 level_type=cv._CurvLevel)
    assert [lv.dims for lv in mg_own.levels] == [lv.dims for lv in mg_j.levels] == [(8, 8, 32), (4, 4, 16)]
    assert [lv.dtype for lv in mg_own.levels] == [torch.float32, torch.float32]
    assert mg_own.coarsen_axes == tuple(mg_j.coarsen_axes)
    r = (np.random.default_rng(11).normal(size=(tsc.n_nodes, 3)) * free_np).astype(np.float32)
    want = np.asarray(mg_j(jnp.asarray(r)), np.float64)
    for mg in (mg_from, mg_own):
        got = mg(torch.as_tensor(r))
        assert got.dtype == torch.float32
        # same math, another summation order: f32 rounding only
        assert np.max(np.abs(got.double().numpy() - want)) <= 2e-5 * np.abs(want).max()


@pytest.mark.parametrize("prescribed", [False, True], ids=["loads", "prescribed"])
def test_curvilinear_solve_matches_jax(prescribed, large_routes_for_small_scenes):
    """The whole route on (8, 8, 32), 8,019 DOF, through both packages'
    ``solve``; and the port's solve through the reference's own operator
    and hierarchy carried across."""
    dims = (8, 8, 32)
    nodes, elements, fixed, loads = distorted(*dims)
    presc = None
    if prescribed:
        # prescribe uy on the tip face as well as the root
        tip = np.isclose(nodes[:, 2], nodes[:, 2].max())
        fixed = fixed.copy()
        fixed[tip, 1] = True
        presc = np.zeros_like(nodes)
        presc[tip, 1] = 1e-4
        loads = np.zeros_like(nodes)
    jsc, tsc = both_scenes(nodes, elements, fixed, loads, presc)
    ref = ft.solve(jsc, tol=TOL)
    sol = ftt.solve(tsc, tol=TOL)
    u_ref = np.asarray(ref.displacements)
    u = sol.displacements.numpy()
    assert bool(ref.stats.converged) and sol.stats.converged
    assert sol.stats.iterations <= int(ref.stats.iterations)
    rel = true_rel_residual(nodes, dims, fixed, loads, presc, u)
    assert rel <= TOL
    assert sol.stats.relative_residual == pytest.approx(rel, rel=1e-3)
    if presc is not None:
        assert np.array_equal(u[fixed], presc[fixed])
    assert np.max(np.abs(u - u_ref)) <= 10 * TOL * np.max(np.abs(u_ref))
    r_ref = np.asarray(ref.reactions)
    assert np.max(np.abs(sol.reactions.numpy() - r_ref)) <= 10 * TOL * np.max(np.abs(r_ref))

    jop, jmg = ft.build_curvilinear(jsc)
    op = cv.CurvilinearOperator.from_numpy(np.asarray(jop.w), np.asarray(jop.free), device="cpu")
    mg = MultigridPreconditioner.from_numpy(_jax_levels(jmg), np.asarray(jmg.coarse_inv), degree=jmg.degree,
                                            device="cpu", coarsen_axes=jmg.coarsen_axes, level_type=cv._CurvLevel)
    carried = ftt.solve_curvilinear(tsc, dims, tol=TOL, prebuilt=(op, mg))
    assert carried.stats.converged and carried.stats.iterations <= int(ref.stats.iterations)
    assert true_rel_residual(nodes, dims, fixed, loads, presc, carried.displacements.numpy()) <= TOL


def test_smoke_oracle_matches_jax(rng):
    """The benchmark's host K u (``fea_tpu_torch.bench._family.host_ku``,
    which chip_smoke.py's host checks use too), element by element and
    sharing no code with either package's assembly, against the
    reference's host field."""
    from fea_tpu_torch.bench._family import host_ku

    dims = (3, 4, 6)
    nodes, elements, _, _ = distorted(*dims)
    u = rng.standard_normal(nodes.shape)
    w = jcv.assemble_curv_weights_np(nodes, dims, ft.Material(**MAT))
    want = jcv.curv_apply_np(w, u.reshape(7, 5, 4, 3)).reshape(-1, 3)
    got = host_ku(nodes, elements, MAT["E"], MAT["nu"], u, chunk=20)  # several chunks
    assert np.max(np.abs(got - want)) <= 1e-12 * np.max(np.abs(want))


def test_inverted_element_raises(large_routes_for_small_scenes):
    nodes, elements, fixed, loads = distorted(3, 4, 6)
    el0 = elements[0]
    nodes = nodes.copy()
    nodes[[el0[0], el0[6]]] = nodes[[el0[6], el0[0]]]
    _, tsc = both_scenes(nodes, elements, fixed, loads)
    with pytest.raises(ValueError, match="Jacobian"):
        cv.build_curv_operator(tsc, (3, 4, 6))
    with pytest.raises(ValueError, match="Jacobian"):
        ftt.solve(tsc)
