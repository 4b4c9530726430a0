"""Port parity, the extruded route: ``ops/extruded.py`` (the per-quad Ke
operator), ``ops/extruded_mg.py`` (the z hierarchy, the V-cycle, the
section-RBM coarse space) and ``solve/extruded.py`` against fea_tpu's on
the CPU, from the same seeded NumPy inputs.

Tolerances: f64 applies and diagonals within 1e-12 of scale; the
hierarchy's stored (f32) inverses and Thomas factors within 1e-5 of
their largest entry of the reference's host f64 oracle
(``device_build=False``); lambda_max within 1e-3 of the reference's and
at least the dense f64 spectral radius of M^-1 A for the STORED inverses;
the f32 V-cycle and section-coarse applies on identical factors within
2e-5, their multiplicative composition within 1e-4; a solve no more iterations than the reference's f64 FCG and
its displacements within 3e-8 of scale of the reference's, its true
residual by the oracle's K at most tol.
"""
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fea_tpu as ft
from fea_tpu.ops import extruded as jex
from fea_tpu.ops import extruded_mg as jmg
from fea_tpu.solve import extruded_mg_coarsenable as jax_coarsenable
from fea_tpu.solve import solve_extruded as jax_solve_extruded

import fea_tpu_torch as ftt
from fea_tpu_torch.ops import extruded as ex
from fea_tpu_torch.ops import extruded_mg as mg

from oracle import assemble_sparse
from torch_pin import one_torch_thread  # noqa: F401

MAT = dict(E=2e6, nu=0.3)
SOLVE = sys.modules["fea_tpu_torch.solve"]
CACHE = sys.modules["fea_tpu_torch.solve.cache"]


def tube_arrays(nseg, nlay, r_in, r_out, length, *, load="tip"):
    """The reference's tube mesh (z = 0 fixed) and a load: ``"tip"`` a
    unit +y shear on the tip ring (tests/test_extruded.py), ``"cosine"``
    the bench's 1000 lbf cosine load on the lower outer tip ring."""
    nodes2d, quads = ftt.mesh.annulus_section(nseg, r_in, r_out)
    nodes, elements = ftt.mesh.extrude_quads(nodes2d, quads, np.linspace(0.0, length, nlay + 1))
    fixed = ftt.fix_where(nodes, lambda p: p[:, 2] == 0.0, 3)
    loads = np.zeros_like(nodes)
    tip = nodes[:, 2] == nodes[:, 2].max()
    if load == "tip":
        loads[tip, 1] = 1.0 / tip.sum()
    else:
        sel = tip & (np.abs(np.hypot(nodes[:, 0], nodes[:, 1]) - r_out) < 1e-9) & (nodes[:, 1] < 0)
        w = np.cos(0.5 * np.pi * nodes[sel, 0] / r_out)
        loads[sel, 1] = -1000.0 * w / w.sum()
    return nodes, elements, fixed, loads


def both(nodes, elements, fixed, loads, mat=MAT, prescribed=None):
    jsc = ft.make_scene(nodes, elements, fixed, loads, ft.Material(**mat), prescribed=prescribed, dtype=jnp.float64)
    tsc = ftt.make_scene(nodes, elements, fixed, loads, ftt.Material(**mat), prescribed=prescribed,
                         dtype=torch.float64, device="cpu")
    return jsc, tsc, ex.infer_extruded(tsc)


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def jax_levels(m) -> list[dict]:
    return [dict(kes=np.asarray(lv.op.kes), quads=np.asarray(lv.op.quads), free=np.asarray(lv.op.free),
                 n_layers=lv.op.n_layers, minv_interior=np.asarray(lv.minv_interior), special_idx=lv.special_idx,
                 minv_special=np.asarray(lv.minv_special), lam_max=float(lv.lam_max)) for lv in m.levels]


@pytest.fixture(scope="module")
def tube32():
    """tests/test_extruded.py's two-level tube: 8 segments, 32 layers,
    1,584 DOF, tip shear."""
    return tube_arrays(8, 32, 0.08, 0.1, 0.6)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_apply_and_diag_match_jax_and_element_by_element(dtype):
    nodes, elements, fixed, loads = tube_arrays(10, 6, 0.08, 0.1, 0.5)
    jsc, tsc, det = both(nodes, elements, fixed, loads)
    jdet = jex.infer_extruded(jsc)
    assert det[1:] == jdet[1:] == (20, 7) and np.array_equal(det[0], jdet[0])
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    op_j = jex.build_extruded_operator(jsc, jdet, dtype=jdt)
    op_t = ex.build_extruded_operator(tsc, det, dtype=dtype)
    x = np.random.default_rng(11).standard_normal(nodes.shape)
    got = op_t.apply_raw(torch.as_tensor(x).to(dtype)).numpy()
    tol = 1e-12 if dtype == torch.float64 else 2e-6
    assert rel_err(got, op_j.apply_raw(jnp.asarray(x, jdt))) <= tol
    assert rel_err(op_t.diag_raw().numpy(), op_j.diag_raw()) <= tol
    # the masked apply and rhs of the reference's interface
    presc = np.where(fixed, 1e-3, 0.0)
    assert rel_err(op_t.apply(torch.as_tensor(x).to(dtype)).numpy(), op_j.apply(jnp.asarray(x, jdt))) <= tol
    assert rel_err(op_t.rhs(torch.as_tensor(loads).to(dtype), torch.as_tensor(presc).to(dtype)).numpy(),
                   op_j.rhs(jnp.asarray(loads, jdt), jnp.asarray(presc, jdt))) <= tol
    # the element-by-element operator of the same mesh
    ebe = ftt.build_operator(tsc, dtype=torch.float64, uniform=False)
    assert rel_err(got, ebe.apply_raw(torch.as_tensor(x)).numpy()) <= tol
    assert rel_err(op_t.diag_raw().numpy(), ebe.diag_raw().numpy()) <= tol


def test_detectors_and_tube_builder_match_jax():
    jsc, jdet = jex.extruded_scene_tube(8, 6, 0.08, 0.1, 0.5, ft.Material(**MAT), dtype=jnp.float64)
    tsc, det = ex.extruded_scene_tube(8, 6, 0.08, 0.1, 0.5, ftt.Material(**MAT), device="cpu")
    for a, b in ((tsc.nodes, jsc.nodes), (tsc.elements, jsc.elements), (tsc.fixed, jsc.fixed)):
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert det[1:] == jdet[1:] == ex.infer_extruded(tsc)[1:] and np.array_equal(det[0], jdet[0])
    nodes2d, quads = ftt.mesh.generate_quad_grid(2, 2, 0.1, 0.1)
    nodes, elements = ftt.mesh.extrude_quads(nodes2d, quads, np.array([0.0, 0.1, 0.3, 0.7]))  # graded z
    jsc, tsc, det = both(nodes, elements, np.zeros(nodes.shape, bool), np.zeros_like(nodes))
    assert det is None and jex.infer_extruded(jsc) is None
    for n in (16, 128, 12 * 2**5, 101, 2 * 81, 49):
        assert ex.extruded_mg_coarsenable(n) == jax_coarsenable(n)


def test_inverted_section_raises():
    nodes2d = np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0]])
    quads = np.array([[0, 3, 2, 1]])  # clockwise: inverted
    nodes, elements = ftt.mesh.extrude_quads(nodes2d, quads, np.array([0.0, 1.0]))
    fixed = ftt.fix_where(nodes, lambda p: p[:, 2] == 0.0, 3)
    jsc, tsc, _ = both(nodes, elements, fixed, np.zeros_like(nodes))
    with pytest.raises(ValueError, match="inverted"):
        jex.build_extruded_operator(jsc, dtype=jnp.float64)
    with pytest.raises(ValueError, match="inverted"):
        ex.build_extruded_operator(tsc, dtype=torch.float64)


def test_hierarchy_matches_jax_host_oracle(tube32):
    nodes, elements, fixed, loads = tube32
    jsc, tsc, det = both(nodes, elements, fixed, loads)
    m_j = jmg.build_extruded_multigrid(jsc, jex.infer_extruded(jsc), device_build=False)
    m_t = mg.build_extruded_multigrid(tsc, det)
    assert len(m_t.levels) == len(m_j.levels) == 1
    for lj, lt in zip(m_j.levels, m_t.levels):
        assert lt.special_idx == lj.special_idx
        assert lt.minv_interior.dtype == torch.float32
        assert rel_err(lt.minv_interior.numpy(), lj.minv_interior) <= 1e-5
        assert rel_err(lt.minv_special.numpy(), lj.minv_special) <= 1e-5
        assert abs(lt.lam_max - float(lj.lam_max)) <= 1e-3 * float(lj.lam_max)
    assert rel_err(m_t.thomas_uinv.numpy(), m_j.thomas_uinv) <= 1e-5
    assert rel_err(m_t.thomas_g.numpy(), m_j.thomas_g) <= 1e-5
    assert np.array_equal(m_t.coarse_free.numpy(), np.asarray(m_j._coarse_free))

    # the bound covers the spectrum of M^-1 A for the inverses it stores
    lv = m_t.levels[0]
    K = assemble_sparse(nodes, elements, MAT["E"], MAT["nu"]).toarray()
    f = 1.0 - fixed.reshape(-1).astype(np.float64)
    A = f[:, None] * K * f[None, :] + np.diag(1.0 - f)
    L, b = lv.op.n_layers, 3 * lv.op.n2
    Minv = np.zeros_like(A)
    for l in range(L):
        X = lv.minv_special[lv.special_idx.index(l)] if l in lv.special_idx else lv.minv_interior
        Minv[l * b:(l + 1) * b, l * b:(l + 1) * b] = X.numpy().astype(np.float64)
    rho = float(np.abs(np.linalg.eigvals(Minv @ A)).max())
    assert A.shape == (1584, 1584) and rho <= lv.lam_max


def test_vcycle_and_section_coarse_match_jax_on_identical_factors(tube32):
    nodes, elements, fixed, loads = tube32
    jsc, _, _ = both(nodes, elements, fixed, loads)
    jdet = jex.infer_extruded(jsc)
    m_j = jmg.build_extruded_multigrid(jsc, jdet, degree=3)
    sc_j = jmg.build_section_coarse(jsc, jdet, target_section_aggregates=8)
    m_t = mg.ExtrudedMultigrid.from_numpy(jax_levels(m_j), np.asarray(m_j.thomas_uinv), np.asarray(m_j.thomas_g),
                                          np.asarray(m_j._coarse_free), degree=3, device="cpu")
    sc_t = mg.SectionCoarse.from_numpy(np.asarray(sc_j.agg), np.asarray(sc_j.xrel), np.asarray(sc_j.thomas_uinv),
                                       np.asarray(sc_j.thomas_g), n_aggs=sc_j.n_aggs, n_layers=sc_j.n_layers,
                                       device="cpu")
    F = 1.0 - fixed.astype(np.float64)
    r = (np.random.default_rng(12).standard_normal(nodes.shape) * F).astype(np.float32)
    rj, rt = jnp.asarray(r), torch.as_tensor(r)
    assert rel_err(m_t(rt).numpy(), m_j(rj)) <= 2e-5
    assert rel_err(sc_t(rt).numpy(), sc_j(rj)) <= 2e-5
    # the reference's composition takes r - A z with the f32 level-0
    # operator, which cancels about a digit of f32
    z = mg.ComposedExtrudedPrecond(mg=m_t, sc=sc_t, op=m_t.levels[0].op)(rt).numpy()
    assert rel_err(z, jmg.ComposedExtrudedPrecond(mg=m_j, sc=sc_j)(rj)) <= 1e-4
    assert not z[fixed].any()  # the composed output is masked


def test_section_coarse_build_matches_jax_and_dense_oracle():
    """The section-RBM factors against the reference's (both chained in
    f64, stored in f32), and the coarse solve against the dense Galerkin
    solve P (P^T A P)^-1 P^T r of the oracle's masked K."""
    nodes, elements, fixed, loads = tube_arrays(12, 8, 0.08, 0.1, 0.5)
    jsc, tsc, det = both(nodes, elements, fixed, loads)
    sc_j = jmg.build_section_coarse(jsc, jex.infer_extruded(jsc), target_section_aggregates=6)
    sc_t = mg.build_section_coarse(tsc, det, target_section_aggregates=6)
    assert sc_t.n_aggs == sc_j.n_aggs > 1 and sc_t.n_layers == sc_j.n_layers
    n2 = det[1]
    assert np.array_equal(sc_t.agg_s.numpy(), np.asarray(sc_j.agg)[:n2])
    assert np.allclose(sc_t.xrel.numpy(), np.asarray(sc_j.xrel)[:n2], rtol=0, atol=1e-7)
    assert rel_err(sc_t.thomas_uinv.numpy(), sc_j.thomas_uinv) <= 1e-5
    assert rel_err(sc_t.thomas_g.numpy(), sc_j.thomas_g) <= 1e-5

    K = assemble_sparse(nodes, elements, MAT["E"], MAT["nu"]).toarray()
    f = 1.0 - fixed.reshape(-1).astype(np.float64)
    A = f[:, None] * K * f[None, :] + np.diag(1.0 - f)
    N, As = nodes.shape[0], sc_t.n_aggs
    agg = (np.arange(sc_t.n_layers)[:, None] * As + sc_t.agg_s.numpy()).reshape(-1)
    x = np.tile(sc_t.xrel.numpy().astype(np.float64), (sc_t.n_layers, 1))
    P = np.zeros((3 * N, 6 * As * sc_t.n_layers))
    for i in range(N):
        a = agg[i]
        P[3 * i:3 * i + 3, 6 * a:6 * a + 3] = np.eye(3)
        P[3 * i:3 * i + 3, 6 * a + 3:6 * a + 6] = [[0, -x[i, 2], x[i, 1]], [x[i, 2], 0, -x[i, 0]],
                                                   [-x[i, 1], x[i, 0], 0]]
    r = np.random.default_rng(5).standard_normal((N, 3))
    want = (P @ np.linalg.solve(P.T @ A @ P, P.T @ r.reshape(-1))).reshape(N, 3)
    sc64 = mg.SectionCoarse(**{**sc_t.__dict__, "thomas_uinv": sc_t.thomas_uinv.double(),
                               "thomas_g": sc_t.thomas_g.double()})
    assert rel_err(sc64(torch.as_tensor(r)).numpy(), want) <= 1e-6


def test_solve_extruded_matches_jax(tube32):
    nodes, elements, fixed, loads = tube32
    jsc, tsc, det = both(nodes, elements, fixed, loads)
    want = jax_solve_extruded(jsc, tol=1e-10, krylov="f64")
    sol = ftt.solve_extruded(tsc, det, tol=1e-10)
    assert sol.stats.converged and bool(want.stats.converged)
    assert sol.stats.iterations <= int(want.stats.iterations)
    u, u_j = sol.displacements.numpy(), np.asarray(want.displacements)
    assert rel_err(u, u_j) <= 3e-8
    K = assemble_sparse(nodes, elements, MAT["E"], MAT["nu"])
    F = 1.0 - fixed.astype(np.float64)
    assert np.linalg.norm(F * (loads - (K @ u.reshape(-1)).reshape(u.shape))) <= 1e-10 * np.linalg.norm(F * loads)
    assert rel_err(sol.reactions.numpy(), (K @ u.reshape(-1)).reshape(u.shape)) <= 1e-12


def test_prescribed_root_is_exact():
    nodes, elements, fixed, _ = tube_arrays(8, 16, 0.08, 0.1, 0.3)
    presc = np.zeros_like(nodes)
    presc[nodes[:, 2] == 0.0, 0] = 1e-4
    _, tsc, det = both(nodes, elements, fixed, np.zeros_like(nodes), prescribed=presc)
    sol = ftt.solve_extruded(tsc, det, tol=1e-10)
    u = sol.displacements.numpy()
    assert sol.stats.converged
    assert np.array_equal(u[fixed], presc[fixed])
    # with no loads the tube follows the imposed root translation rigidly
    assert np.abs(u[:, 0] - 1e-4).max() < 1e-9


def test_partial_constraints_match_jax(tube32):
    """A roller line (u_y fixed on the outer +x nodes of 13 interior node
    layers) beside the fixed root: special interior layers with mixed
    masks in the hierarchy and the section coarse space, against the
    reference's host build and solve; the fixed rows stay exactly 0."""
    nodes, elements, fixed, loads = tube32
    fixed = fixed.copy()
    fixed[(nodes[:, 0] > 0.099) & (nodes[:, 2] > 0.14) & (nodes[:, 2] < 0.39), 1] = True
    jsc, tsc, det = both(nodes, elements, fixed, loads)
    jdet = jex.infer_extruded(jsc)
    m_j = jmg.build_extruded_multigrid(jsc, jdet, device_build=False)
    m_t = mg.build_extruded_multigrid(tsc, det)
    lj, lt = m_j.levels[0], m_t.levels[0]
    assert lt.special_idx == lj.special_idx and len(lt.special_idx) == 15
    assert rel_err(lt.minv_special.numpy(), lj.minv_special) <= 1e-5
    assert abs(lt.lam_max - float(lj.lam_max)) <= 1e-3 * float(lj.lam_max)
    sc_j = jmg.build_section_coarse(jsc, jdet, target_section_aggregates=8)
    sc_t = mg.build_section_coarse(tsc, det, target_section_aggregates=8)
    assert rel_err(sc_t.thomas_uinv.numpy(), sc_j.thomas_uinv) <= 1e-5
    assert rel_err(sc_t.thomas_g.numpy(), sc_j.thomas_g) <= 1e-5
    want = jax_solve_extruded(jsc, tol=1e-10, krylov="f64")
    sol = ftt.solve_extruded(tsc, det, tol=1e-10)
    u = sol.displacements.numpy()
    assert sol.stats.converged and sol.stats.iterations <= int(want.stats.iterations)
    assert rel_err(u, want.displacements) <= 3e-8 and not u[fixed].any()
    K = assemble_sparse(nodes, elements, MAT["E"], MAT["nu"])
    F = 1.0 - fixed.astype(np.float64)
    assert np.linalg.norm(F * (loads - (K @ u.reshape(-1)).reshape(u.shape))) <= 1e-10 * np.linalg.norm(F * loads)


def test_slender_tube_converges_without_section_coarse():
    """tests/test_section_coarse.py's slender tube (L/R = 20, one element
    through the wall), whose all-f32 Thomas chain diverged the
    reference: the V-cycle alone converges, and the section coarse space
    cuts the count."""
    nodes, elements, fixed, loads = tube_arrays(32, 64, 0.0974, 0.1, 2.0, load="cosine")
    _, tsc, det = both(nodes, elements, fixed, loads, mat=dict(E=10_000_000 * ftt.units.psi, nu=0.3))
    base = ftt.solve_extruded(tsc, det, tol=1e-8, max_iters=250,
                              prebuilt=ftt.build_extruded(tsc, det, section_coarse=False))
    assert base.stats.converged and base.stats.iterations <= 150
    with_sc = ftt.solve_extruded(tsc, det, tol=1e-8, max_iters=250,
                                 prebuilt=ftt.build_extruded(tsc, det, section_aggregates=32))
    assert with_sc.stats.converged and with_sc.stats.iterations <= 0.7 * base.stats.iterations
    assert rel_err(with_sc.displacements.numpy(), base.displacements.numpy()) <= 1e-6


def test_solve_routes_the_tube_under_sharded_and_builds_once(monkeypatch, tube32):
    """A large extruded scene takes ``"fpcg-extruded-multigrid"`` also under
    ``sharded=True`` with several devices visible (on one device, as the
    reference), and a second solve takes the build from the cache."""
    monkeypatch.setattr(SOLVE, "_STRUCTURED_MIN_DOF", 0)
    monkeypatch.setattr(SOLVE, "_device_count", lambda device: 4)
    monkeypatch.setattr(CACHE, "_BUILD_CACHE", {})
    ext = sys.modules["fea_tpu_torch.solve.extruded"]
    builds = []
    real = ext.build_extruded
    monkeypatch.setattr(ext, "build_extruded", lambda *a, **kw: builds.append(1) or real(*a, **kw))
    nodes, elements, fixed, loads = tube32
    _, tsc, _ = both(nodes, elements, fixed, loads)
    cfg = ftt.SolverConfig(sharded=True)
    sol, route = SOLVE._solve_large_hex8(tsc, cfg, 1e-8, None, None, True)
    assert route == "fpcg-extruded-multigrid" and sol.stats.converged
    again = ftt.solve(tsc, config=cfg, tol=1e-8)
    assert len(builds) == 1 and rel_err(again.displacements.numpy(), sol.displacements.numpy()) <= 1e-14
