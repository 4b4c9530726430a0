"""Port parity, the element-by-element route of ``fea_tpu_torch.solve``:
Jacobi / block-Jacobi PCG and the dense solve over ``StiffnessOperator``,
beams, bars and the Newton-Krylov truss, the post-processing and the
routing of small scenes and explicit methods, against fea_tpu and the
closed forms and oracles of tests/test_{integration,beam,truss,solver}.py.

Everything runs here on the CPU in f64 unless a case says otherwise; the
element applies take the plain versions of K6/K7. Iteration counts are
compared with fea_tpu's on the same scene; residuals are recomputed, never
taken from fea_tpu's recurrence.
"""
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fea_tpu as ft
from fea_tpu.elements import beam as jbeam

import fea_tpu_torch as ftt
from fea_tpu_torch.bench import scenes
from fea_tpu_torch.elements import truss

from oracle import assemble_sparse, solve_reduced
from test_integration import cubebeam_scene, tube_scene
from torch_pin import one_torch_thread  # noqa: F401

ANCHOR = 3.0504e-4  # cubebeam max|u| (tests/test_integration.py)
SOLVE = sys.modules["fea_tpu_torch.solve"]


def port(jsc, dtype=torch.float64):
    """The port's scene of a fea_tpu scene, on the CPU."""
    section = None if jsc.section is None else np.asarray(jsc.section)
    presc = None if jsc.prescribed is None else np.asarray(jsc.prescribed)
    return ftt.scene_from_numpy(
        np.asarray(jsc.nodes).astype(np.float64 if dtype == torch.float64 else np.float32), np.asarray(jsc.elements),
        np.asarray(jsc.fixed), np.asarray(jsc.loads), float(jsc.material.E), float(jsc.material.nu), presc,
        family=jsc.family, section=section, device="cpu",
    )


def spd_system(rng, n=200):
    A_half = rng.normal(size=(n, n))
    return A_half @ A_half.T + n * np.eye(n), rng.normal(size=n)


# -- solvers -------------------------------------------------------------

def test_pcg_random_spd(rng):
    A, b = spd_system(rng)
    At = torch.as_tensor(A)
    for kw in (dict(precond_diag=torch.diagonal(At)), dict(precond=lambda r: r / torch.diagonal(At)), {}):
        x, stats = ftt.pcg(lambda v: At @ v, torch.as_tensor(b), tol=1e-12, **kw)
        assert stats.converged
        assert np.linalg.norm(A @ x.numpy() - b) < 1e-10 * np.linalg.norm(b)


def test_pcg_zero_rhs():
    x, stats = ftt.pcg(lambda v: v, torch.zeros(8, dtype=torch.float64), tol=1e-10)
    assert stats.converged and stats.iterations == 0
    assert torch.all(x == 0)


def test_dense_solve_reports_true_residual(rng):
    A, b = spd_system(rng, 50)
    free = np.ones(50)
    free[:5] = 0.0
    x, stats = ftt.dense_solve(torch.as_tensor(A), torch.as_tensor(b), torch.as_tensor(free))
    Am = A * free[:, None] * free[None, :] + np.diag(1.0 - free)
    assert np.allclose(x.numpy(), np.linalg.solve(Am, b), rtol=1e-12, atol=0)
    assert stats.iterations == 1 and stats.converged
    want = np.linalg.norm(b - Am @ x.numpy()) / np.linalg.norm(b)
    assert stats.relative_residual == pytest.approx(want, rel=1e-6, abs=1e-16)


def test_masking_equals_reduction():
    nodes, elements = ft.mesh.box_hex_mesh(2, 2, 5, 0.1, 0.1, 0.5)
    fixed = ft.fix_where(nodes, lambda p: p[:, 2] == 0.0, 3)
    loads = np.zeros_like(nodes)
    loads[nodes[:, 2] == 0.5, 0] = 3.0
    E, nu = 5e6, 0.3
    scene = ftt.make_scene(nodes, elements, fixed, loads, ftt.Material(E, nu), dtype=torch.float64, device="cpu")
    sol = ftt.solve(scene, method="cg", tol=1e-12)
    K = assemble_sparse(nodes, elements, E, nu)
    u_oracle = solve_reduced(K, loads, fixed)
    scale = np.max(np.abs(u_oracle))
    assert np.max(np.abs(sol.displacements.numpy() - u_oracle)) < 1e-8 * scale
    r_oracle = (K @ u_oracle.reshape(-1)).reshape(loads.shape)
    assert np.allclose(sol.reactions.numpy(), r_oracle, rtol=1e-6, atol=1e-8 * np.max(np.abs(r_oracle)))


def test_prescribed_displacements():
    nodes, elements = ft.mesh.box_hex_mesh(2, 2, 4, 0.1, 0.1, 0.4)
    fixed = ft.fix_where(nodes, lambda p: (p[:, 2] == 0.0) | (p[:, 2] == 0.4), 3)
    prescribed = np.zeros_like(nodes)
    stretch = 1e-3
    prescribed[nodes[:, 2] == 0.4, 2] = stretch
    scene = ftt.make_scene(nodes, elements, fixed, np.zeros_like(nodes), ftt.Material(1e7, 0.0),
                           prescribed=prescribed, dtype=torch.float64, device="cpu")
    for method in ("cg", "dense"):
        u = ftt.solve(scene, method=method, tol=1e-12).displacements.numpy()
        assert np.max(np.abs(u[:, 2] - stretch * nodes[:, 2] / 0.4)) < 1e-8 * stretch / 1e-3
        assert np.max(np.abs(u[:, :2])) < 1e-9


def test_inverted_element_raises():
    nodes, elements = ft.mesh.box_hex_mesh(1, 1, 2, 0.1, 0.1, 0.2)
    elements = elements.copy()
    elements[0, [0, 1]] = elements[0, [1, 0]]  # invert one element
    fixed = ft.fix_where(nodes, lambda p: p[:, 2] == 0.0, 3)
    scene = ftt.make_scene(nodes, elements, fixed, np.zeros_like(nodes), ftt.Material(1e6, 0.3),
                           dtype=torch.float64, device="cpu")
    op = ftt.build_operator(scene, dtype=torch.float64, uniform=False)
    with pytest.raises(ValueError, match="Jacobian"):
        ftt.solve(scene, operator=op)
    with pytest.raises(ValueError, match="Jacobian"):
        ftt.solve(scene)


# -- the reference's demos ------------------------------------------------

@pytest.mark.parametrize("method", ["cg", "dense"])
def test_cubebeam_anchor_matches_jax(method):
    jsc, (nodes, elements, fixed, loads, mat) = cubebeam_scene()
    ref = ft.solve(jsc, method=method, tol=1e-8)
    sol = ftt.solve(port(jsc), method=method, tol=1e-8)
    u = sol.displacements.numpy()
    assert np.max(np.abs(u)) == pytest.approx(ANCHOR, rel=1e-3)
    assert abs(sol.stats.iterations - int(ref.stats.iterations)) <= 0.02 * int(ref.stats.iterations)
    assert sol.stats.converged and sol.stats.relative_residual <= 1e-8
    u_ref = np.asarray(ref.displacements)
    assert np.max(np.abs(u - u_ref)) <= 1e-6 * np.max(np.abs(u_ref))
    # equilibrium: the root reactions balance the applied +y load
    r = sol.reactions.numpy()
    root = nodes[:, 2] == 0.0
    assert r[root, 1].sum() + loads[~root, 1].sum() == pytest.approx(0.0, abs=1e-8 * np.abs(loads).sum())


def test_cubebeam_block_jacobi_and_f32_escape_hatch():
    jsc, _ = cubebeam_scene()
    jop = ft.build_operator(jsc, dtype=jnp.float64)
    ref = ft.solve_operator(jop, jsc.loads, jsc.prescribed_or_zero(jnp.float64), precondition="block", tol=1e-8)
    tsc = port(jsc)
    op = ftt.build_operator(tsc, dtype=torch.float64)
    sol = ftt.solve_operator(op, tsc.loads, tsc.prescribed_or_zero(torch.float64), precondition="block", tol=1e-8)
    assert sol.stats.converged
    assert abs(sol.stats.iterations - int(ref.stats.iterations)) <= 0.02 * int(ref.stats.iterations)
    u = ftt.solve_displacements(op, tsc.loads, tsc.prescribed_or_zero(torch.float64))
    assert np.max(np.abs(u.numpy())) == pytest.approx(ANCHOR, rel=1e-3)
    # f32 CG: the displacements hold to the anchor, the reported residual
    # is the f32 operator's own true residual, far above the recurrence's
    sc32 = port(jsc, torch.float32)
    with pytest.warns(RuntimeWarning, match="did not converge"):
        s32 = ftt.solve(sc32, method="cg", tol=1e-5)
    assert s32.displacements.dtype == torch.float32
    assert np.max(np.abs(s32.displacements.numpy())) == pytest.approx(ANCHOR, rel=1e-3)
    op32 = ftt.build_operator(sc32, dtype=torch.float32)
    b = op32.rhs(sc32.loads, sc32.prescribed_or_zero(torch.float32))
    r = (b - op32.apply(s32.displacements)).double()
    assert s32.stats.relative_residual == pytest.approx(float(r.norm() / b.double().norm()), rel=1e-6)


def test_tube_matches_oracle():
    jsc, (nodes, elements, fixed, loads, mat) = tube_scene(n_layers=10)
    sol = ftt.solve(port(jsc), method="cg", tol=1e-10, max_iters=50_000)
    K = assemble_sparse(nodes, elements, float(np.asarray(mat.E)), 0.3)
    u_oracle = solve_reduced(K, loads, fixed)
    assert np.max(np.abs(sol.displacements.numpy() - u_oracle)) < 1e-6 * np.max(np.abs(u_oracle))


def test_stress_recovery_uniaxial_bar():
    Lb, stretch, E = 1.0, 1e-3, 5e6
    nodes, elements = ft.mesh.box_hex_mesh(2, 2, 10, 0.1, 0.1, Lb)
    fixed = ft.fix_where(nodes, lambda p: (p[:, 2] == 0.0) | (p[:, 2] == Lb), 3)
    prescribed = np.zeros_like(nodes)
    prescribed[nodes[:, 2] == Lb, 2] = stretch
    scene = ftt.make_scene(nodes, elements, fixed, np.zeros_like(nodes), ftt.Material(E, 0.0),
                           prescribed=prescribed, dtype=torch.float64, device="cpu")
    sol = ftt.solve(scene, method="cg", tol=1e-12)
    _, sig, vm = ftt.post.hex8_stress(scene, sol.displacements)
    assert np.allclose(sig[:, 2].numpy(), E * stretch / Lb, rtol=1e-6)
    assert np.allclose(vm.numpy(), E * stretch / Lb, rtol=1e-6)


# -- beams (tests/test_beam.py) ------------------------------------------

BE, BI, BL, BQ = 210e9, 1e-6, 1.0, 1000.0


def beam_scene(n, fixed, loads=None):
    x = np.linspace(0.0, BL, n + 1)[:, None]
    el = np.stack([np.arange(n), np.arange(n) + 1], axis=1)
    loads = np.zeros((n + 1, 2)) if loads is None else loads
    return ftt.make_scene(x, el, fixed, loads, ftt.Material(BE, 0.0), family="eb_beam", section=np.float64(BI),
                          dtype=torch.float64, device="cpu")


def uniform_load(n):
    x = np.linspace(0.0, BL, n + 1)[:, None]
    el = np.stack([np.arange(n), np.arange(n) + 1], axis=1)
    fe = ftt.elements.beam.uniform_load_vector(torch.as_tensor(x), torch.as_tensor(el), BQ).numpy()
    loads = np.zeros((n + 1, 2))
    np.add.at(loads.reshape(-1), (el[:, :, None] * 2 + np.arange(2)).reshape(-1), fe.reshape(-1))
    want = np.asarray(jbeam.uniform_load_vector(jnp.asarray(x), jnp.asarray(el), BQ))
    assert np.allclose(fe, want, rtol=1e-15, atol=0)
    return loads


def ends_fixed(n):
    fixed = np.zeros((n + 1, 2), bool)
    fixed[0] = fixed[-1] = True
    return fixed


def test_beam_fixed_fixed_midspan_and_actions():
    n = 100
    scene = beam_scene(n, ends_fixed(n), uniform_load(n))
    sol = ftt.solve(scene)  # 202 DOF: the auto route is dense
    w = sol.displacements.numpy()[:, 0]
    assert w[n // 2] == pytest.approx(BQ * BL**4 / (384 * BE * BI), rel=1e-9)
    M0, _, V = (a.numpy() for a in ftt.post.beam_moment_shear(scene, sol.displacements))
    assert M0[0] == pytest.approx(BQ * BL**2 / 12, rel=1e-3)
    assert M0[n // 2] == pytest.approx(-BQ * BL**2 / 24, rel=1e-3)
    h = BL / n
    assert V[0] == pytest.approx(BQ * (h - BL) / 2, rel=1e-9)


def test_beam_cg_matches_dense_and_reactions_balance():
    n = 40
    scene = beam_scene(n, ends_fixed(n), uniform_load(n))
    sol_d = ftt.solve(scene, method="dense")
    # tol 1e-12 sits under this system's f64 floor of the true residual
    # (~1e-11): the port reports that, and the displacements are the check
    sol_c = ftt.solve(scene, method="cg", tol=1e-12, max_iters=5000, on_nonconverged="ignore")
    ud = sol_d.displacements.numpy()
    assert np.max(np.abs(ud - sol_c.displacements.numpy())) < 1e-9 * np.max(np.abs(ud))
    r = sol_d.reactions.numpy()
    free_load = BQ * BL - 2 * (BQ * (BL / n) / 2)
    assert r[0, 0] == pytest.approx(-free_load / 2, rel=1e-9)
    assert r[-1, 0] == pytest.approx(-free_load / 2, rel=1e-9)


def test_beam_cantilever_tip_load():
    n, P = 50, 750.0
    fixed = np.zeros((n + 1, 2), bool)
    fixed[0] = True
    loads = np.zeros((n + 1, 2))
    loads[-1, 0] = P
    w = ftt.solve(beam_scene(n, fixed, loads), method="dense").displacements.numpy()
    assert w[-1, 0] == pytest.approx(P * BL**3 / (3 * BE * BI), rel=1e-9)
    assert w[-1, 1] == pytest.approx(P * BL**2 / (2 * BE * BI), rel=1e-9)


# -- bars (tests/test_truss.py) ------------------------------------------

K_AX = 1000.0
TNODES = np.array([[0.0, 0.0], [0.0, 1.0], [1.0, 0.5]])
TMEMBERS = np.array([[0, 2], [1, 2]])


def truss_scenes(load=(0.0, -100.0)):
    fixed = np.zeros((3, 2), bool)
    fixed[0] = fixed[1] = True
    loads = np.zeros((3, 2))
    loads[2] = load
    jsc = ft.make_scene(TNODES, TMEMBERS, fixed, loads, ft.Material(1.0, 0.0), family="bar2d",
                        section=np.full(2, K_AX), dtype=jnp.float64)
    return jsc, port(jsc)


def test_truss_linear_statics_and_equilibrium():
    _, scene = truss_scenes()
    sol = ftt.solve(scene, method="dense")
    u = sol.displacements.numpy()
    assert u[2, 0] == pytest.approx(0.0, abs=1e-12)
    assert u[2, 1] == pytest.approx(-100.0 / (K_AX * 0.4), rel=1e-12)
    sol_c = ftt.solve(scene, method="cg", tol=1e-13)
    assert np.allclose(sol_c.displacements.numpy(), u, atol=1e-10)
    r = sol.reactions.numpy()
    assert r[:2, 1].sum() == pytest.approx(100.0, rel=1e-10)
    assert r[:2, 0].sum() == pytest.approx(0.0, abs=1e-9)


def test_newton_krylov_matches_jax():
    jsc, scene = truss_scenes()
    u, stats = ftt.solve_nonlinear(scene, tol=1e-12)
    u_ref, ref = ft.solve_nonlinear(jsc, tol=1e-12)
    assert stats.converged and stats.iterations == int(ref.iterations)
    assert np.allclose(u.numpy(), np.asarray(u_ref), rtol=1e-10, atol=1e-14)
    f_int = truss.internal_forces(scene.nodes, scene.elements, u, scene.section).numpy()
    assert np.linalg.norm(np.array([0.0, -100.0]) + f_int[2]) < 1e-8
    assert u[2, 1] < -0.25  # the geometric nonlinearity is real
    mf = ftt.post.truss_member_forces(scene, u).numpy()
    assert np.allclose(mf, np.asarray(ft.post.truss_member_forces(jsc, u_ref)), rtol=1e-9)


def test_newton_reduces_to_linear_for_small_loads():
    _, scene = truss_scenes((0.0, -1e-4))
    u_nl, stats = ftt.solve_nonlinear(scene, tol=1e-8)
    assert stats.converged
    assert np.allclose(u_nl.numpy(), ftt.solve(scene, method="dense").displacements.numpy(), rtol=1e-3, atol=1e-12)
    with pytest.raises(ValueError, match="bar scenes"):
        ftt.solve_nonlinear(beam_scene(4, ends_fixed(4)))


def test_bar3d_tripod():
    s32 = np.sqrt(3.0) / 2.0
    nodes = np.array([[1.0, 0.0, 0.0], [-0.5, s32, 0.0], [-0.5, -s32, 0.0], [0.0, 0.0, 1.0]])
    fixed = np.zeros((4, 3), bool)
    fixed[:3] = True
    loads = np.zeros((4, 3))
    loads[3, 2] = -50.0
    scene = ftt.make_scene(nodes, np.array([[0, 3], [1, 3], [2, 3]]), fixed, loads, ftt.Material(1.0, 0.0),
                           family="bar3d", section=np.full(3, K_AX), dtype=torch.float64, device="cpu")
    u = ftt.solve(scene, method="dense").displacements.numpy()
    assert abs(u[3, 0]) < 1e-9 and abs(u[3, 1]) < 1e-9
    assert u[3, 2] == pytest.approx(-50.0 / (1.5 * K_AX), rel=1e-9)


def test_checkpoint_round_trips_between_packages(tmp_path):
    jsc, _ = tube_scene(n_layers=3)
    scene = port(jsc)
    sol = ftt.solve(scene, method="cg", tol=1e-8)
    path = str(tmp_path / "port.npz")
    ftt.post.save_solution(path, scene, sol.displacements, sol.reactions)
    for load in (ftt.post.load_solution, ft.post.load_solution):
        data = load(path)
        assert np.array_equal(data["displacements"], sol.displacements.numpy())
        assert np.array_equal(data["elements"], np.asarray(jsc.elements))
        assert str(data["family"]) == "hex8" and float(data["E"]) == float(jsc.material.E)
    jpath = str(tmp_path / "jax.npz")
    _, bsc = truss_scenes()
    jsc_b, _ = truss_scenes()
    u = np.asarray(ft.solve(jsc_b, method="dense").displacements)
    ft.post.save_solution(jpath, jsc_b, u)
    data = ftt.post.load_solution(jpath)
    assert np.array_equal(data["section"], bsc.section.numpy()) and str(data["family"]) == "bar2d"


# -- the true residual and the f64 restart --------------------------------

def test_stats_report_the_true_residual_and_restart_in_f64(monkeypatch):
    """A recurrence that claims convergence early (a stand-in for f64
    drift) is caught by the true residual: an f64 operator restarts CG
    from u within the same budget, an f32 one reports and stops."""
    jsc, _ = cubebeam_scene()
    calls = []
    real = SOLVE.pcg

    def lying_first_call(apply, b, x0, **kw):
        calls.append(kw["max_iters"])
        if len(calls) == 1:
            x, st = real(apply, b, x0, **{**kw, "max_iters": 40})
            return x, ftt.SolveStats(st.iterations, 0.0, 0.0, True)
        return real(apply, b, x0, **kw)

    monkeypatch.setattr(SOLVE, "pcg", lying_first_call)
    for dtype, tol in ((torch.float64, 1e-8), (torch.float32, 1e-5)):
        calls.clear()
        scene = port(jsc, dtype)
        op = ftt.build_operator(scene, dtype=dtype)
        sol = ftt.solve_operator(op, scene.loads, scene.prescribed_or_zero(dtype), tol=tol, max_iters=2000)
        b = op.rhs(scene.loads, scene.prescribed_or_zero(dtype))
        r = (b - op.apply(sol.displacements)).double()
        true_rel = float(r.norm() / b.double().norm())
        assert sol.stats.relative_residual == pytest.approx(true_rel, rel=1e-9)
        if dtype == torch.float64:
            assert len(calls) == 2 and calls[1] == 2000 - 40
            assert sol.stats.converged and true_rel <= tol and sol.stats.iterations > 40
        else:
            assert len(calls) == 1 and sol.stats.iterations == 40 and not sol.stats.converged


# -- routing ---------------------------------------------------------------

class Taken(Exception):
    pass


@pytest.fixture
def spy_routes(monkeypatch):
    """solve_operator and the voxel route's FCG (the staged loop) raise
    Taken naming the route instead of solving."""
    def operator_route(op, loads, prescribed, *, method, **kw):
        raise Taken(f"solve_operator {method} {op.kind}")

    def voxel_route(*args, **kw):
        raise Taken("voxel multigrid")

    monkeypatch.setattr(SOLVE, "solve_operator", operator_route)
    monkeypatch.setattr(sys.modules["fea_tpu_torch.solve.staged"], "solve_operator_fpcg_staged", voxel_route)
    return monkeypatch


def box(nx, ny, nz):
    nodes, elements = ft.mesh.box_hex_mesh(nx, ny, nz, 0.1, 0.1, 0.5)
    fixed = ft.fix_where(nodes, lambda p: p[:, 2] == 0.0, 3)
    return ftt.make_scene(nodes, elements, fixed, np.ones_like(nodes), ftt.Material(1e7, 0.3),
                          dtype=torch.float64, device="cpu")


def test_small_scenes_route_to_dense_below_2000_dof_and_cg_above(spy_routes):
    small, larger = box(4, 4, 8), box(6, 6, 16)
    assert small.n_dof < 2000 <= larger.n_dof < SOLVE._STRUCTURED_MIN_DOF
    with pytest.raises(Taken, match="dense uniform"):
        ftt.solve(small)
    with pytest.raises(Taken, match="cg uniform"):
        ftt.solve(larger)
    x = np.linspace(0.0, 1.0, 1001)[:, None]
    beam = ftt.make_scene(x, np.stack([np.arange(1000), np.arange(1, 1001)], 1), np.zeros((1001, 2), bool),
                          np.zeros((1001, 2)), ftt.Material(1.0, 0.0), family="eb_beam", dtype=torch.float64,
                          device="cpu")
    spy_routes.setattr(SOLVE, "_STRUCTURED_MIN_DOF", 0)
    with pytest.raises(Taken, match="cg stored"):  # beams and bars never take a large-grid route
        ftt.solve(beam)


def test_explicit_method_and_operator_bypass_the_large_routes(spy_routes):
    spy_routes.setattr(SOLVE, "_STRUCTURED_MIN_DOF", 0)
    scene = box(4, 4, 8)
    with pytest.raises(Taken, match="voxel multigrid"):
        ftt.solve(scene)
    with pytest.raises(Taken, match="cg uniform"):
        ftt.solve(scene, method="cg")
    with pytest.raises(Taken, match="dense uniform"):
        ftt.solve(scene, method="dense")
    op = ftt.build_operator(scene, dtype=torch.float64, uniform=False)
    with pytest.raises(Taken, match="dense hex8_matfree"):
        ftt.solve(scene, operator=op)
    with pytest.raises(ValueError, match="unknown method"):
        ftt.solve(scene, method="gmres")


def test_unmatched_large_hex8_scene_takes_the_unstructured_chain_from_its_threshold(spy_routes):
    """A hex8 scene no grid route takes goes on to solve()'s tail, as in the
    reference: dense/CG under 2,000 DOF or under _BLOCK_PRECOND_MIN_DOF,
    the embedded / AMG / two-level chain above both; an explicit method
    bypasses the chain."""
    def chain(*args, **kw):
        raise Taken("unstructured chain")

    spy_routes.setattr(SOLVE, "_solve_unstructured_hex8", chain)
    spy_routes.setattr(SOLVE, "_STRUCTURED_MIN_DOF", 0)

    def l_scene(nx, nz):
        nodes, elements = ftt.mesh.l_hex_mesh(nx, nx, nz, 0.1, 0.1, 0.3)
        fixed = ftt.fix_where(nodes, lambda q: q[:, 2] == 0.0, 3)
        return ftt.make_scene(nodes, elements, fixed, np.ones_like(nodes), ftt.Material(1e7, 0.3),
                              dtype=torch.float64, device="cpu")

    small, large = l_scene(4, 6), l_scene(6, 18)
    assert small.n_dof < 2000 <= large.n_dof < SOLVE._BLOCK_PRECOND_MIN_DOF
    with pytest.raises(Taken, match="dense uniform"):
        ftt.solve(small)
    with pytest.raises(Taken, match="cg uniform"):
        ftt.solve(large)
    spy_routes.setattr(SOLVE, "_BLOCK_PRECOND_MIN_DOF", 0)
    with pytest.raises(Taken, match="dense uniform"):
        ftt.solve(small)
    with pytest.raises(Taken, match="unstructured chain"):
        ftt.solve(large)
    with pytest.raises(Taken, match="cg uniform"):
        ftt.solve(large, method="cg")


def test_smoke_yardstick_of_the_voxel_box_matches_jax():
    """chip_smoke.py's phase [9.2] holds the card's solve of the
    49,179-DOF voxel cantilever against JAX's iterations and max|u| on the
    same scene; both packages solve it here on the CPU."""
    import chip_smoke

    nx, ny, nz = chip_smoke.EBE_BOX
    lz = chip_smoke.EBE_LZ
    nodes, elements = ft.mesh.box_hex_mesh(nx, ny, nz, 0.1, 0.1, lz)
    fixed, loads, _ = scenes.cantilever_bcs(nodes, lz)
    mat = dict(E=10_000_000 * ft.units.psi, nu=0.3)
    jsc = ft.make_scene(nodes, elements, fixed, loads, ft.Material(**mat), dtype=jnp.float64)
    assert 2000 <= jsc.n_dof < SOLVE._STRUCTURED_MIN_DOF
    ref = ft.solve(jsc, tol=1e-8)
    assert int(ref.stats.iterations) == chip_smoke.EBE_JAX_ITERS
    assert np.max(np.abs(np.asarray(ref.displacements))) == pytest.approx(chip_smoke.EBE_MAX_U, rel=5e-4)
    sol = ftt.solve(port(jsc), tol=1e-8)
    assert sol.stats.converged
    assert abs(sol.stats.iterations - chip_smoke.EBE_JAX_ITERS) <= 0.02 * chip_smoke.EBE_JAX_ITERS
    u_ref = np.asarray(ref.displacements)
    assert np.max(np.abs(sol.displacements.numpy() - u_ref)) <= 1e-6 * np.max(np.abs(u_ref))


def test_smoke_yardstick_of_the_distorted_box_matches_jax():
    """chip_smoke.py's phase [9.3] holds the card's matfree solve of the
    distorted 49,179-DOF box against JAX's iteration count on the same
    scene; fea_tpu solves it here on the CPU."""
    import chip_smoke

    nodes, elements, _ = scenes.distorted_arrays(chip_smoke.EBE_BOX, chip_smoke.EBE_LZ)
    fixed, loads, _ = scenes.cantilever_bcs(nodes, chip_smoke.EBE_LZ)
    jsc = ft.make_scene(nodes, elements, fixed, loads, ft.Material(E=10_000_000 * ft.units.psi, nu=0.3),
                        dtype=jnp.float64)
    assert 2000 <= jsc.n_dof < SOLVE._STRUCTURED_MIN_DOF
    ref = ft.solve(jsc, tol=1e-8)
    assert bool(ref.stats.converged)
    assert int(ref.stats.iterations) == chip_smoke.EBE_DISTORTED_JAX_ITERS
