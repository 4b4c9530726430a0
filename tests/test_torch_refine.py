"""Port parity of mixed-precision refinement: ``fea_tpu_torch``'s
``solve_operator_refined`` (and ``pcg_refined``) against ``fea_tpu``'s on
the CPU, with the structured operator's diagonal it needs.

Tolerances: the diagonal within 1e-15 relative of JAX's (the same sums in
the same order); a refined solve converged, its true f64 residual under
its tol, its displacements within 1e-7 relative of an all-f64 solve (the
reference's own bound, tests/test_refine.py), its inner iterations in all
within 10% of JAX's and its outer steps within 1. The inner solve's f32
rounding differs between the packages (torch's plain stencil against
XLA's), so counts are compared within these bands, not equal.
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fea_tpu as ft
from fea_tpu.ops.structured import build_structured_operator as jax_structured
from fea_tpu.ops.structured import stencil_diag_grid as jax_diag_grid
from fea_tpu.solve import solve_operator_refined_host as jax_refined_host
from fea_tpu.solvers.refine import pcg_refined as jax_pcg_refined

import fea_tpu_torch as ftt
from fea_tpu_torch.dtypes import Policy
from fea_tpu_torch.ops.structured import build_structured_operator, stencil_diag_grid, stencil_diag_np
from fea_tpu_torch.solve import solve_operator_refined_host
from fea_tpu_torch.solvers import pcg, pcg_refined
from fea_tpu_torch.solvers.refine import pcg_refined_host
from torch_pin import one_torch_thread  # noqa: F401

sys.path.insert(0, __file__.rsplit("/", 1)[0])
from test_refine import slender_case  # noqa: E402

REFINED = dict(tol=1e-9, inner_tol=1e-2, inner_iters=3000)


def _port_scene(scene):
    return ftt.make_scene(
        np.asarray(scene.nodes), np.asarray(scene.elements), np.asarray(scene.fixed), np.asarray(scene.loads),
        ftt.Material(E=float(scene.material.E), nu=float(scene.material.nu)), dtype=torch.float64, device="cpu",
    )


class _Counted:
    """An operator whose ``apply`` calls are counted (the outer steps of a
    refined solve are its f64 applies less the first)."""

    def __init__(self, op):
        self.op, self.calls = op, 0

    def __getattr__(self, name):
        return getattr(self.op, name)

    def apply(self, x):
        self.calls += 1
        return self.op.apply(x)


def _jax_outers(op_hi, op_lo, b, **kw):
    """(outer steps, inner total) of the reference's pcg_refined, its f64
    applies counted by a host callback."""
    calls = [0]

    def apply_hi(x):
        jax.debug.callback(lambda: calls.__setitem__(0, calls[0] + 1))
        return op_hi.apply(x)

    run = jax.jit(lambda b: jax_pcg_refined(apply_hi, op_lo.apply, b, None, precond_diag_lo=op_lo.diag_masked(),
                                            **kw))
    _, stats = run(b)
    jax.effects_barrier()
    return calls[0] - 1, int(stats.iterations)


@pytest.fixture(scope="module")
def slender():
    scene, dims = slender_case(4, 4, 32)
    op_hi = jax_structured(scene, dims, dtype=jnp.float64)
    op_lo = op_hi.astype(jnp.float32)
    presc = scene.prescribed_or_zero(jnp.float64)
    ref = ft.solve_operator(op_hi, scene.loads, presc, tol=1e-12, max_iters=30000)
    b = op_hi.rhs(scene.loads, presc)
    outers, inner = _jax_outers(op_hi, op_lo, b, **REFINED)
    tscene = _port_scene(scene)
    return dict(scene=scene, dims=dims, op_hi=op_hi, op_lo=op_lo, u_f64=np.asarray(ref.displacements),
                jax_outers=outers, jax_inner=inner, tscene=tscene,
                top_hi=build_structured_operator(tscene, dims, dtype=torch.float64))


@pytest.mark.parametrize("name", ["solve_operator_refined", "solve_operator_refined_host"])
def test_refined_matches_jax_on_the_slender_voxel_case(slender, name):
    jax_fn = ft.solve_operator_refined if name == "solve_operator_refined" else jax_refined_host
    port_fn = ftt.solve_operator_refined if name == "solve_operator_refined" else solve_operator_refined_host
    s = slender
    scene, tscene = s["scene"], s["tscene"]
    jsol = jax_fn(s["op_hi"], s["op_lo"], scene.loads, scene.prescribed_or_zero(jnp.float64), **REFINED)
    assert int(jsol.stats.iterations) == s["jax_inner"]  # the counted run is the reference's solve

    op_hi = _Counted(s["top_hi"])
    sol = port_fn(op_hi, s["top_hi"].astype(torch.float32), tscene.loads, tscene.prescribed_or_zero(torch.float64),
                  **REFINED)
    assert sol.stats.converged
    u = sol.displacements.numpy()
    b = s["top_hi"].rhs(tscene.loads, tscene.prescribed_or_zero(torch.float64))
    r = b - s["top_hi"].apply(sol.displacements)
    true_rel = float(r.norm() / b.norm())
    assert true_rel < 1e-9
    assert sol.stats.relative_residual < 1e-9
    assert np.max(np.abs(u - s["u_f64"])) < 1e-7 * np.max(np.abs(s["u_f64"]))
    assert abs(sol.stats.iterations - s["jax_inner"]) <= 0.1 * s["jax_inner"]
    assert abs((op_hi.calls - 1) - s["jax_outers"]) <= 1
    # the reactions are K u over all DOFs, through the f64 operator
    assert torch.allclose(sol.reactions, s["top_hi"].apply_raw(sol.displacements), rtol=0, atol=1e-12)


@pytest.mark.parametrize("dims", [(4, 4, 32), (3, 2, 5), (1, 1, 1)])
def test_structured_diagonal_matches_jax(dims):
    mat = ft.Material(E=10_000_000 * ft.units.psi, nu=0.3)
    nodes, elements = ft.mesh.box_hex_mesh(*dims, 0.05, 0.04, 0.3)
    fixed = ft.fix_where(nodes, lambda p: p[:, 2] == 0.0, 3)
    scene = ft.make_scene(nodes, elements, fixed, np.zeros_like(nodes), mat, dtype=jnp.float64)
    jop = jax_structured(scene, dims, dtype=jnp.float64)
    top = build_structured_operator(_port_scene(scene), dims, dtype=torch.float64)
    ke = np.asarray(jop.ke)
    want = np.asarray(jax_diag_grid(jop.ke, dims))
    for got in (stencil_diag_grid(torch.tensor(ke), dims).numpy(), stencil_diag_np(ke, dims),
                top.diag_raw().numpy().reshape(want.shape)):
        assert np.max(np.abs(got - want)) <= 1e-15 * np.max(np.abs(want))
    want_m = np.asarray(jop.diag_masked())
    assert np.max(np.abs(top.diag_masked().numpy() - want_m)) <= 1e-15 * np.max(np.abs(want_m))
    # f32: the cast operator sums its rounded Ke, as the reference's does
    lo = top.astype(torch.float32).diag_masked()
    want_lo = np.asarray(jop.astype(jnp.float32).diag_masked())
    assert lo.dtype == torch.float32 and np.array_equal(lo.numpy(), want_lo)
    assert top.dofs_per_node == 3


def test_refined_on_the_uniform_element_operator():
    """K7's route on the card: the uniform element operator in f64 and its
    f32 cast, against the reference on the same scene."""
    mat = ft.Material(E=10_000_000 * ft.units.psi, nu=0.3)
    nodes, elements = ft.mesh.box_hex_mesh(3, 3, 16, 0.06, 0.06, 0.5)
    fixed = ft.fix_where(nodes, lambda p: p[:, 2] == 0.0, 3)
    loads = np.zeros_like(nodes)
    tip = nodes[:, 2] == 0.5
    loads[tip, 1] = 1.0 / tip.sum()
    scene = ft.make_scene(nodes, elements, fixed, loads, mat, dtype=jnp.float64)
    jop = ft.build_operator(scene, dtype=jnp.float64)
    assert jop.kind == "uniform"
    presc = scene.prescribed_or_zero(jnp.float64)
    outers, inner = _jax_outers(jop, jop.astype(jnp.float32), jop.rhs(scene.loads, presc), tol=1e-10)
    ref = ft.solve_operator(jop, scene.loads, presc, tol=1e-12, max_iters=30000)

    tscene = _port_scene(scene)
    top = ftt.build_operator(tscene, dtype=torch.float64)
    assert top.kind == "uniform"
    counted = _Counted(top)
    sol = ftt.solve_operator_refined(counted, top.astype(torch.float32), tscene.loads,
                                     tscene.prescribed_or_zero(torch.float64), tol=1e-10)
    assert sol.stats.converged and sol.stats.relative_residual <= 1e-10
    u_ref = np.asarray(ref.displacements)
    assert np.max(np.abs(sol.displacements.numpy() - u_ref)) < 1e-8 * np.max(np.abs(u_ref))
    assert abs(sol.stats.iterations - inner) <= 0.1 * inner
    assert abs((counted.calls - 1) - outers) <= 1


def _small_case():
    mat = ftt.Material(E=1e7, nu=0.3)
    scene, dims = ftt.ops.structured.structured_scene(2, 2, 8, 0.1, 0.1, 0.8, mat, dtype=torch.float64,
                                                      device="cpu")
    nodes = scene.host_nodes
    loads = np.zeros_like(nodes)
    loads[nodes[:, 2] == 0.8, 1] = 1.0
    scene = ftt.make_scene(nodes, scene.host_elements, scene.fixed.numpy(), loads, mat, dtype=torch.float64,
                           device="cpu")
    op_hi = build_structured_operator(scene, dims, dtype=torch.float64)
    return scene, op_hi, op_hi.rhs(scene.loads, scene.prescribed_or_zero(torch.float64))


@pytest.mark.parametrize("refiner", [pcg_refined, pcg_refined_host])
@pytest.mark.parametrize("breakage", ["nan", "negated"])
def test_refinement_survives_broken_inner_solver(refiner, breakage):
    """tests/test_guards.py's case: a broken inner operator gives converged
    False, a finite x and a residual no larger than ||b||."""
    _, op_hi, b = _small_case()
    if breakage == "nan":
        apply_lo = lambda x: torch.full_like(x, float("nan"))  # noqa: E731
    else:
        apply_lo = lambda x: -op_hi.apply(x.to(torch.float64)).to(x.dtype)  # noqa: E731
    x, stats = refiner(op_hi.apply, apply_lo, b, tol=1e-9, max_outer=10, inner_tol=1e-2, inner_iters=50)
    assert not stats.converged
    assert bool(torch.isfinite(x).all())
    assert stats.residual_norm <= float(b.norm()) * (1 + 1e-12)


def test_refinement_line_search_still_converges_healthy():
    _, op_hi, b = _small_case()
    op_lo = op_hi.astype(torch.float32)
    x, stats = pcg_refined(op_hi.apply, op_lo.apply, b, precond_diag_lo=op_lo.diag_masked(), tol=1e-9,
                           max_outer=20, inner_tol=1e-2, inner_iters=2000)
    assert stats.converged
    r = b - op_hi.apply(x)
    assert float(r.norm() / b.norm()) < 1e-9


def test_pcg_policy():
    """``policy=None`` is f64 accumulation in b's dtype, bit for bit the
    explicit policy; an all-f32 policy cannot reach the f64 residual that
    refinement reaches (tests/test_refine.py::test_f32_only_cg_is_insufficient_here)."""
    scene, dims = slender_case(4, 4, 32)
    tscene = _port_scene(scene)
    op_hi = build_structured_operator(tscene, dims, dtype=torch.float64)
    op_lo = op_hi.astype(torch.float32)
    b32 = op_lo.rhs(tscene.loads.to(torch.float32), torch.zeros_like(tscene.loads, dtype=torch.float32))
    x_none, st_none = pcg(op_lo.apply, b32, precond_diag=op_lo.diag_masked(), tol=1e-6, max_iters=500)
    x_pol, st_pol = pcg(op_lo.apply, b32, precond_diag=op_lo.diag_masked(), tol=1e-6, max_iters=500,
                        policy=Policy(compute=torch.float32, accum=torch.float64))
    assert st_none == st_pol and torch.equal(x_none, x_pol)
    assert ftt.default_policy() == Policy(compute=torch.float32, accum=torch.float64, index=torch.int32)

    x32, _ = pcg(op_lo.apply, b32, precond_diag=op_lo.diag_masked(), tol=1e-10, max_iters=8000,
                 policy=Policy(compute=torch.float32, accum=torch.float32))
    b64 = op_hi.rhs(tscene.loads, torch.zeros_like(tscene.loads))
    r = b64 - op_hi.apply(x32.to(torch.float64))
    assert float(r.norm() / b64.norm()) > 1e-9
