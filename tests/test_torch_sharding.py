"""Port parity, the decompositions of ``fea_tpu_torch.parallel``: element
shards, sharded sweeps, and z-slab shards of the voxel, curvilinear and
extruded pipelines, against the JAX package's ``fea_tpu.parallel`` on
conftest's 8 virtual CPU devices and against the port unsharded, on the
CPU; and the seven modes of ``fea_tpu_torch.dryrun``.

Every device of a shard list is "cpu" here: a list may repeat a device, so
this runs every line of a decomposition in one process. The scenes are
the reference tests' (tests/test_sharding.py's 2x2x6 box,
tests/test_curv_sharding.py's distorted grids, tests/test_extruded.py's
8-segment tube), with hierarchies chosen to take each path of the sharded
V-cycles: one level (all of it replicated), y and x coarsened under a
z that is not (the shards keep their planes), all three coarsened, and z
alone over three levels (two sharded levels). The reference's sharding
needs the node count (curvilinear: the plane count) to divide by its
device count, so it is compared where that holds: 8 devices on the
box's 24 elements, 7 on the matfree box (uneven padding), 32 planes of
the 8x8x31 grid, 16 of the 2x2x15 box. Inputs are made with numpy from a seed.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fea_tpu as ft
import fea_tpu.ops.curvilinear as jcv
from fea_tpu.ops.extruded import extruded_scene_tube as jax_tube
from fea_tpu.ops.structured import build_structured_operator as jax_build_structured
from fea_tpu.ops.structured import structured_scene as jax_structured_scene
from fea_tpu.parallel import make_device_mesh as jax_mesh
from fea_tpu.parallel import shard_curvilinear as jax_shard_curvilinear
from fea_tpu.parallel import shard_extruded as jax_shard_extruded
from fea_tpu.parallel import shard_operator as jax_shard_operator
from fea_tpu.parallel import shard_structured_operator as jax_shard_structured
from fea_tpu.solve import build_extruded as jax_build_extruded
from fea_tpu.solve import solve_extruded as jax_solve_extruded
from fea_tpu.solve import solve_operator_fpcg as jax_fpcg

import fea_tpu_torch as ftt
from fea_tpu_torch import dryrun
from fea_tpu_torch.ops import cuda_varstencil
from fea_tpu_torch.ops import curvilinear as cv
from fea_tpu_torch.ops.extruded import extruded_scene_tube
from fea_tpu_torch.ops.multigrid import build_multigrid
from fea_tpu_torch.ops.structured import build_structured_operator
from fea_tpu_torch.parallel import (
    ShardedOperator,
    Shards,
    make_device_mesh,
    replicated_precond,
    shard_curvilinear,
    shard_extruded,
    shard_operator,
    shard_structured_operator,
    sharded_sweep,
)
from fea_tpu_torch.parallel import curv as pcurv
from fea_tpu_torch.parallel import extruded as pext
from fea_tpu_torch.solve import solve_displacements, solve_operator, solve_operator_fpcg
from torch_pin import one_torch_thread  # noqa: F401

TOL = 1e-8
BOUND = {torch.float64: 1e-12, torch.float32: 1e-5}  # f64 rounding, f32 rounding of the f32 operator


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _cpu(n):
    return make_device_mesh(n, device="cpu")


# -- the device list and Shards ---------------------------------------------------


def test_make_device_mesh_round_robin(monkeypatch):
    """CPU entries on request; otherwise round-robin over the visible
    cards from the given card (one card repeats); no card, no CPU
    fallback."""
    assert make_device_mesh(3, device="cpu") == [torch.device("cpu")] * 3
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert make_device_mesh(5) == [torch.device("cuda", i % 2) for i in range(5)]
    assert make_device_mesh() == [torch.device("cuda", 0), torch.device("cuda", 1)]
    assert make_device_mesh(3, device="cuda:1") == [torch.device("cuda", i % 2) for i in (1, 2, 3)]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        make_device_mesh(4)


def test_shards_division_comparison_and_where():
    """What ``pcg``'s Jacobi set-up and the extruded smoother ask of a
    vector beyond the z-sharded solve's arithmetic: ``/``, ``>``, ``torch.where`` and
    ``torch.ones_like``, shard by shard."""
    rng = np.random.default_rng(30)
    a = Shards(torch.as_tensor(rng.normal(size=(2, 3, 3))) for _ in range(3))
    pos = a > 0
    got = torch.where(pos, 1.0 / torch.where(pos, a, torch.ones_like(a)), torch.ones_like(a))
    want = [torch.where(x > 0, 1.0 / x, torch.ones_like(x)) for x in a]
    assert isinstance(got, Shards) and all(torch.equal(g, w) for g, w in zip(got, want))
    assert all(torch.equal(g, x / 4.0) for g, x in zip(a / 4.0, a))


# -- element decomposition --------------------------------------------------------


@pytest.fixture(scope="module")
def box():
    """tests/test_sharding.py's 2x2x6 box (24 elements): z = 0 fixed, a
    +y load on the tip face; and a random state."""
    nodes, elements = ftt.mesh.box_hex_mesh(2, 2, 6, 0.1, 0.1, 0.6)
    fixed = ftt.fix_where(nodes, lambda p: p[:, 2] == 0.0, 3)
    loads = np.zeros_like(nodes)
    loads[nodes[:, 2] == 0.6, 1] = 2.0
    x = np.random.default_rng(31).normal(size=nodes.shape)
    return nodes, elements, fixed, loads, x


def _box_scene(box):
    nodes, elements, fixed, loads, _ = box
    return ftt.make_scene(nodes, elements, fixed, loads, ftt.Material(1e7, 0.3), dtype=torch.float64, device="cpu")


def _box_op(box, kind, dtype=torch.float64):
    op = ftt.build_operator(_box_scene(box), dtype=dtype, uniform=kind == "uniform")
    if kind == "stored":
        op = dataclasses.replace(op, kind="stored", ke=op.element_matrices().contiguous(), geom=None, material=None)
    return op


@pytest.fixture(scope="module")
def jax_box(box):
    """The reference's sharded applies and diagonals (uniform on 8
    devices, matfree on 7: 24 elements padded to 28) and its sharded CG."""
    nodes, elements, fixed, loads, x = box
    sc = ft.make_scene(nodes, elements, fixed, loads, ft.Material(1e7, 0.3), dtype=jnp.float64)
    out = {}
    for kind, n in (("uniform", 8), ("matfree", 7)):
        sop = jax_shard_operator(ft.build_operator(sc, dtype=jnp.float64, uniform=kind == "uniform"), jax_mesh(n))
        out[kind] = (np.asarray(sop.apply_raw(jnp.asarray(x))), np.asarray(sop.diag_raw()))
    sop = jax_shard_operator(ft.build_operator(sc, dtype=jnp.float64), jax_mesh(8))
    sol = ft.solve_operator(sop, sc.loads, sc.prescribed_or_zero(jnp.float64), tol=TOL)
    out["solve"] = (int(sol.stats.iterations), np.asarray(sol.displacements))
    return out


@pytest.mark.parametrize("n", [2, 3, 4, 7, 8])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("kind", ["uniform", "matfree", "stored"])
def test_element_apply_matches_jax_and_unsharded(box, jax_box, kind, dtype, n):
    """The shards' partial K u and diagonal, summed in shard order, against
    the reference's sharded operator (the same K whatever the kind) and
    the port unsharded: 1e-12 relative in f64, 1e-5 in f32. Every shard
    holds ceil(24 / n) elements, the last ones padded with inert copies."""
    op = _box_op(box, "hex8_matfree" if kind == "matfree" else kind, dtype)
    sop = shard_operator(op, _cpu(n))
    assert isinstance(sop, ShardedOperator) and sop.dtype == dtype and sop.kind == op.kind
    assert all(s.elements.shape[0] == -(-24 // n) and s.plan is None for s in sop.shards)
    x = torch.as_tensor(box[4]).to(dtype)
    got, d_got = sop.apply_raw(x), sop.diag_raw()
    ref_apply, ref_diag = jax_box["uniform" if kind == "uniform" else "matfree"]
    assert _rel(got, ref_apply) <= BOUND[dtype]
    assert _rel(d_got, ref_diag) <= BOUND[dtype]
    assert _rel(got, op.apply_raw(x)) <= BOUND[dtype]
    assert _rel(sop.diag_masked(), op.diag_masked()) <= BOUND[dtype]


@pytest.mark.parametrize("n", [2, 7, 8])
@pytest.mark.parametrize("kind", ["uniform", "matfree", "stored"])
def test_element_solve_matches_jax_and_unsharded(box, jax_box, kind, n):
    """``solve_operator`` (Jacobi CG) on the sharded operator: iterations
    within 1 of the port unsharded and of the reference's sharded solve, a
    true f64 residual <= tol (recomputed by the unsharded operator), and
    displacements within 10 tol of both."""
    sc = _box_scene(box)
    op = _box_op(box, "hex8_matfree" if kind == "matfree" else kind)
    zero = sc.prescribed_or_zero(torch.float64)
    one = solve_operator(op, sc.loads, zero, tol=TOL)
    sol = solve_operator(shard_operator(op, _cpu(n)), sc.loads, zero, tol=TOL)
    jax_iters, jax_u = jax_box["solve"]
    assert sol.stats.converged
    assert abs(sol.stats.iterations - one.stats.iterations) <= 1
    assert abs(sol.stats.iterations - jax_iters) <= 1
    b = op.rhs(sc.loads, zero)
    r = b - op.apply(sol.displacements)
    assert float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(b)) <= TOL
    assert _rel(sol.displacements, one.displacements) <= 10 * TOL
    assert _rel(sol.displacements, jax_u) <= 10 * TOL
    assert _rel(sol.reactions, op.apply_raw(sol.displacements)) <= 1e-12


@pytest.mark.parametrize("n", [2, 4, 8])
def test_sharded_sweep_is_linear(box, n):
    """tests/test_sharding.py's sweep: 8 load cases scaled 1..8, one block
    a device; case i is i + 1 times case 0, and case 0 is the single
    solve of its loads."""
    sc = _box_scene(box)
    op = _box_op(box, "matfree")
    zero = sc.prescribed_or_zero(torch.float64)
    batch = torch.arange(1.0, 9.0, dtype=torch.float64)[:, None, None] * sc.loads[None]
    u = sharded_sweep(lambda loads: solve_displacements(op, loads, zero, tol=1e-11), batch, _cpu(n))
    assert u.shape == (8,) + tuple(sc.loads.shape)
    for i in range(1, 8):
        assert np.allclose(u[i].numpy(), (i + 1) * u[0].numpy(), rtol=1e-7)
    assert torch.equal(u[0], solve_displacements(op, sc.loads, zero, tol=1e-11))
    pair = sharded_sweep(lambda a: (a["x"] * 2.0, a["y"]), {"x": batch, "y": batch[:, :1]}, _cpu(n))
    assert torch.equal(pair[0], 2.0 * batch) and torch.equal(pair[1], batch[:, :1])


def test_sharded_sweep_rejects_a_batch_the_devices_do_not_divide():
    with pytest.raises(ValueError, match="divisible"):
        sharded_sweep(lambda a: a, torch.zeros(8, 3), _cpu(3))
    with pytest.raises(ValueError, match="same leading batch"):
        sharded_sweep(lambda a: a, (torch.zeros(4, 3), torch.zeros(2, 3)), _cpu(2))


# -- the voxel operator on z slabs -------------------------------------------------


@pytest.fixture(scope="module")
def voxel_box():
    """A 2x2x15 voxel cantilever (16 node planes, so the reference's 8
    devices divide its nodes) and the reference's sharded Jacobi CG."""
    mat = ft.Material(6.9e10, 0.3)
    jsc, dims = jax_structured_scene(2, 2, 15, 0.1, 0.1, 1.0, mat, dtype=jnp.float64)
    nodes = np.asarray(jsc.nodes)
    loads = np.zeros_like(nodes)
    loads[nodes[:, 2] == 1.0, 1] = 1.0
    fixed = np.asarray(jsc.fixed)
    jsc = ft.make_scene(nodes, np.asarray(jsc.elements), fixed, loads, mat, dtype=jnp.float64)
    jop, con = jax_shard_structured(jax_build_structured(jsc, dims, dtype=jnp.float64), jax_mesh(8))
    jsol = ft.solve_operator(jop, con(jsc.loads), con(jsc.prescribed_or_zero(jnp.float64)), method="cg",
                             tol=TOL, max_iters=2000)
    sc = ftt.make_scene(nodes, np.asarray(jsc.elements), fixed, loads, ftt.Material(6.9e10, 0.3),
                        dtype=torch.float64, device="cpu")
    return sc, dims, int(jsol.stats.iterations), np.asarray(jsol.displacements)


@pytest.mark.parametrize("n", [2, 3, 8])
def test_structured_shards_solve_matches_jax_and_unsharded(voxel_box, n):
    """``shard_structured_operator``: Jacobi CG through ``solve_operator``
    within 1 iteration of the reference's sharded CG and of the port's
    element-by-element operator of the same K (whose diagonal the shards'
    ``diag_masked`` is); and f64 FCG with the unsharded V-cycle beside the
    shards (``replicated_precond``, dry-run mode 4) within 1 iteration of
    the unsharded FCG. Displacements within 10 tol, results (N, 3) again
    after ``gather``."""
    sc, dims, jax_iters, jax_u = voxel_box
    op = build_structured_operator(sc, dims, dtype=torch.float64)
    op_s, constrain = shard_structured_operator(op, _cpu(n))
    assert op_s.z_local == -(-16 // n) and len(op_s.free) == n
    ebe = ftt.build_operator(sc, dtype=torch.float64)
    assert _rel(op_s.gather(op_s.diag_masked()), ebe.diag_masked()) <= 1e-13
    zero = sc.prescribed_or_zero(torch.float64)
    sol = solve_operator(op_s, constrain(sc.loads), constrain(zero), method="cg", tol=TOL, max_iters=2000)
    one = solve_operator(ebe, sc.loads, zero, method="cg", tol=TOL, max_iters=2000)
    u = op_s.gather(sol.displacements)
    assert sol.stats.converged and u.shape == sc.loads.shape
    assert abs(sol.stats.iterations - jax_iters) <= 1 and abs(sol.stats.iterations - one.stats.iterations) <= 1
    assert _rel(u, jax_u) <= 10 * TOL and _rel(u, one.displacements) <= 10 * TOL
    mg = build_multigrid(op.astype(torch.float32), dtype=torch.float32, coarse_dof_limit=100)
    f_one = solve_operator_fpcg(op, sc.loads, zero, mg, tol=TOL)
    f_sh = solve_operator_fpcg(op_s, constrain(sc.loads), constrain(zero), replicated_precond(op_s, mg), tol=TOL)
    assert f_sh.stats.converged and abs(f_sh.stats.iterations - f_one.stats.iterations) <= 1
    assert _rel(op_s.gather(f_sh.displacements), f_one.displacements) <= 10 * TOL


# -- curvilinear -------------------------------------------------------------------

# name -> element counts; the comments name the path of the sharded V-cycle
CURV = {
    "4x4x15": (4, 4, 15),  # one level: the V-cycle is the dense inverse, all replicated
    "8x8x31": (8, 8, 31),  # y and x coarsened, z (odd) kept: one sharded level
    "8x8x32": (8, 8, 32),  # all three coarsened: one sharded level
    "5x5x96": (5, 5, 96),  # z alone, three levels: two sharded levels
}
CURV_SHARDED_LEVELS = {"4x4x15": 0, "8x8x31": 1, "8x8x32": 1, "5x5x96": 2}


def _distorted(nx, ny, nz, seed=11, amp=0.2):
    """tests/test_curv_sharding.py's scene: a 0.4 x 0.5 x 2.0 box, interior
    nodes moved by 0.2 h U(-1, 1), z = 0 fixed, a +y load of 3 on the tip."""
    nodes, elements = ftt.mesh.box_hex_mesh(nx, ny, nz, 0.4, 0.5, 2.0)
    rng = np.random.default_rng(seed)
    h = np.array([0.4 / nx, 0.5 / ny, 2.0 / nz])
    interior = (nodes[:, 2] > 1e-12) & (nodes[:, 2] < 2.0 - 1e-12)
    nodes = nodes + amp * h * rng.uniform(-1, 1, nodes.shape) * interior[:, None]
    fixed = np.zeros_like(nodes)
    fixed[np.abs(nodes[:, 2]) < 1e-9] = 1.0
    loads = np.zeros_like(nodes)
    tip = nodes[:, 2] == nodes[:, 2].max()
    loads[tip, 1] = 3.0 / tip.sum()
    return nodes, elements, fixed, loads


@pytest.fixture(scope="module")
def curv():
    """The port's scene, operator and hierarchy of each CURV grid."""
    out = {}
    for name, dims in CURV.items():
        nodes, elements, fixed, loads = _distorted(*dims)
        sc = ftt.make_scene(nodes, elements, fixed, loads, ftt.Material(2e9, 0.3), dtype=torch.float64, device="cpu")
        op = cv.build_curv_operator(sc, dims)
        mg = cv.build_curv_multigrid(op.w, dims, 1.0 - fixed, degree=2)
        out[name] = (sc, op, mg)
    return out


@pytest.fixture(scope="module")
def jax_curv():
    """The reference's ``shard_curvilinear`` of 8x8x31 on 8 devices: its
    sharded apply of a random state and its sharded FCG solve."""
    nodes, elements, fixed, loads = _distorted(*CURV["8x8x31"])
    sc = ft.make_scene(nodes, elements, fixed, loads, ft.Material(2e9, 0.3), dtype=jnp.float64)
    dims = jcv.infer_topo_dims(sc)
    op = jcv.build_curv_operator(sc, dims, dtype=jnp.float64)
    mg = jcv.build_curv_multigrid(nodes, dims, 1.0 - fixed, sc.material, w0=op.w, degree=2)
    op_s, mg_s, con = jax_shard_curvilinear(op, mg, jax_mesh(8))
    x = np.random.default_rng(32).normal(size=nodes.shape)
    zero = sc.prescribed_or_zero(jnp.float64)
    sol = jax_fpcg(op_s, con(sc.loads), con(zero), mg_s, tol=TOL, max_iters=120)
    return x, np.asarray(op_s.apply_raw(con(jnp.asarray(x)))), int(sol.stats.iterations), np.asarray(sol.displacements)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
def test_curv_slab_plain_matches_whole_grid(curv, n, dtype):
    """The slab plain version (K4-slab / K5-slab's) on each shard's own
    weights and halo-extended state, against ``curv_apply_grid`` of the
    whole grid: the same multiply-adds, 1e-14 (f64) and 1e-6 (f32) of
    max|K u|; padding planes come out 0."""
    _, op, _ = curv["8x8x32"]
    w = op.w.to(dtype)
    Z, Y, X = op.grid_shape
    zl = -(-Z // n)
    g = torch.as_tensor(np.random.default_rng(33).normal(size=(Z, Y, X, 3))).to(dtype)
    g_pad = torch.zeros((n * zl + 2, Y, X, 3), dtype=dtype)
    g_pad[1 : Z + 1] = g
    slabs = pcurv._weight_slabs(w, _cpu(n), zl)
    got = torch.cat([cuda_varstencil.var_apply_slab(s, g_pad[i * zl : i * zl + zl + 2]) for i, s in enumerate(slabs)])
    want = cv.curv_apply_grid(w, g)
    assert got.shape == (n * zl, Y, X, 3) and torch.count_nonzero(got[Z:]) == 0
    assert _rel(got[:Z], want) <= (1e-14 if dtype == torch.float64 else 1e-6)


def test_var_apply_slab_checks_its_arguments():
    w = torch.zeros((27, 3, 3, 4, 2, 3), dtype=torch.float64)
    with pytest.raises(ValueError, match="weights must be"):
        cuda_varstencil.var_apply_slab(w, torch.zeros((4, 2, 3, 3), dtype=torch.float64))  # no halo planes
    with pytest.raises(TypeError, match="weights are"):
        cuda_varstencil.var_apply_slab(w, torch.zeros((6, 2, 3, 3), dtype=torch.float32))
    with pytest.raises(ValueError, match="Z >= 1"):
        cuda_varstencil.var_apply_slab(w, torch.zeros((2, 2, 3, 3), dtype=torch.float64))
    assert cuda_varstencil.var_apply_slab(w, torch.ones((6, 2, 3, 3), dtype=torch.float64)).shape == (4, 2, 3, 3)


@pytest.mark.parametrize("n", [2, 3, 4, 8])
def test_curv_apply_matches_jax_and_unsharded(curv, jax_curv, n):
    """The sharded f64 apply (raw and masked) of a random state against the
    port unsharded (1e-13) and the reference's sharded apply (1e-12)."""
    _, op, mg = curv["8x8x31"]
    op_s, _, constrain = shard_curvilinear(op, mg, _cpu(n))
    x_np, jax_ax, _, _ = jax_curv
    x = torch.as_tensor(x_np)
    got = op_s.gather(op_s.apply_raw(constrain(x)))
    assert _rel(got, op.apply_raw(x)) <= 1e-13 and _rel(got, jax_ax) <= 1e-12
    assert _rel(op_s.gather(op_s.apply(constrain(x))), op.apply(x)) <= 1e-13


@pytest.mark.parametrize("n", [2, 3, 8])
@pytest.mark.parametrize("name", list(CURV))
def test_curv_vcycle_matches_unsharded(curv, name, n):
    """One sharded V-cycle of a random f32 residual against the unsharded
    ``CurvMultigrid``: the same operations level by level, within f32
    rounding (1e-5 of max|z|) on every path of the hierarchy."""
    sc, op, mg = curv[name]
    op_s, mg_s, constrain = shard_curvilinear(op, mg, _cpu(n))
    assert len(mg_s.levels) == CURV_SHARDED_LEVELS[name]
    assert len(mg_s.rest.levels) == len(mg.levels) - CURV_SHARDED_LEVELS[name]
    r = (torch.as_tensor(np.random.default_rng(34).normal(size=(sc.n_nodes, 3))) * op.free).to(torch.float32)
    want = mg(r)
    got = op_s.gather(mg_s(constrain(r)))
    assert got.dtype == torch.float32 and _rel(got, want) <= 1e-5


@pytest.mark.parametrize("name, n", [("8x8x31", 2), ("8x8x31", 8), ("5x5x96", 3)])
def test_curv_solve_matches_jax_and_unsharded(curv, jax_curv, name, n):
    """The sharded f64 FCG (``solve_operator_fpcg`` on Shards) within 1
    iteration of the port unsharded and, on 8x8x31, of the reference's
    sharded solve; a true f64 residual <= tol recomputed by the unsharded
    operator; displacements and reactions within 10 tol."""
    sc, op, mg = curv[name]
    op_s, mg_s, constrain = shard_curvilinear(op, mg, _cpu(n))
    zero = sc.prescribed_or_zero(torch.float64)
    one = solve_operator_fpcg(op, sc.loads, zero, mg, tol=TOL)
    sol = solve_operator_fpcg(op_s, constrain(sc.loads), constrain(zero), mg_s, tol=TOL)
    u = op_s.gather(sol.displacements)
    assert sol.stats.converged and abs(sol.stats.iterations - one.stats.iterations) <= 1
    b = op.rhs(sc.loads, zero)
    assert float(torch.linalg.vector_norm(b - op.apply(u)) / torch.linalg.vector_norm(b)) <= TOL
    assert _rel(u, one.displacements) <= 10 * TOL
    assert _rel(op_s.gather(sol.reactions), one.reactions) <= 10 * TOL
    if name == "8x8x31":
        _, _, jax_iters, jax_u = jax_curv
        assert abs(sol.stats.iterations - jax_iters) <= 1 and _rel(u, jax_u) <= 10 * TOL


# -- extruded ----------------------------------------------------------------------

MAT_TUBE = (6.9e10, 0.3)


def _tube(segments, layers):
    """tests/test_extruded.py's tube (inner 0.08, outer 0.1, length 0.6),
    z = 0 fixed, a unit +y load on the tip ring, as host arrays."""
    sc, det = extruded_scene_tube(segments, layers, 0.08, 0.1, 0.6, ftt.Material(*MAT_TUBE), device="cpu")
    nodes = sc.host_nodes
    loads = np.zeros_like(nodes)
    tip = nodes[:, 2] == nodes[:, 2].max()
    loads[tip, 1] = 1.0 / tip.sum()
    return nodes, sc.host_elements, sc.fixed.numpy(), loads, det


@pytest.fixture(scope="module")
def tubes():
    """The port's scene and (op, composed preconditioner) of the 8x32 tube
    (one level and the Thomas solve) and the 8x64 tube (two levels)."""
    out = {}
    for layers in (32, 64):
        nodes, elements, fixed, loads, det = _tube(8, layers)
        sc = ftt.make_scene(nodes, elements, fixed, loads, ftt.Material(*MAT_TUBE), dtype=torch.float64, device="cpu")
        out[layers] = (sc, det, ftt.build_extruded(sc, det))
    return out


@pytest.fixture(scope="module")
def jax_tube_sharded():
    """The reference's ``shard_extruded`` of the 8x32 tube on 8 devices:
    its sharded apply of a ramp and its sharded solve (native f64 Krylov,
    as the port's)."""
    nodes, elements, fixed, loads, _ = _tube(8, 32)
    jsc, det = jax_tube(8, 32, 0.08, 0.1, 0.6, ft.Material(*MAT_TUBE), dtype=jnp.float64)
    jsc = ft.make_scene(nodes, elements, fixed, loads, ft.Material(*MAT_TUBE), dtype=jnp.float64)
    op, mg = jax_build_extruded(jsc, det)
    op_s, mg_s, con = jax_shard_extruded(op, mg, jax_mesh(8))
    x = np.linspace(-1.0, 1.0, nodes.size).reshape(-1, 3)
    sol = jax_solve_extruded(jsc, det, tol=TOL, prebuilt=(op_s, mg_s), krylov="f64")
    return x, np.asarray(op_s.apply_raw(con(jnp.asarray(x)))), int(sol.stats.iterations), np.asarray(sol.displacements)


@pytest.mark.parametrize("n", [2, 3, 4, 8])
def test_extruded_apply_matches_jax_and_unsharded(tubes, jax_tube_sharded, n):
    """The layer-slab apply (an element layer across a shard boundary
    reads the neighbour's node layer; none joins the halo past the ends)
    against the port unsharded (1e-13) and the reference's sharded apply
    (1e-12), raw and masked."""
    sc, _, (op, mg) = tubes[32]
    op_s, _, constrain = shard_extruded(op, mg, _cpu(n))
    x_np, jax_ax, _, _ = jax_tube_sharded
    x = torch.as_tensor(x_np)
    got = op_s.gather(op_s.apply_raw(constrain(x)))
    assert _rel(got, op.apply_raw(x)) <= 1e-13 and _rel(got, jax_ax) <= 1e-12
    assert _rel(op_s.gather(op_s.apply(constrain(x))), op.apply(x)) <= 1e-13


@pytest.mark.parametrize("n", [2, 3, 8])
@pytest.mark.parametrize("composed", [True, False], ids=["composed", "vcycle"])
@pytest.mark.parametrize("layers", [32, 64])
def test_extruded_precond_matches_unsharded(tubes, layers, composed, n):
    """One application of the sharded V-cycle, and of the section-RBM
    composition around it (its residual update by the f64 operator on the
    shards), against the unsharded preconditioner: within f32 rounding
    (1e-5 of max|z|); one sharded level on the 8x32 tube, two on 8x64."""
    sc, _, (op, pc) = tubes[layers]
    mg = pc if composed else pc.mg
    op_s, mg_s, constrain = shard_extruded(op, mg, _cpu(n))
    inner = mg_s.mg if composed else mg_s
    assert len(inner.levels) == min(2, len(pc.mg.levels)) == (1 if layers == 32 else 2)
    r = (torch.as_tensor(np.random.default_rng(35).normal(size=(sc.n_nodes, 3))) * op.free).to(torch.float32)
    got = op_s.gather(mg_s(constrain(r)))
    assert got.dtype == torch.float32 and _rel(got, mg(r)) <= 1e-5


def test_extruded_special_layers_are_shard_local(tubes):
    """The global special layers of each sharded level (the first and the
    last, ``_ELevel.special_idx``) land on their shards as local indices,
    with their own inverses; padding layers past the mesh are identity
    blocks."""
    _, _, (op, pc) = tubes[64]
    n = 3
    _, mg_s, constrain = shard_extruded(op, pc.mg, _cpu(n))
    for lv, glv in zip(mg_s.levels, pc.mg.levels):
        ll = lv.op.z_local
        L = glv.op.n_layers
        for i in range(n):
            mine = [s for s in glv.special_idx if i * ll <= s < (i + 1) * ll]
            got = [] if lv.special[i] is None else lv.special[i].tolist()
            assert got == [s - i * ll for s in mine]
            if mine:
                k = [glv.special_idx.index(s) for s in mine]
                assert torch.equal(lv.minv_special[i], glv.minv_special[k])
            assert lv.real[i] == min(max(L - i * ll, 0), ll)
        r = Shards(torch.ones((ll, glv.op.n2, 3)) for _ in range(n))
        z = lv.block_jacobi(r)
        last = n - 1
        assert lv.real[last] < ll and torch.equal(z[last][lv.real[last]:], r[last][lv.real[last]:])


@pytest.mark.parametrize("n", [2, 8])
def test_extruded_solve_matches_jax_and_unsharded(tubes, jax_tube_sharded, n):
    """``solve_extruded(prebuilt=shard_extruded(...))`` takes the Python
    loop on the shards and returns (N, 3) results: iterations within 1 of
    the port unsharded (the staged loop) and of the reference's sharded
    solve, a true f64 residual <= tol, displacements within 10 tol, and the
    fixed ring's reactions balancing the load."""
    sc, det, (op, pc) = tubes[32]
    op_s, mg_s, _ = shard_extruded(op, pc, _cpu(n))
    one = ftt.solve_extruded(sc, det, tol=TOL, prebuilt=(op, pc))
    sol = ftt.solve_extruded(sc, det, tol=TOL, prebuilt=(op_s, mg_s))
    _, _, jax_iters, jax_u = jax_tube_sharded
    u = sol.displacements
    assert sol.stats.converged and u.shape == sc.loads.shape
    assert abs(sol.stats.iterations - one.stats.iterations) <= 1 and abs(sol.stats.iterations - jax_iters) <= 1
    b = op.rhs(sc.loads, torch.zeros_like(sc.loads))
    assert float(torch.linalg.vector_norm(b - op.apply(u)) / torch.linalg.vector_norm(b)) <= TOL
    assert _rel(u, one.displacements) <= 10 * TOL and _rel(u, jax_u) <= 10 * TOL
    ring = sc.fixed.any(dim=1)
    assert abs(float(sol.reactions[ring, 1].sum()) + float(sc.loads[:, 1].sum())) <= 1e-6


# -- what a shard holds --------------------------------------------------------------


def _spy(calls, fn):
    def inner(*args, **kw):
        calls.append(args)
        return fn(*args, **kw)
    return inner


def test_no_curv_shard_tensor_exceeds_its_slab(curv, monkeypatch):
    """Every field a shard keeps has its own planes only (Zl at the fine
    level, Zl / 2 at level 1), and every slab apply of a solve gets at most
    Zl + 2 planes of state: no whole field on any shard."""
    sc, op, mg = curv["5x5x96"]
    n = 4
    op_s, mg_s, constrain = shard_curvilinear(op, mg, _cpu(n))
    zl = op_s.z_local
    Z = op.grid_shape[0]
    assert zl + 2 < Z and zl % 4 == 0
    for w, f in zip(op_s.w, op_s.free):
        assert w.shape[3] == zl and f.shape[0] == zl and w.is_contiguous()
    for lv, planes in zip(mg_s.levels, (zl, zl // 2)):
        assert all(t.shape[3] == planes for t in lv.w)
        assert all(t.shape[0] == planes for t in list(lv.free) + list(lv.inv_diag))
    calls, masked = [], []
    monkeypatch.setattr(pcurv, "var_apply_slab", _spy(calls, pcurv.var_apply_slab))
    monkeypatch.setattr(pcurv, "var_apply_slab_masked", _spy(masked, pcurv.var_apply_slab_masked))
    zero = sc.prescribed_or_zero(torch.float64)
    assert solve_operator_fpcg(op_s, constrain(sc.loads), constrain(zero), mg_s, tol=TOL).stats.converged
    calls += [(w, g) for w, f, g in masked]
    assert masked and all(f.shape == g.shape for _, f, g in masked)
    assert calls and max(g.shape[0] for _, g in calls) <= zl + 2
    assert max(w.shape[3] for w, _ in calls) <= zl


def test_no_extruded_shard_tensor_exceeds_its_slab(tubes, monkeypatch):
    """The extruded shards keep their layers of every mask, and each slab
    apply of a solve reads at most Ll + 2 node layers."""
    sc, det, (op, pc) = tubes[64]
    n = 4
    op_s, mg_s, _ = shard_extruded(op, pc, _cpu(n))
    ll = op_s.z_local
    assert ll + 2 < op.n_layers and ll % 4 == 0
    assert all(f.shape[0] == ll for f in op_s.free) and all(o.free.shape[0] == ll * o.n2 for o in op_s.ops)
    for lv, layers in zip(mg_s.mg.levels, (ll, ll // 2)):
        assert all(f.shape[0] == layers for f in lv.op.free)
    calls = []
    monkeypatch.setattr(pext, "_slab_apply_raw", _spy(calls, pext._slab_apply_raw))
    assert ftt.solve_extruded(sc, det, tol=TOL, prebuilt=(op_s, mg_s)).stats.converged
    assert calls and max(e.shape[0] for _, e, _, _ in calls) <= ll + 2


# -- the dry run -----------------------------------------------------------------------


@pytest.mark.parametrize("n", [2, 3, 4])
def test_dryrun_runs_the_seven_modes(n, capsys):
    """``python -m fea_tpu_torch.dryrun N --device cpu`` (its ``main``):
    every mode of the reference's dry run at its tiny sizes, one line each,
    and the closing line."""
    dryrun.main([str(n), "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    modes = [line.split(" mode ")[1].split(":")[0] for line in lines if " mode " in line]
    assert modes == ["1", "2", "3", "4", "5", "5b", "6", "7"]
    assert lines[-1] == f"dryrun({n}): all seven sharding modes executed on {['cpu'] * n}"
