"""Port parity, the z-sharded voxel solve: ``fea_tpu_torch.parallel.halo``
and the slab applies (the plain versions of K1's halo form and K3) against
the JAX package, on the CPU.

The shard counts follow tests/test_halo_sharding.py: 2x2x12 has Z = 13
node planes, so 8 shards of Zl = 2 pad the grid to 16 planes and the
global z-max plane falls mid-way, on shard 6 of 8, with one shard of pure
padding after it. The 4x4x32 slender cantilever has a three-level
hierarchy, so its level 1 is sharded too (Zl a multiple of 4). Every
device of a shard list is "cpu" here: the list may repeat a device, so
this runs every line of the decomposition on one CPU. All inputs are
made with numpy from a seed.
"""
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fea_tpu as ft
from fea_tpu.ops.multigrid import build_multigrid as jax_build_multigrid
from fea_tpu.ops.pallas_stencil import dd_z_chunks as jax_dd_z_chunks
from fea_tpu.ops.structured import build_structured_operator as jax_build_structured_operator
from fea_tpu.ops.structured import stencil_apply_np
from fea_tpu.ops.structured import structured_scene as jax_structured_scene
from fea_tpu.solve.fpcg import solve_operator_fpcg as jax_solve_operator_fpcg

import fea_tpu_torch as ftt
from fea_tpu_torch.dtypes import precise_dot
from fea_tpu_torch.elements.hex8 import stiffness_matrix_np
from fea_tpu_torch.ops import cuda_stencil
from fea_tpu_torch.ops.multigrid import _prolong, _restrict, build_multigrid
from fea_tpu_torch.ops.structured import build_structured_operator
from fea_tpu_torch.parallel import build_zsharded_solver, halo, shard_geometry
from torch_pin import one_torch_thread  # noqa: F401

TOL = 1e-8
MAT = dict(E=6.9e10, nu=0.3)
# (elements per axis, box lengths) of the two sharded scenes
SCENES = {"2x2x12": ((2, 2, 12), (0.1, 0.1, 1.0)), "4x4x32": ((4, 4, 32), (0.05, 0.05, 1.0))}


def _ke(dims):
    """The Ke of one voxel of a 0.1 x 0.1 x 1.0 box of ``dims`` elements."""
    nx, ny, nz = dims
    corners = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                        [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]], np.float64)
    return stiffness_matrix_np(corners * np.array([0.1 / nx, 0.1 / ny, 1.0 / nz]), ftt.Material(**MAT))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("dims", [(2, 2, 12), (3, 2, 5)], ids=["2x2x12", "3x2x5"])
def test_slab_apply_matches_numpy_oracle(dims, n, dtype):
    """The shards' slab applies, concatenated, against the JAX package's
    f64 NumPy oracle of the whole grid: 1e-13 relative in f64 (another
    summation order); in f32 the plain version sums f32-rounded inputs and
    weights in f32, whose rounding bounds the error at 2e-6."""
    nx, ny, nz = dims
    Z, Y, X = nz + 1, ny + 1, nx + 1
    ke = _ke(dims)
    g = np.random.default_rng(11).normal(size=(Z, Y, X, 3))
    Zl = shard_geometry(Z, n, [(0, 1, 2)])[0]
    Zp = n * Zl
    g_pad = np.zeros((Zp + 2, Y, X, 3))  # a zero plane below, padding above
    g_pad[1 : Z + 1] = g
    w = cuda_stencil.stencil_weights(ke, dtype, "cpu")
    gt = torch.as_tensor(g_pad).to(dtype)
    got = torch.cat([
        cuda_stencil.stencil_apply_slab(w, gt[i * Zl : i * Zl + Zl + 2], i * Zl, Z) for i in range(n)
    ])
    assert got.shape == (Zp, Y, X, 3) and got.dtype == dtype
    assert torch.count_nonzero(got[Z:]) == 0  # padding planes come out 0
    want = stencil_apply_np(ke, g, dims)
    bound = 1e-13 if dtype == torch.float64 else 2e-6
    assert np.abs(got[:Z].double().numpy() - want).max() <= bound * np.abs(want).max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("dims", [(2, 2, 12), (3, 2, 5), (4, 4, 40)], ids=["2x2x12", "3x2x5", "4x4x40"])
def test_chunked_apply_is_the_unchunked_apply_bitwise(dims, dtype):
    """``stencil_apply_chunked`` in 1-8 chunks equals ``stencil_apply`` bit
    for bit: each node sums the same element products in the same order."""
    nx, ny, nz = dims
    w = cuda_stencil.stencil_weights(_ke(dims), dtype, "cpu")
    g = torch.as_tensor(np.random.default_rng(12).normal(size=(nz + 1, ny + 1, nx + 1, 3))).to(dtype)
    whole = cuda_stencil.stencil_apply(w, g)
    for n in range(1, 9):
        assert torch.equal(cuda_stencil.stencil_apply_chunked(w, g, n), whole), n


def test_dd_z_chunks_are_the_reference_counts():
    """The chunk counts of the reference's VMEM rule, including the 3 and 6
    of the 8.1M- and 16.2M-DOF capacity grids and the flagship's 1."""
    for Y, X, Z in [(33, 33, 321), (65, 65, 641), (65, 65, 1281), (9, 9, 81), (129, 129, 65)]:
        assert cuda_stencil.dd_z_chunks(Y, X, Z) == jax_dd_z_chunks(Y, X, Z)
    assert [cuda_stencil.dd_z_chunks(65, 65, Z) for Z in (641, 1281)] == [3, 6]


@pytest.mark.parametrize("sharded_levels", [1, 2], ids=["fine", "level1"])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_halo_restrict_prolong_match_unsharded(n, sharded_levels):
    """Exact agreement of the per-shard transfer pieces with the unsharded
    ones on the 2x2x12 grid: each halo-extended slab is the zero-padded
    grid's planes; the restricted shards, gathered, are ``_restrict`` of
    the grid; the prolonged shards, gathered, are ``_prolong`` of the
    coarse grid (z first, then y and x, as ``_prolong`` orders them)."""
    rng = np.random.default_rng(13)
    Z, Y, X = 13, 3, 3
    Zl = shard_geometry(Z, n, [(0, 1, 2)] * sharded_levels)[0]
    Zp = n * Zl
    assert Zl % (4 if sharded_levels == 2 else 2) == 0
    devices = ["cpu"] * n
    d = torch.as_tensor(rng.normal(size=(Z, Y, X, 3)))
    shards = halo._scatter(d, devices, Zl)
    padded = torch.zeros((Zp + 2, Y, X, 3), dtype=d.dtype)
    padded[1 : Z + 1] = d
    for i, e in enumerate(halo._halo_exchange(shards)):
        assert torch.equal(e, padded[i * Zl : i * Zl + Zl + 2])
    Zc = (Z + 1) // 2
    assert torch.equal(halo._gather(halo._restrict_z_shard(shards), Zc), _restrict(d))
    c = torch.as_tensor(rng.normal(size=(Zc, 2, 2, 3)))
    c_pad = torch.cat([c, torch.zeros((Zp // 2 + 1 - Zc, 2, 2, 3), dtype=c.dtype)])
    h = Zl // 2
    fine = torch.cat([
        _prolong(halo._prolong_z_interleave(c_pad[i * h : i * h + h + 1]), axes=(1, 2)) for i in range(n)
    ])
    assert torch.equal(fine[:Z], _prolong(c))


def _scene_arrays(name):
    dims, (lx, ly, lz) = SCENES[name]
    jsc, _ = jax_structured_scene(*dims, lx, ly, lz, ft.Material(**MAT), dtype=jnp.float64)
    nodes = np.asarray(jsc.nodes)
    loads = np.zeros_like(nodes)
    tip = nodes[:, 2] == lz
    loads[tip, 1] = 1000.0 / tip.sum()
    fixed = np.asarray(jsc.fixed)
    return dims, nodes, np.asarray(jsc.elements), fixed, loads


def _mg_kw(fixed):
    # tests/test_halo_sharding.py's hierarchy: degree 2, every level f32
    return dict(degree=2, small_level_dof=0, coarse_dof_limit=300, free_np=1.0 - fixed.astype(np.float64))


@pytest.fixture(scope="module")
def jax_reference():
    """The JAX package's single-device f64 FCG (XLA on the CPU) on each
    scene, with its own hierarchy: {name: (iterations, u, reactions)}."""
    out = {}
    for name in SCENES:
        dims, nodes, elements, fixed, loads = _scene_arrays(name)
        jsc = ft.make_scene(nodes, elements, fixed, loads, ft.Material(**MAT), dtype=jnp.float64)
        op = jax_build_structured_operator(jsc, dims, dtype=jnp.float64)
        mg = jax_build_multigrid(op.astype(jnp.float32), dtype=jnp.float32, **_mg_kw(fixed))
        sol = jax_solve_operator_fpcg(op, jnp.asarray(loads), jnp.zeros_like(jnp.asarray(loads)), mg, tol=TOL)
        assert bool(sol.stats.converged)
        out[name] = (int(sol.stats.iterations), np.asarray(sol.displacements), np.asarray(sol.reactions))
    return out


def _host_true_residual(sc, dims, u):
    """||F (loads - K u)|| / ||F loads|| in NumPy f64, K u by the JAX
    package's oracle."""
    nx, ny, nz = dims
    ke = stiffness_matrix_np(sc.host_nodes[sc.host_elements[0]], sc.material)
    Ku = stencil_apply_np(ke, u.reshape(nz + 1, ny + 1, nx + 1, 3), dims).reshape(-1, 3)
    F = sc.free_mask(torch.float64).numpy()
    loads = sc.loads.numpy()
    return np.linalg.norm(F * (loads - Ku)) / np.linalg.norm(F * loads)


def _port_solver(name, n, shard_levels=2):
    dims, nodes, elements, fixed, loads = _scene_arrays(name)
    sc = ftt.make_scene(nodes, elements, fixed, loads, ftt.Material(**MAT), dtype=torch.float64, device="cpu")
    op = build_structured_operator(sc, dims, dtype=torch.float64)
    mg = build_multigrid(op.astype(torch.float32), dtype=torch.float32, **_mg_kw(fixed))
    return build_zsharded_solver(op, mg, ["cpu"] * n, shard_levels=shard_levels), sc, dims


@pytest.mark.parametrize(
    "name, n, shard_levels",
    [(name, n, 2) for name in SCENES for n in (2, 4, 8)] + [("4x4x32", 4, 1)],
    ids=lambda v: str(v),
)
def test_zsharded_solve_matches_jax(name, n, shard_levels, jax_reference):
    """The sharded solve against the reference's single-device solve:
    iterations equal within 1 (the shard partials of a dot are summed in
    another order), a true residual <= tol recomputed in NumPy f64, and
    displacements and reactions within 10 tol of their largest value (both
    solves meet tol in the true residual). ``shard_levels=1`` keeps level 1
    replicated on the three-level hierarchy."""
    iters_ref, u_ref, r_ref = jax_reference[name]
    solver, sc, dims = _port_solver(name, n, shard_levels)
    assert (len(solver.mg.levels) == 2) == (name == "4x4x32" and shard_levels == 2)
    sol = solver.solve(sc.loads)
    assert sol.stats.converged
    assert abs(sol.stats.iterations - iters_ref) <= 1
    u = sol.displacements.numpy()
    rel = _host_true_residual(sc, dims, u)
    assert rel <= TOL
    assert sol.stats.relative_residual == pytest.approx(rel, rel=1e-3)
    assert np.abs(u - u_ref).max() <= 10 * TOL * np.abs(u_ref).max()
    assert np.abs(sol.reactions.numpy() - r_ref).max() <= 10 * TOL * np.abs(r_ref).max()


def test_no_shard_tensor_exceeds_its_slab(monkeypatch):
    """No tensor of the sharded solve holds more than a halo-extended slab:
    the solver's stored shards have Zl planes (Zl / 2 at level 1), and
    every slab apply and restriction of a solve gets at most Zl + 2."""
    n = 8
    solver, sc, _ = _port_solver("4x4x32", n)
    Zl, Z = solver.z_local, solver.grid_shape[0]
    assert Zl + 2 < Z
    fine, l1 = solver.mg.levels
    for shards, planes in [(solver.op.free, Zl), (fine.free, Zl), (fine.inv_diag, Zl),
                           (l1.free, Zl // 2), (l1.inv_diag, Zl // 2)]:
        assert len(shards) == n and all(s.shape[0] == planes for s in shards)
    seen = []

    def spy(fn):
        def inner(*args, **kw):
            seen.append(next(a for a in args if isinstance(a, torch.Tensor)).shape[0])
            return fn(*args, **kw)
        return inner

    monkeypatch.setattr(halo, "stencil_apply_slab", spy(halo.stencil_apply_slab))
    monkeypatch.setattr(halo, "_restrict", spy(halo._restrict))
    assert solver.solve(sc.loads).stats.converged
    assert seen and max(seen) <= Zl + 2


def test_shards_arithmetic_is_shard_by_shard():
    """``Shards`` as the single-device solver code uses it: shard-by-shard
    +, - and * with Shards, floats and 0-d tensors, ``1.0 - x``, ``.to``,
    ``torch.zeros_like``, and dots and norms whose partials are summed in
    shard order (exactly the f64 dot of the concatenation's shard sums)."""
    rng = np.random.default_rng(14)
    a = halo.Shards(torch.as_tensor(rng.normal(size=(2, 3, 3, 3))) for _ in range(3))
    b = halo.Shards(torch.as_tensor(rng.normal(size=(2, 3, 3, 3))) for _ in range(3))
    s = torch.tensor(0.25, dtype=torch.float64)
    for got, want in [(a + b, [x + y for x, y in zip(a, b)]), (a - b, [x - y for x, y in zip(a, b)]),
                      (a * b, [x * y for x, y in zip(a, b)]), (2.0 * a, [2.0 * x for x in a]),
                      (s * a, [s * x for x in a]), (a * s, [x * s for x in a]), (1.0 - a, [1.0 - x for x in a]),
                      (a.to(torch.float32), [x.float() for x in a]), (torch.zeros_like(a), [0 * x for x in a])]:
        assert isinstance(got, halo.Shards) and len(got) == 3
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    want = torch.dot(a[0].reshape(-1), b[0].reshape(-1))
    for x, y in zip(a[1:], b[1:]):
        want = want + torch.dot(x.reshape(-1), y.reshape(-1))
    assert torch.equal(precise_dot(a, b), want)
    assert a.dtype == torch.float64
    assert float(torch.linalg.vector_norm(a)) == pytest.approx(float(torch.linalg.vector_norm(torch.cat(a))),
                                                               rel=1e-15)


@pytest.mark.parametrize(
    "n_dev, sharded, nz, want",
    [(4, True, 16, True), (4, None, 16, False), (1, True, 16, False), (4, True, 12, False), (4, False, 16, False)],
    ids=["4-dev-forced", "4-dev-default", "1-dev", "z-planes-13", "4-dev-off"],
)
def test_solve_routes_sharded_only_when_asked(n_dev, sharded, nz, want, monkeypatch):
    """``solve()`` takes the sharded route only under ``sharded=True``,
    with more than one device and Z nodes >= 16; the default (None), like
    False, keeps one device whatever the device count. Both routes
    converge to a true residual <= tol."""
    mod = sys.modules["fea_tpu_torch.solve"]
    monkeypatch.setattr(mod, "_device_count", lambda device: n_dev)
    monkeypatch.setattr(mod, "_STRUCTURED_MIN_DOF", 0)
    calls = []
    real = halo.ZShardedSolver.solve
    monkeypatch.setattr(halo.ZShardedSolver, "solve", lambda self, *a, **k: calls.append(len(self.devices))
                        or real(self, *a, **k))
    dims = (2, 2, nz)
    nodes, elements = ftt.mesh.box_hex_mesh(*dims, 0.1, 0.1, 1.0)
    fixed = ftt.fix_where(nodes, lambda p: p[:, 2] == 0.0, 3)
    loads = np.zeros_like(nodes)
    loads[nodes[:, 2] == 1.0, 1] = 1.0
    sc = ftt.make_scene(nodes, elements, fixed, loads, ftt.Material(**MAT), dtype=torch.float64, device="cpu")
    sol = ftt.solve(sc, config=ftt.SolverConfig(sharded=sharded), tol=TOL)
    assert calls == ([n_dev] if want else [])
    assert sol.stats.converged
    assert _host_true_residual(sc, dims, sol.displacements.numpy()) <= TOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("n", [2, 3, 8])
def test_masked_slab_apply_is_the_masked_whole_grid_apply(n, dtype):
    """The slab form with ``free_ext`` on each of n CPU shards, against the
    whole-grid masked apply: 1e-13 (f64) and 2e-6 (f32) of max|out| (the
    slabs' plain version sums whole element layers, in another order at a
    slab's ends); a padding plane comes out as (1 - F) g, here g itself."""
    dims = (3, 2, 5)
    nx, ny, nz = dims
    Z, Y, X = nz + 1, ny + 1, nx + 1
    rng = np.random.default_rng(21)
    Zl = shard_geometry(Z, n, [(0, 1, 2)])[0]
    Zp = n * Zl
    g = torch.zeros((Zp + 2, Y, X, 3), dtype=dtype)
    g[1:] = torch.as_tensor(rng.normal(size=(Zp + 1, Y, X, 3))).to(dtype)  # the padding holds values too
    F = torch.zeros_like(g)
    F[1 : Z + 1] = torch.as_tensor((rng.random((Z, Y, X, 3)) < 0.8).astype(np.float64)).to(dtype)
    w = cuda_stencil.stencil_weights(_ke(dims), dtype, "cpu")
    got = torch.cat([
        cuda_stencil.stencil_apply_slab(w, g[i * Zl : i * Zl + Zl + 2], i * Zl, Z, F[i * Zl : i * Zl + Zl + 2])
        for i in range(n)
    ])
    want = cuda_stencil.stencil_apply(w, g[1 : Z + 1].contiguous(), F[1 : Z + 1].contiguous())
    bound = 1e-13 if dtype == torch.float64 else 2e-6
    assert float((got[:Z] - want).abs().max()) <= bound * float(want.abs().max())
    assert torch.equal(got[Z:], g[Z + 1 : Zp + 1])


@pytest.mark.parametrize("n", [2, 3, 8])
def test_shard_operator_apply_is_the_masked_operator(n):
    """``ShardedStructuredOperator.apply`` (raw halos, the halo-extended mask built
    once) gathers to ``StructuredOperator.apply`` of the whole grid, and
    its mask shards hold their neighbours' edge planes."""
    dims, lengths = SCENES["2x2x12"]
    from fea_tpu_torch.ops.structured import structured_scene

    scene, _ = structured_scene(*dims, *lengths, ftt.Material(**MAT), dtype=torch.float64, device="cpu")
    op = build_structured_operator(scene, dims, dtype=torch.float64)
    mg = build_multigrid(op.astype(torch.float32), dtype=torch.float32, coarse_dof_limit=100)
    solver = build_zsharded_solver(op, mg, ["cpu"] * n, shard_levels=1)
    x = torch.as_tensor(np.random.default_rng(22).normal(size=(op.n_nodes, 3)))
    got = solver.gather(solver.op.apply(solver.scatter(x)))
    want = op.apply(x)
    assert float((got - want).abs().max()) <= 1e-13 * float(want.abs().max())
    ext = solver.op.free_ext
    assert all(e.shape[0] == solver.z_local + 2 for e in ext)
    for i in range(n):
        assert torch.equal(ext[i][1:-1], solver.op.free[i])
        assert torch.equal(ext[i][0], solver.op.free[i - 1][-1] if i else torch.zeros_like(ext[i][0]))
        assert torch.equal(ext[i][-1], solver.op.free[i + 1][0] if i + 1 < n else torch.zeros_like(ext[i][0]))
