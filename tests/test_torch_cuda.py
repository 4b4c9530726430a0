"""K1, K2, K3 (and K1's halo form), K4, K5 (and their slab forms), K6,
K7, the block-Thomas kernel and the extruded apply E on the card against
their plain version
(f64) on the card, the
z-sharded and the sharded curvilinear solve on one card,
and the staged loop of the grid, embedded and extruded routes on the card.

Needs a CUDA card and nvcc; skips without a card. This file imports
neither JAX nor fea_tpu, so it runs where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from fea_tpu_torch.elements.hex8 import stiffness_matrix_np
from fea_tpu_torch.materials import Material
from fea_tpu_torch.mesh import annulus_section, box_hex_mesh, generate_quad_grid
from fea_tpu_torch.ops import cuda_stencil
from fea_tpu_torch.ops.cuda_stencil import stencil_apply, stencil_weights
from fea_tpu_torch.ops.structured import stencil_apply_grid

# K1: f32 rounding of inputs, weights and sums (tests/test_pallas.py's
# bound); K2: f64, another summation order than the plain version
BOUNDS = {torch.float32: ("f32", 2e-5), torch.float64: ("f64", 1e-12)}


@pytest.mark.cuda
@pytest.mark.parametrize("dims", [(1, 1, 1), (3, 2, 5), (4, 4, 8), (16, 16, 160),
                                  (13, 7, 29), (5, 9, 1), (40, 1, 3), (32, 32, 9),
                                  (255, 1, 2), (256, 2, 2), (300, 2, 3), (517, 4, 5)])
def test_kernels_match_plain_version_on_card(dims):
    """K1/K2 raw and masked against the plain version in f64; the shapes
    past the first four straddle the kernel's band, warp and chunk edges
    (odd unequal counts, two planes, two rows, 2^k + 1 nodes), and the last
    four the widest row a block holds whole (256 nodes) and rows cut into
    segments."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1 and K2 have no CPU mode")
    nx, ny, nz = dims
    corners = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                        [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]], np.float64) * 0.01
    ke = stiffness_matrix_np(corners, Material(E=1e7, nu=0.3))
    g64 = torch.as_tensor(np.random.default_rng(6).normal(size=(nz + 1, ny + 1, nx + 1, 3)), device="cuda")
    want = stencil_apply_grid(torch.as_tensor(ke, device="cuda"), g64, dims)
    for dt, (key, bound) in BOUNDS.items():
        n0 = cuda_stencil.LAUNCHES[key]
        got = stencil_apply(stencil_weights(ke, dt, "cuda"), g64.to(dt).contiguous())
        torch.cuda.synchronize()
        assert cuda_stencil.LAUNCHES[key] == n0 + 1
        rel = float((got.double() - want).abs().max() / want.abs().max())
        assert rel < bound, (dims, key, rel)
        F64 = torch.as_tensor((np.random.default_rng(7).random(tuple(g64.shape)) < 0.8).astype(np.float64),
                              device="cuda")
        w, g, F = stencil_weights(ke, dt, "cuda"), g64.to(dt).contiguous(), F64.to(dt)
        got_m = stencil_apply(w, g, F)
        torch.cuda.synchronize()
        assert cuda_stencil.LAUNCHES[key] == n0 + 2  # the masked form is one launch too
        want_m = stencil_apply_grid(torch.as_tensor(ke, device="cuda"), g64, dims, F64)
        assert float((got_m.double() - want_m).abs().max() / want.abs().max()) < bound, (dims, key, "masked")
        # value for value the unfused expression around the raw kernel
        assert torch.equal(got_m, F * stencil_apply(w, F * g) + (1.0 - F) * g), (dims, key)


@pytest.mark.cuda
@pytest.mark.parametrize("dims", [(1, 1, 1), (3, 4, 6), (8, 8, 32), (20, 20, 80),
                                  (40, 40, 160), (300, 2, 3), (130, 3, 9)])
def test_var_kernels_match_plain_version_on_card(dims):
    """K4 (f32) and K5 (f64), raw and masked, against the plain version in
    f64, on symmetrized random weights (the kernels' input contract: they
    read 14 of the 27 blocks and mirror the rest) and random input. The
    last three shapes: the fine curvilinear grid, whose 1,681-node planes
    are no multiple of the kernel's block of 256 nodes (one thread a node),
    and rows longer than a block. The masked launch is, value for value,
    F K(F g) + (1 - F) g around the raw launch (exact for a 0/1 mask)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K4 and K5 have no CPU mode")
    from fea_tpu_torch.ops import cuda_varstencil
    from fea_tpu_torch.ops.curvilinear import curv_apply_grid, symmetrize_field

    nx, ny, nz = dims
    rng = np.random.default_rng(8)
    w64 = symmetrize_field(torch.as_tensor(rng.normal(size=(27, 3, 3, nz + 1, ny + 1, nx + 1)), device="cuda"))
    g64 = torch.as_tensor(rng.normal(size=(nz + 1, ny + 1, nx + 1, 3)), device="cuda")
    F64 = torch.as_tensor((rng.random(tuple(g64.shape)) < 0.8).astype(np.float64), device="cuda")
    want = curv_apply_grid(w64, g64)
    want_m = F64 * curv_apply_grid(w64, F64 * g64) + (1.0 - F64) * g64
    for dt, bound in ((torch.float32, 2e-5), (torch.float64, 1e-12)):
        key = "var_f32" if dt == torch.float32 else "var_f64"
        w, g, F = w64.to(dt).contiguous(), g64.to(dt).contiguous(), F64.to(dt).contiguous()
        n0 = cuda_varstencil.LAUNCHES[key]
        got = cuda_varstencil.var_apply(w, g)
        torch.cuda.synchronize()
        assert cuda_varstencil.LAUNCHES[key] == n0 + 1
        rel = float((got.double() - want).abs().max() / want.abs().max())
        assert rel < bound, (dims, key, rel)
        got_m = cuda_varstencil.var_apply_masked(w, F, g)
        torch.cuda.synchronize()
        assert cuda_varstencil.LAUNCHES[key] == n0 + 2  # the masked form is one launch
        assert float((got_m.double() - want_m).abs().max() / want_m.abs().max()) < bound, (dims, key, "masked")
        assert torch.equal(got_m, F * cuda_varstencil.var_apply(w, F * g) + (1.0 - F) * g), (dims, key)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 3])
@pytest.mark.parametrize("dims", [(1, 1, 1), (3, 4, 6), (20, 20, 7), (255, 1, 2), (16, 15, 33)])
def test_var_slab_kernels_match_plain_version_on_card(dims, n):
    """K4-slab (f32, 2e-5) and K5-slab (f64, 1e-12) on each of n shards'
    own weights and halo-extended state, against the plain slab version in
    f64; the shapes straddle the kernel's block of 256 nodes (planes of
    441 and 512 nodes, a row of 256) and the cuts leave padding planes,
    which come out 0. Each slab is, value for value, the unsharded K4/K5
    on its planes: the z terms past the grid add exact zeros. The weights
    are symmetrized random ones, zero toward the planes past the z ends as
    an assembled field's are (the slab kernels read those). The masked slab
    launch is, value for value, the masked expression around the raw one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K4-slab and K5-slab have no CPU mode")
    from fea_tpu_torch.ops import cuda_varstencil
    from fea_tpu_torch.ops.curvilinear import curv_apply_slab_grid, symmetrize_field

    nx, ny, nz = dims
    Z, Y, X = nz + 1, ny + 1, nx + 1
    zl = -(-Z // n)
    rng = np.random.default_rng(9)
    w_real = torch.as_tensor(rng.normal(size=(27, 3, 3, Z, Y, X)), device="cuda")
    w_real[:9, :, :, 0] = 0.0
    w_real[18:, :, :, -1] = 0.0
    w64 = torch.zeros((27, 3, 3, n * zl, Y, X), dtype=torch.float64, device="cuda")
    w64[:, :, :, :Z] = symmetrize_field(w_real)
    g64 = torch.zeros((n * zl + 2, Y, X, 3), dtype=torch.float64, device="cuda")
    g64[1 : Z + 1] = torch.as_tensor(rng.normal(size=(Z, Y, X, 3)), device="cuda")
    f64 = torch.as_tensor((rng.random(tuple(g64.shape)) < 0.8).astype(np.float64), device="cuda")
    for dt, bound in ((torch.float32, 2e-5), (torch.float64, 1e-12)):
        key = "var_slab_f32" if dt == torch.float32 else "var_slab_f64"
        whole = cuda_varstencil.var_apply(w64[:, :, :, :Z].to(dt).contiguous(), g64[1 : Z + 1].to(dt).contiguous())
        got = []
        for i in range(n):
            w = w64[:, :, :, i * zl : (i + 1) * zl]
            ext = g64[i * zl : i * zl + zl + 2]
            want = curv_apply_slab_grid(w, ext)
            n0 = cuda_varstencil.LAUNCHES[key]
            got.append(cuda_varstencil.var_apply_slab(w.to(dt).contiguous(), ext.to(dt).contiguous()))
            torch.cuda.synchronize()
            assert cuda_varstencil.LAUNCHES[key] == n0 + 1
            scale = float(want.abs().max()) or 1.0
            assert float((got[-1].double() - want).abs().max()) / scale < bound, (dims, n, i, key)
            f = f64[i * zl : i * zl + zl + 2]
            want_m = f[1:-1] * curv_apply_slab_grid(w, f * ext) + (1.0 - f[1:-1]) * ext[1:-1]
            wd, fd, ed = w.to(dt).contiguous(), f.to(dt).contiguous(), ext.to(dt).contiguous()
            got_m = cuda_varstencil.var_apply_slab_masked(wd, fd, ed)
            torch.cuda.synchronize()
            assert cuda_varstencil.LAUNCHES[key] == n0 + 2
            assert float((got_m.double() - want_m).abs().max()) / (float(want_m.abs().max()) or 1.0) < bound
            unfused = fd[1:-1] * cuda_varstencil.var_apply_slab(wd, fd * ed) + (1.0 - fd[1:-1]) * ed[1:-1]
            assert torch.equal(got_m, unfused), (dims, n, i, key)
        got = torch.cat(got)
        assert torch.count_nonzero(got[Z:]) == 0
        assert torch.equal(got[:Z], whole), (dims, n, key)


@pytest.mark.cuda
def test_sharded_curvilinear_solve_on_one_card():
    """``shard_curvilinear`` over four shards of one card against the
    unsharded FCG of the same operator and hierarchy: iterations within 1,
    displacements within 10 tol, and K4-slab / K5-slab launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import fea_tpu_torch as ftt
    from fea_tpu_torch.ops import cuda_varstencil
    from fea_tpu_torch.parallel import shard_curvilinear
    from fea_tpu_torch.solve import solve_operator_fpcg

    nodes, elements = ftt.mesh.box_hex_mesh(16, 16, 64, 0.1, 0.1, 1.0)
    rng = np.random.default_rng(10)
    interior = (nodes[:, 2] > 0) & (nodes[:, 2] < 1.0)
    nodes = nodes + 0.25 * (0.1 / 16) * rng.uniform(-1, 1, nodes.shape) * interior[:, None]
    fixed = ftt.fix_where(nodes, lambda p: p[:, 2] == 0.0, 3)
    loads = np.zeros_like(nodes)
    loads[nodes[:, 2] == 1.0, 1] = 1.0
    scene = ftt.make_scene(nodes, elements, fixed, loads, ftt.Material(E=1e7, nu=0.3), dtype=torch.float64,
                           device="cuda")
    op, mg = ftt.build_curvilinear(scene)
    zero = torch.zeros_like(scene.loads)
    ref = solve_operator_fpcg(op, scene.loads, zero, mg, tol=1e-8)
    op_s, mg_s, constrain = shard_curvilinear(op, mg, ["cuda"] * 4)
    n0 = dict(cuda_varstencil.LAUNCHES)
    sol = solve_operator_fpcg(op_s, constrain(scene.loads), constrain(zero), mg_s, tol=1e-8)
    torch.cuda.synchronize()
    assert sol.stats.converged and abs(sol.stats.iterations - ref.stats.iterations) <= 1
    du = (op_s.gather(sol.displacements) - ref.displacements).abs().max() / ref.displacements.abs().max()
    assert float(du) <= 1e-7
    assert all(cuda_varstencil.LAUNCHES[k] > n0[k] for k in ("var_slab_f32", "var_slab_f64"))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [4, 6, 24])
@pytest.mark.parametrize("E", [1, 700, 1030])
def test_element_apply_kernels_match_plain_version_on_card(k, E):
    """K6 (stored Ke batch) and K7 (one shared Ke) in f32 and f64 against
    their plain versions in f64, at the k of beams and 2D bars (4), 3D
    bars (6) and hex8 (24); each call launches its kernel once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K6 and K7 have no CPU mode")
    from fea_tpu_torch.ops import cuda_apply

    rng = np.random.default_rng(10 * k + E)
    ke_s = torch.as_tensor(rng.normal(size=(E, k, k)), device="cuda")
    ke_u = torch.as_tensor(rng.normal(size=(k, k)), device="cuda")
    u = torch.as_tensor(rng.normal(size=(E, k)), device="cuda")
    cases = (
        ("stored", cuda_apply.batched_matvec_stored, ke_s, cuda_apply.batched_matvec_stored_plain(ke_s, u)),
        ("uniform", cuda_apply.batched_matvec_uniform, ke_u, cuda_apply.batched_matvec_uniform_plain(ke_u, u)),
    )
    for kind, fn, ke, want in cases:
        for dt, bound in ((torch.float32, 2e-5), (torch.float64, 1e-12)):
            key = f"{kind}_{'f32' if dt == torch.float32 else 'f64'}"
            n0 = cuda_apply.LAUNCHES[key]
            got = fn(ke.to(dt).contiguous(), u.to(dt).contiguous())
            torch.cuda.synchronize()
            assert cuda_apply.LAUNCHES[key] == n0 + 1
            assert got.dtype == dt and got.shape == (E, k)
            rel = float((got.double() - want).abs().max() / want.abs().max())
            assert rel < bound, (kind, key, k, E, rel)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 4, 6, 24, 32])
@pytest.mark.parametrize("E", [127, 128, 129, 257])
def test_uniform_kernel_at_its_tile_edges_on_card(k, E):
    """K7 around its tile of 128 elements (a ragged last tile, a full
    one, one element into the next) at k = 24 (the tile kernel) and at the
    other kinds of k (the one-thread-an-output kernel), f32 and f64."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K7 has no CPU mode")
    from fea_tpu_torch.ops import cuda_apply

    rng = np.random.default_rng(100 * k + E)
    ke = torch.as_tensor(rng.normal(size=(k, k)), device="cuda")
    u = torch.as_tensor(rng.normal(size=(E, k)), device="cuda")
    want = cuda_apply.batched_matvec_uniform_plain(ke, u)
    for dt, bound in ((torch.float32, 2e-5), (torch.float64, 1e-12)):
        got = cuda_apply.batched_matvec_uniform(ke.to(dt).contiguous(), u.to(dt).contiguous())
        torch.cuda.synchronize()
        assert got.dtype == dt and got.shape == (E, k)
        assert float((got.double() - want).abs().max() / want.abs().max()) < bound, (k, E, dt)
    if k == 24:  # a view that starts off a 16-byte boundary is refused, not copied
        flat = torch.zeros(E * k + 1, dtype=torch.float32, device="cuda")
        with pytest.raises(ValueError, match="16-byte"):
            cuda_apply.batched_matvec_uniform(ke.float().contiguous(), flat[1:].view(E, k))
    else:  # the one-thread-an-output kernel and K6 go value by value: such a view is taken
        flat = torch.zeros(E * k + 1, dtype=torch.float32, device="cuda")
        flat[1:] = u.float().reshape(-1)
        got = cuda_apply.batched_matvec_uniform(ke.float().contiguous(), flat[1:].view(E, k))
        assert float((got.double() - want).abs().max() / want.abs().max()) < 2e-5, (k, E, "view")
        ke_s = ke.float().expand(E, k, k).contiguous()
        got = cuda_apply.batched_matvec_stored(ke_s, flat[1:].view(E, k))
        assert float((got.double() - want).abs().max() / want.abs().max()) < 2e-5, (k, E, "stored view")


def _flagship_like_ke():
    corners = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                        [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]], np.float64) * 0.01
    return stiffness_matrix_np(corners, Material(E=1e7, nu=0.3))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 3, 8])
@pytest.mark.parametrize("dims", [(3, 2, 5), (2, 2, 12), (16, 16, 160), (13, 7, 29), (300, 2, 7)])
def test_slab_kernels_match_plain_version_on_card(dims, n):
    """K1's halo form (f32, 2e-5) and K3 (f64, 1e-12) on each shard's
    halo-extended slab against the plain slab version in f64; the global
    z-max plane falls mid-shard, and past it the padding comes out 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1's halo form and K3 have no CPU mode")
    from fea_tpu_torch.ops.structured import stencil_apply_slab_grid
    from fea_tpu_torch.parallel import shard_geometry

    nx, ny, nz = dims
    Z, Y, X = nz + 1, ny + 1, nx + 1
    ke = _flagship_like_ke()
    Zl = shard_geometry(Z, n, [(0, 1, 2)])[0]
    Zp = n * Zl
    g = torch.zeros((Zp + 2, Y, X, 3), dtype=torch.float64, device="cuda")
    g[1 : Z + 1] = torch.as_tensor(np.random.default_rng(14).normal(size=(Z, Y, X, 3)), device="cuda")
    ke64 = torch.as_tensor(ke, device="cuda")
    for dt, (key, bound) in BOUNDS.items():
        w = stencil_weights(ke, dt, "cuda")
        for i in range(n):
            ext = g[i * Zl : i * Zl + Zl + 2]
            want = stencil_apply_slab_grid(ke64, ext, i * Zl, Z)
            n0 = cuda_stencil.LAUNCHES["slab_" + key]
            got = cuda_stencil.stencil_apply_slab(w, ext.to(dt).contiguous(), i * Zl, Z)
            torch.cuda.synchronize()
            assert cuda_stencil.LAUNCHES["slab_" + key] == n0 + 1
            scale = float(want.abs().max()) or 1.0
            assert float((got.double() - want).abs().max()) / scale < bound, (dims, n, i, key)
            assert torch.count_nonzero(got[max(Z - i * Zl, 0):]) == 0
        # the masked form: every shard's planes bit for bit the whole-grid masked apply
        F = torch.zeros_like(g)
        F[1 : Z + 1] = torch.as_tensor((np.random.default_rng(16).random((Z, Y, X, 3)) < 0.8).astype(np.float64),
                                       device="cuda")
        gd, Fd = g.to(dt), F.to(dt)
        got_m = torch.cat([cuda_stencil.stencil_apply_slab(w, gd[i * Zl : i * Zl + Zl + 2], i * Zl, Z,
                                                           Fd[i * Zl : i * Zl + Zl + 2]) for i in range(n)])
        whole_m = stencil_apply(w, gd[1 : Z + 1].contiguous(), Fd[1 : Z + 1].contiguous())
        assert torch.equal(got_m[:Z], whole_m), (dims, n, key, "masked")
        assert torch.count_nonzero(got_m[Z:]) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 3, 5])
def test_chunked_kernel_is_k2_bitwise_on_card(n):
    """``stencil_apply_chunked`` (n slab launches over views) equals the
    unchunked K1/K2 bit for bit: one kernel body, one FMA order."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K3 has no CPU mode")
    g64 = torch.as_tensor(np.random.default_rng(15).normal(size=(161, 17, 17, 3)), device="cuda")
    for dt, (key, _) in BOUNDS.items():
        w = stencil_weights(_flagship_like_ke(), dt, "cuda")
        g = g64.to(dt).contiguous()
        n0 = cuda_stencil.LAUNCHES["slab_" + key]
        got = cuda_stencil.stencil_apply_chunked(w, g, n)
        torch.cuda.synchronize()
        assert cuda_stencil.LAUNCHES["slab_" + key] == n0 + len(cuda_stencil.z_chunk_bounds(161, n))
        assert torch.equal(got, stencil_apply(w, g)), (n, key)
        F = (g64 > -1.0).to(dt)
        assert torch.equal(cuda_stencil.stencil_apply_chunked(w, g, n, F), stencil_apply(w, g, F)), (n, key, "masked")


@pytest.mark.cuda
def test_zsharded_solve_on_one_card():
    """Four shards on one card against the unsharded voxel solve of the
    same scene: iterations within 1, displacements within 10 tol, and the
    slab kernels launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import fea_tpu_torch as ftt
    from fea_tpu_torch.ops.multigrid import build_multigrid
    from fea_tpu_torch.ops.structured import build_structured_operator, structured_scene
    from fea_tpu_torch.parallel import build_zsharded_solver
    from fea_tpu_torch.solve import solve_operator_fpcg

    scene, dims = structured_scene(8, 8, 64, 0.05, 0.05, 1.0, ftt.Material(E=1e7, nu=0.3),
                                   dtype=torch.float64, device="cuda")
    nodes = scene.host_nodes
    loads = np.zeros_like(nodes)
    loads[nodes[:, 2] == 1.0, 1] = 1.0
    loads = torch.as_tensor(loads, device="cuda")
    op = build_structured_operator(scene, dims, dtype=torch.float64)
    mg = build_multigrid(op.astype(torch.float32), dtype=torch.float32, coarse_dof_limit=300,
                         free_np=1.0 - scene.fixed.cpu().numpy().astype(np.float64))
    ref = solve_operator_fpcg(op, loads, torch.zeros_like(loads), mg, tol=1e-8)
    n0 = dict(cuda_stencil.LAUNCHES)
    sol = build_zsharded_solver(op, mg, ["cuda"] * 4).solve(loads, tol=1e-8)
    torch.cuda.synchronize()
    assert sol.stats.converged and abs(sol.stats.iterations - ref.stats.iterations) <= 1
    du = (sol.displacements - ref.displacements).abs().max() / ref.displacements.abs().max()
    assert float(du) <= 1e-7
    assert all(cuda_stencil.LAUNCHES[k] > n0[k] for k in ("slab_f32", "slab_f64"))


@pytest.mark.cuda
def test_voxel_solve_with_a_row_wider_than_a_block_on_card():
    """A 300x8x8 beam laid along x (301 nodes a row, past the 256 a block
    holds whole) through ``solve``: the voxel route, K1/K2 on row segments,
    against the same solve on the CPU (the plain version)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import fea_tpu_torch as ftt

    nodes, elements = ftt.mesh.box_hex_mesh(300, 8, 8, 3.0, 0.08, 0.08)
    fixed = ftt.fix_where(nodes, lambda p: p[:, 0] == 0.0, 3)
    loads = np.zeros_like(nodes)
    loads[nodes[:, 0] == 3.0, 1] = 1.0
    mat = ftt.Material(E=1e7, nu=0.3)
    sols = {}
    for device in ("cuda", "cpu"):
        scene = ftt.make_scene(nodes, elements, fixed, loads, mat, dtype=torch.float64, device=device)
        n0 = dict(cuda_stencil.LAUNCHES)
        sols[device] = ftt.solve(scene, tol=1e-8)
        if device == "cuda":
            torch.cuda.synchronize()
            assert cuda_stencil.LAUNCHES["f64"] > n0["f64"] and cuda_stencil.LAUNCHES["f32"] > n0["f32"]
    assert sols["cuda"].stats.converged
    assert abs(sols["cuda"].stats.iterations - sols["cpu"].stats.iterations) <= 1
    du = (sols["cuda"].displacements.cpu() - sols["cpu"].displacements).abs().max()
    assert float(du / sols["cpu"].displacements.abs().max()) <= 1e-7


@pytest.mark.cuda
def test_staged_loop_graph_matches_the_eager_loop():
    """The staged FCG loop on the card (one captured step, replayed)
    against the same step run eagerly on the CPU: iterations within one
    (f32 V-cycle sums in another order), displacements within 10 tol; K1
    and K2 credited on every replay; a second solve on the same operator
    and hierarchy captures nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the captured step runs K1 and K2")
    from fea_tpu_torch.mesh import box_hex_mesh
    from fea_tpu_torch.ops.multigrid import build_multigrid
    from fea_tpu_torch.ops.structured import build_structured_operator
    from fea_tpu_torch.scene import fix_where, make_scene
    from fea_tpu_torch.solve import solve_operator_fpcg_staged, staged

    nodes, elements = box_hex_mesh(8, 8, 64, 0.05, 0.05, 1.0)
    fixed = fix_where(nodes, lambda p: p[:, 2] == 0.0, 3)
    loads = np.zeros_like(nodes)
    loads[nodes[:, 2] == 1.0, 1] = 1.0
    sols = {}
    for dev in ("cpu", "cuda"):
        sc = make_scene(nodes, elements, fixed, loads, Material(E=1e7, nu=0.3), dtype=torch.float64, device=dev)
        op = build_structured_operator(sc, (8, 8, 64), dtype=torch.float64)
        mg = build_multigrid(op.astype(torch.float32), dtype=torch.float32, free_np=1.0 - fixed.astype(np.float64),
                             coarse_dof_limit=300)
        for c in (staged.COUNTS, cuda_stencil.LAUNCHES):
            for key in c:
                c[key] = 0
        sols[dev] = solve_operator_fpcg_staged(op, sc.loads, None, mg, tol=1e-8)
        torch.cuda.synchronize()
        if dev == "cuda":
            n = dict(staged.COUNTS)
            assert n["captures"] == 1 and n["past"] <= 1 and n["steps"] >= n["live"]
            assert cuda_stencil.LAUNCHES["f32"] > n["steps"] and cuda_stencil.LAUNCHES["f64"] > n["steps"]
            again = solve_operator_fpcg_staged(op, sc.loads, None, mg, tol=1e-8)
            assert staged.COUNTS["captures"] == 1
            assert torch.equal(again.displacements, sols[dev].displacements)
    cpu, card = sols["cpu"], sols["cuda"]
    assert card.stats.converged and abs(card.stats.iterations - cpu.stats.iterations) <= 1
    u = cpu.displacements
    assert float((card.displacements.cpu() - u).abs().max()) <= 1e-7 * float(u.abs().max())


@pytest.mark.cuda
def test_repeat_voxel_solve_takes_the_cached_build_and_its_graph(monkeypatch):
    """Two ``solve()`` calls on one voxel scene on the card: the second takes
    the build cache's entry and the plan captured over its hierarchy, so it
    captures nothing and its displacements are the first's bit for bit. An
    in-place edit of the nodes on the card misses: it builds anew from a new
    host copy and matches a fresh scene of the edited mesh."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the staged loop captures on the card")
    import dataclasses
    import sys

    import fea_tpu_torch as ftt
    from fea_tpu_torch.mesh import box_hex_mesh
    from fea_tpu_torch.scene import fix_where, make_scene
    from fea_tpu_torch.solve import staged

    monkeypatch.setattr(sys.modules["fea_tpu_torch.solve"], "_STRUCTURED_MIN_DOF", 0)
    monkeypatch.setattr(sys.modules["fea_tpu_torch.solve.cache"], "_BUILD_CACHE", {})
    nodes, elements = box_hex_mesh(8, 8, 64, 0.05, 0.05, 1.0)
    fixed = fix_where(nodes, lambda p: p[:, 2] == 0.0, 3)
    loads = np.zeros_like(nodes)
    loads[nodes[:, 2] == 1.0, 1] = 1.0

    def scene(xyz):
        return make_scene(xyz, elements, fixed, loads, Material(E=1e7, nu=0.3), dtype=torch.float64, device="cuda")

    sc = scene(nodes)
    for key in staged.COUNTS:
        staged.COUNTS[key] = 0
    first = ftt.solve(sc, tol=1e-8)
    again = ftt.solve(dataclasses.replace(sc, loads=sc.loads.clone()), tol=1e-8)
    torch.cuda.synchronize()
    assert first.route == again.route == "fpcg-multigrid" and first.stats.converged
    assert staged.COUNTS["captures"] == 1
    assert torch.equal(again.displacements, first.displacements)
    sc.nodes.mul_(2.0)
    edited = ftt.solve(sc, tol=1e-8)
    fresh = ftt.solve(scene(2.0 * nodes), tol=1e-8)
    torch.cuda.synchronize()
    assert staged.COUNTS["captures"] == 3 and edited.stats.converged
    u = fresh.displacements
    assert float((edited.displacements - u).abs().max()) <= 1e-12 * float(u.abs().max())


def _l_domain(nx, nz, device):
    """An L-domain with interior nodes moved by 0.2 h U(-1, 1) (seed 7),
    z = 0 fixed, a +y load on the tip face, on ``device``."""
    from fea_tpu_torch.mesh import l_hex_mesh
    from fea_tpu_torch.scene import fix_where, make_scene

    lz = 0.1 * nz / nx
    nodes, elements = l_hex_mesh(nx, nx, nz, 0.1, 0.1, lz)
    interior = (nodes[:, 2] > 1e-12) & (nodes[:, 2] < lz - 1e-12)
    nodes = nodes + 0.2 * (0.1 / nx) * np.random.default_rng(7).uniform(-1, 1, nodes.shape) * interior[:, None]
    fixed = fix_where(nodes, lambda q: np.isclose(q[:, 2], 0.0), 3)
    loads = np.zeros_like(nodes)
    tip = np.isclose(nodes[:, 2], lz)
    loads[tip, 1] = 1.0 / tip.sum()
    return make_scene(nodes, elements, fixed, loads, Material(E=1e7, nu=0.3), dtype=torch.float64, device=device)


@pytest.mark.cuda
def test_bcsr_apply_on_card_matches_cpu():
    """The block-CSR assembly and apply (f64 and f32) on the card against
    the same on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from fea_tpu_torch.ops.amg import BCSROperator, assemble_bcsr

    u = np.random.default_rng(8).standard_normal((_l_domain(8, 24, "cpu").n_nodes, 3))
    got = {}
    for dev in ("cpu", "cuda"):
        sc = _l_domain(8, 24, dev)
        h = assemble_bcsr(sc.nodes, sc.elements, sc.material, sc.fixed)
        op = BCSROperator.from_blocks(h.nbr, h.W, h.free, torch.float64)
        x = torch.as_tensor(u, device=dev)
        got[dev] = (op.apply(x).cpu(), op.astype(torch.float32).apply(x.float()).cpu())
    scale = float(got["cpu"][0].abs().max())
    assert float((got["cuda"][0] - got["cpu"][0]).abs().max()) <= 1e-13 * scale
    assert float((got["cuda"][1].double() - got["cpu"][0]).abs().max()) <= 1e-5 * scale


@pytest.mark.cuda
def test_embedded_solve_on_card_matches_cpu(monkeypatch):
    """The embedded route of the small L-domain on the card (K4/K5 on the
    void-masked field, no K1/K2) against the same solve on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the embedded route runs K4 and K5")
    import sys

    import fea_tpu_torch as ftt
    from fea_tpu_torch.ops import cuda_varstencil

    monkeypatch.setattr(sys.modules["fea_tpu_torch.solve"], "_BLOCK_PRECOND_MIN_DOF", 100)
    sols = {}
    for dev in ("cpu", "cuda"):
        for c in (cuda_stencil.LAUNCHES, cuda_varstencil.LAUNCHES):
            for key in c:
                c[key] = 0
        sols[dev] = ftt.solve(_l_domain(8, 24, dev), tol=1e-8)
        torch.cuda.synchronize()
    assert cuda_varstencil.LAUNCHES["var_f64"] > 0
    assert cuda_stencil.LAUNCHES["f32"] == 0 and cuda_stencil.LAUNCHES["f64"] == 0
    cpu, card = sols["cpu"], sols["cuda"]
    assert card.stats.converged and abs(card.stats.iterations - cpu.stats.iterations) <= 1
    u = cpu.displacements
    assert float((card.displacements.cpu() - u).abs().max()) <= 1e-7 * float(u.abs().max())


@pytest.mark.cuda
def test_extruded_solve_on_card_matches_cpu(monkeypatch):
    """The extruded route of a two-level tube on the card (its step
    captured with the section-coarse and z-coarse Thomas sweeps) against
    the same solve on the CPU; a second solve replays the graph bit for
    bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the staged loop captures on the card")
    import sys

    import fea_tpu_torch as ftt
    from fea_tpu_torch.mesh import annulus_section, extrude_quads
    from fea_tpu_torch.scene import fix_where, make_scene
    from fea_tpu_torch.solve import staged

    monkeypatch.setattr(sys.modules["fea_tpu_torch.solve"], "_STRUCTURED_MIN_DOF", 0)
    nodes2d, quads = annulus_section(16, 0.08, 0.1)
    nodes, elements = extrude_quads(nodes2d, quads, np.linspace(0.0, 0.6, 65))
    fixed = fix_where(nodes, lambda p: p[:, 2] == 0.0, 3)
    loads = np.zeros_like(nodes)
    loads[nodes[:, 2] == nodes[:, 2].max(), 1] = 1.0
    sols = {}
    for dev in ("cpu", "cuda"):
        sc = make_scene(nodes, elements, fixed, loads, Material(E=2e6, nu=0.3), dtype=torch.float64, device=dev)
        for key in staged.COUNTS:
            staged.COUNTS[key] = 0
        sols[dev] = ftt.solve(sc, tol=1e-10)
        torch.cuda.synchronize()
        if dev == "cuda":
            assert staged.COUNTS["captures"] == 1
            again = ftt.solve(sc, tol=1e-10)
            assert staged.COUNTS["captures"] == 1 and torch.equal(again.displacements, sols[dev].displacements)
    cpu, card = sols["cpu"], sols["cuda"]
    assert card.stats.converged and abs(card.stats.iterations - cpu.stats.iterations) <= 1
    u = cpu.displacements
    assert float((card.displacements.cpu() - u).abs().max()) <= 1e-7 * float(u.abs().max())


@pytest.mark.cuda
def test_refined_solve_on_card_runs_k1_inside_and_k2_outside():
    """Mixed-precision refinement on the card at small size: the f64 outer
    apply is K2, the f32 inner PCG K1 (masked), nothing else launched;
    against the same solve on the CPU (inner totals within 10%, outer
    residual and displacements at the level of tol); the sanitizer's
    kernel check sees K1/K2's output on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1 and K2 have no CPU mode")
    import fea_tpu_torch as ftt
    from fea_tpu_torch import sanitize
    from fea_tpu_torch.ops import cuda_apply, cuda_varstencil
    from fea_tpu_torch.ops.structured import build_structured_operator, structured_scene

    mat = Material(E=10_000_000 * ftt.units.psi, nu=0.3)
    sols = {}
    for dev in ("cpu", "cuda"):
        scene, dims = structured_scene(4, 4, 32, 0.05, 0.05, 1.0, mat, dtype=torch.float64, device=dev)
        loads = torch.zeros_like(scene.loads)
        tip = scene.nodes[:, 2] == 1.0
        loads[tip, 1] = 100.0 / int(tip.sum())
        op_hi = build_structured_operator(scene, dims, dtype=torch.float64)
        counters = (cuda_stencil.LAUNCHES, cuda_varstencil.LAUNCHES, cuda_apply.LAUNCHES)
        for c in counters:
            for k in c:
                c[k] = 0
        sols[dev] = ftt.solve_operator_refined(op_hi, op_hi.astype(torch.float32), loads, torch.zeros_like(loads),
                                               tol=1e-9, inner_tol=1e-2, inner_iters=3000)
        torch.cuda.synchronize()
        if dev == "cuda":
            counts = {k: v for c in counters for k, v in c.items()}
            st = sols[dev].stats
            assert counts["f32"] >= st.iterations and counts["f64"] >= 2
            assert all(v == 0 for k, v in counts.items() if k not in ("f32", "f64"))
            b = op_hi.rhs(loads, torch.zeros_like(loads))
            with sanitize.debug_nans():  # K2's output checked, nothing raised on a clean apply
                assert float((b - op_hi.apply(sols[dev].displacements)).norm() / b.norm()) < 1e-9
    cpu, card = sols["cpu"], sols["cuda"]
    assert card.stats.converged and card.stats.relative_residual < 1e-9
    assert abs(card.stats.iterations - cpu.stats.iterations) <= 0.1 * cpu.stats.iterations
    u = cpu.displacements
    assert float((card.displacements.cpu() - u).abs().max()) <= 1e-7 * float(u.abs().max())


@pytest.mark.cuda
def test_curvilinear_coarse_inverse_is_made_on_the_card(tmp_path):
    """The distorted 40x40x160 hierarchy built on the card (coarsest level
    5x5x20, 2,268 DOF): its coarsest inverse stays on the card and matches
    NumPy's inverse of the same dense matrix, the build counts one Cholesky
    inverse, and under ``torch.profiler`` no host-to-card copy of an n x n
    matrix runs inside ``fea.build.curv.coarse``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import json

    import fea_tpu_torch as ftt
    from fea_tpu_torch.ops import curvilinear as cv
    from fea_tpu_torch.utils import counters

    nodes, elements = ftt.mesh.box_hex_mesh(40, 40, 160, 0.1, 0.1, 1.0)
    interior = (nodes[:, 2] > 0) & (nodes[:, 2] < 1.0)
    nodes = nodes + 0.25 * (0.1 / 40) * np.random.default_rng(12).uniform(-1, 1, nodes.shape) * interior[:, None]
    fixed = ftt.fix_where(nodes, lambda p: p[:, 2] == 0.0, 3)
    scene = ftt.make_scene(nodes, elements, fixed, np.zeros_like(nodes), ftt.Material(E=1e7, nu=0.3),
                           dtype=torch.float64, device="cuda")
    op = cv.build_curv_operator(scene, (40, 40, 160), dtype=torch.float64)
    free = 1.0 - fixed.astype(np.float64)
    cv.build_curv_multigrid(op.w, (40, 40, 160), free)  # the process's first factorization, outside the trace
    before = counters()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        mg = cv.build_curv_multigrid(op.w, (40, 40, 160), free)
        torch.cuda.synchronize()
    after = counters()
    assert {k: after.get(k, 0) - before.get(k, 0) for k in ("curv.coarse.cholesky", "curv.coarse.lu")} == {
        "curv.coarse.cholesky": 1, "curv.coarse.lu": 0}
    level = mg.levels[-1]
    n = 3 * int(np.prod([s + 1 for s in level.dims]))
    assert level.dims == (5, 5, 20) and n == 2268
    assert mg.coarse_inv.device.type == "cuda" and mg.coarse_inv.shape == (n, n)
    K = cv._dense_from_w(level.w, level.free).cpu().numpy()
    want = np.linalg.inv(K)
    assert np.abs(mg.coarse_inv.cpu().numpy() - want).max() <= 1e-10 * np.abs(want).max()

    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    (coarse,) = [e for e in events if e.get("cat") == "user_annotation" and e["name"] == "fea.build.curv.coarse"]
    inside = {e["args"]["correlation"] for e in events
              if e.get("cat") == "cuda_runtime" and coarse["ts"] <= e["ts"] <= coarse["ts"] + coarse["dur"]}
    on_card = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy")
               and e.get("args", {}).get("correlation") in inside]
    assert any(e["cat"] == "kernel" for e in on_card)  # the span's work was traced
    assert not [e for e in on_card
                if e["cat"] == "gpu_memcpy" and "HtoD" in e["name"] and e["args"].get("bytes", 0) >= n * n * 8]


def _distorted_box(nx, ny, nz, seed):
    """Host nodes of a box grid of cubes of side 0.1 / nx, every node off
    the z faces moved by a quarter cell on each axis (tools/curv_bench.py's
    distortion)."""
    h = 0.1 / nx
    nodes, _ = box_hex_mesh(nx, ny, nz, 0.1, h * ny, h * nz)
    interior = (nodes[:, 2] > 0) & (nodes[:, 2] < h * nz - h / 2)
    return nodes + 0.25 * h * np.random.default_rng(seed).uniform(-1, 1, nodes.shape) * interior[:, None]


@pytest.mark.cuda
@pytest.mark.parametrize("dims", [(5, 4, 1), (3, 5, 7), (1, 6, 4), (7, 1, 2), (40, 40, 16), (6, 5, 7)],
                         ids=["one-layer", "odd", "x-of-1", "y-of-1", "quarter-cell", "embedded"])
def test_curvilinear_weights_kernel_matches_plain_version_on_card(dims, monkeypatch):
    """The assembly kernel (8 parity-coloured launches) against the plain
    chunked assembly run on the card, each symmetrized: f64 within 1e-12
    of the plain field's largest entry (another summation order), f32
    within 1e-5 of it (f32 rounding in another order); the field exactly block-symmetric; two calls bitwise
    equal; the least detJ within 1e-12; 8 launches an assembly, and no
    batched Ke on the card. The embedded case takes a void mask whose void
    cells hold a degenerate one (void-only nodes moved onto one point):
    their weights are exactly zero and the field is bitwise the one with
    those nodes on the lattice."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the assembly kernel has no CPU mode")
    from fea_tpu_torch.ops import cuda_curv_weights
    from fea_tpu_torch.ops import curvilinear as cv

    nx, ny, nz = dims
    mat = Material(E=1e7, nu=0.3)
    host = _distorted_box(nx, ny, nz, 14)
    valid = None
    if dims == (6, 5, 7):
        valid = (np.random.default_rng(15).random((nz, ny, nx)) < 0.7).astype(np.uint8)
        valid[:, :, :2] = 0  # cells with x < 2: their nodes x <= 1 touch no live cell
    nodes = torch.as_tensor(host, device="cuda")
    plain = {dt: cv.assemble_curv_weights_plain(nodes, dims, mat, dtype=dt, valid=valid)
             for dt in (torch.float64, torch.float32)}

    def no_batched_ke(*_):
        raise AssertionError("batched_ke ran on the card")

    monkeypatch.setattr(cv, "batched_ke", no_batched_ke)
    want = cv.symmetrize_field(plain[torch.float64][0])
    scale = float(want.abs().max())
    n0 = dict(cuda_curv_weights.LAUNCHES)
    w, mdj = cv.assemble_curv_weights(nodes, dims, mat, valid=valid)
    again, mdj2 = cv.assemble_curv_weights(nodes, dims, mat, valid=valid)
    torch.cuda.synchronize()
    assert cuda_curv_weights.LAUNCHES["weights_f64"] == n0["weights_f64"] + 16
    assert w.dtype == torch.float64 and w.shape == want.shape
    assert float((w - want).abs().max()) <= 1e-12 * scale, dims
    assert cv.mirror_defect(w) == 0.0
    assert torch.equal(w, again) and torch.equal(mdj, mdj2)
    assert mdj.ndim == 0 and mdj.device.type == "cuda"
    assert abs(float(mdj) - float(plain[torch.float64][1])) <= 1e-12 * abs(float(plain[torch.float64][1]))
    w32, mdj32 = cv.assemble_curv_weights(nodes, dims, mat, dtype=torch.float32, valid=valid)
    torch.cuda.synchronize()
    assert cuda_curv_weights.LAUNCHES["weights_f32"] == n0["weights_f32"] + 8
    want32, want_mdj32 = cv.symmetrize_field(plain[torch.float32][0]), float(plain[torch.float32][1])
    assert w32.dtype == torch.float32 and cv.mirror_defect(w32) == 0.0
    assert float((w32 - want32).abs().max()) <= 1e-5 * scale, dims
    assert abs(float(mdj32) - want_mdj32) <= 1e-5 * abs(want_mdj32)
    if valid is not None:
        Z, Y, X = nz + 1, ny + 1, nx + 1
        touched = np.zeros((Z, Y, X), bool)
        for az in (0, 1):
            for ay in (0, 1):
                for ax in (0, 1):
                    touched[az : az + nz, ay : ay + ny, ax : ax + nx] |= valid.astype(bool)
        assert (~touched).any() and not w[..., torch.as_tensor(~touched, device="cuda")].any()
        degenerate = host.copy()
        degenerate[(~touched).reshape(-1)] = host[(~touched).reshape(-1)][0]
        w_deg, mdj_deg = cv.assemble_curv_weights(torch.as_tensor(degenerate, device="cuda"), dims, mat, valid=valid)
        assert torch.equal(w_deg, w) and torch.equal(mdj_deg, mdj)


@pytest.mark.cuda
def test_fresh_curvilinear_solves_assemble_by_the_kernel(monkeypatch):
    """Two ``solve()`` calls on two fresh distorted meshes (the curvilinear
    route, 56,355 DOF) each run the assembly kernel's 8 launches and no
    batched Ke on the card; an inverted element makes
    ``build_curv_operator`` raise ValueError on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import fea_tpu_torch as ftt
    from fea_tpu_torch.ops import cuda_curv_weights
    from fea_tpu_torch.ops import curvilinear as cv

    def no_batched_ke(*_):
        raise AssertionError("batched_ke ran on the card")

    monkeypatch.setattr(cv, "batched_ke", no_batched_ke)
    dims = (16, 16, 64)
    for seed in (16, 17):
        nodes = _distorted_box(*dims, seed)
        _, elements = box_hex_mesh(*dims, 0.1, 0.1, 0.4)
        fixed = ftt.fix_where(nodes, lambda p: p[:, 2] == 0.0, 3)
        loads = np.zeros_like(nodes)
        loads[np.isclose(nodes[:, 2], 0.4), 1] = 1.0
        scene = ftt.make_scene(nodes, elements, fixed, loads, ftt.Material(E=1e7, nu=0.3), dtype=torch.float64,
                               device="cuda")
        n0 = cuda_curv_weights.LAUNCHES["weights_f64"]
        sol = ftt.solve(scene, tol=1e-8)
        torch.cuda.synchronize()
        assert sol.stats.converged and sol.route == "fpcg-curvilinear-multigrid"
        assert cuda_curv_weights.LAUNCHES["weights_f64"] == n0 + 8

    nodes = _distorted_box(3, 3, 3, 18)
    _, elements = box_hex_mesh(3, 3, 3, 0.1, 0.1, 0.1)
    inner = int(np.argmin(np.abs(nodes - 0.05).sum(axis=1)))  # an interior node
    nodes[inner, 0] += 0.1  # past its neighbours: the elements around it invert
    scene = ftt.make_scene(nodes, elements, np.zeros(nodes.shape, bool), np.zeros_like(nodes),
                           ftt.Material(E=1e7, nu=0.3), dtype=torch.float64, device="cuda")
    with pytest.raises(ValueError, match="Jacobian"):
        cv.build_curv_operator(scene, (3, 3, 3))


def _thomas_factors(L, b, seed, device):
    """Random f32 Thomas factors (Uinv symmetric positive definite, ||G_l||
    about 0.5, so that neither sweep amplifies rounding) and a right-hand
    side, on ``device``."""
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(L, b, b))
    uinv = (M + M.transpose(0, 2, 1)) / (2.0 * np.sqrt(b)) + 2.0 * np.eye(b)  # symmetric, as built
    G = rng.normal(size=(L - 1, b, b)) * (0.25 / np.sqrt(b))
    rf = rng.normal(size=(L, b))
    return tuple(torch.as_tensor(a, dtype=torch.float32, device=device) for a in (uinv, G, rf))


@pytest.mark.cuda
@pytest.mark.parametrize("L,b", [(385, 168), (1, 6), (2, 6), (2, 2), (3, 174), (17, 96), (40, 34), (9, 256),
                                 (64, 250)])
def test_thomas_kernel_matches_the_addmv_chain_on_card(L, b):
    """The block-Thomas kernel (one launch) against the plain version's
    ``addmv_`` chain on the same f32 factors, both within f32 rounding of
    the chain run in f64: the tube's own shape (385 layers of 168), one and
    two layers, blocks of 2 and 6 (most of the cluster's blocks own no
    rows), and widths that are no multiple of 32 or whose row slices need
    the rows rounded up (174, 250: b = 2 mod 4)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Thomas kernel has no CPU mode")
    from fea_tpu_torch.ops import cuda_thomas, extruded_mg

    uinv, G, rf = _thomas_factors(L, b, 25 + L + b, "cuda")
    assert cuda_thomas.takes(uinv, G, rf)
    n0 = dict(extruded_mg.LAUNCHES)
    got = extruded_mg._thomas_solve(uinv, G, rf)
    torch.cuda.synchronize()
    assert extruded_mg.LAUNCHES["thomas_kernel"] == n0["thomas_kernel"] + 1
    assert extruded_mg.LAUNCHES["thomas"] == n0["thomas"] + 1
    chain = extruded_mg._thomas_addmv(uinv, G, rf)
    want = extruded_mg._thomas_addmv(uinv.double(), G.double(), rf.double())
    scale = float(want.abs().max())
    err = float((got.double() - want).abs().max()) / scale
    err_chain = float((chain.double() - want).abs().max()) / scale
    assert err <= 1e-5 and err_chain <= 1e-5, (L, b, err, err_chain)


@pytest.mark.cuda
def test_thomas_kernel_gives_the_same_bits_twice_and_in_a_graph():
    """Two calls, and two replays of one captured graph, give the kernel's
    answer bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Thomas kernel has no CPU mode")
    from fea_tpu_torch.ops import extruded_mg

    uinv, G, rf = _thomas_factors(385, 168, 2025, "cuda")
    first = extruded_mg._thomas_solve(uinv, G, rf)
    second = extruded_mg._thomas_solve(uinv, G, rf)
    assert torch.equal(first, second)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        extruded_mg._thomas_solve(uinv, G, rf)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = extruded_mg._thomas_solve(uinv, G, rf)
    graph.replay()
    a = out.clone()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(a, out) and torch.equal(a, first)


@pytest.mark.cuda
def test_wide_z_coarse_blocks_keep_the_addmv_chain_on_card():
    """Blocks of 1536 (the tube's z-coarsest level) are past the kernel's
    width: the solve is the ``addmv_`` chain, 2 (L - 1) launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from fea_tpu_torch.ops import cuda_thomas, extruded_mg

    uinv, G, rf = _thomas_factors(3, 1536, 26, "cuda")
    assert not cuda_thomas.takes(uinv, G, rf)
    n0 = dict(extruded_mg.LAUNCHES)
    got = extruded_mg._thomas_solve(uinv, G, rf)
    assert extruded_mg.LAUNCHES["thomas"] == n0["thomas"] + 4
    assert extruded_mg.LAUNCHES["thomas_kernel"] == n0["thomas_kernel"]
    assert torch.equal(got, extruded_mg._thomas_addmv(uinv, G, rf))


@pytest.mark.cuda
def test_extruded_solve_takes_the_thomas_kernel_on_card(monkeypatch):
    """A 48-segment tube (17,280 DOF) through ``solve()`` on the card: the
    extruded route, the CPU's answer (the existing extruded test's
    tolerance), and a replay's Thomas launches: the section coarse solve
    (blocks of 6 x aggregates) one kernel launch, the z-coarsest level
    (blocks of 288, past the kernel's width) 2 (Lc - 1) ``addmv_``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the staged loop captures on the card")
    import sys

    import fea_tpu_torch as ftt
    from fea_tpu_torch.mesh import annulus_section, extrude_quads
    from fea_tpu_torch.ops import extruded_mg
    from fea_tpu_torch.scene import fix_where, make_scene
    from fea_tpu_torch.solve import staged

    monkeypatch.setattr(sys.modules["fea_tpu_torch.solve"], "_STRUCTURED_MIN_DOF", 0)
    monkeypatch.setattr(sys.modules["fea_tpu_torch.solve.cache"], "_BUILD_CACHE", {})
    nodes2d, quads = annulus_section(48, 0.08, 0.1)
    nodes, elements = extrude_quads(nodes2d, quads, np.linspace(0.0, 0.6, 61))
    fixed = fix_where(nodes, lambda p: p[:, 2] == 0.0, 3)
    loads = np.zeros_like(nodes)
    loads[nodes[:, 2] == nodes[:, 2].max(), 1] = 1.0
    sols = {}
    for dev in ("cpu", "cuda"):
        sc = make_scene(nodes, elements, fixed, loads, Material(E=2e6, nu=0.3), dtype=torch.float64, device=dev)
        sols[dev] = ftt.solve(sc, tol=1e-10)
        torch.cuda.synchronize()
    assert sols["cuda"].route == "fpcg-extruded-multigrid"
    _, pc = sys.modules["fea_tpu_torch.solve.cache"]._BUILD_CACHE[("extruded", 3)][-1][2]  # the card's build
    Lc, b_z = pc.mg.thomas_uinv.shape[:2]
    assert pc.sc.thomas_uinv.shape[1] <= 256 < b_z
    for c in (staged.COUNTS, extruded_mg.LAUNCHES):
        for key in c:
            c[key] = 0
    again = ftt.solve(sc, tol=1e-10)
    torch.cuda.synchronize()
    steps = staged.COUNTS["steps"]
    assert staged.COUNTS["captures"] == 0 and steps > 0
    assert extruded_mg.LAUNCHES["thomas_kernel"] == steps
    assert extruded_mg.LAUNCHES["thomas"] == steps * (1 + 2 * (Lc - 1))
    assert torch.equal(again.displacements, sols["cuda"].displacements)
    cpu, card = sols["cpu"], sols["cuda"]
    assert card.stats.converged and abs(card.stats.iterations - cpu.stats.iterations) <= 1
    u = cpu.displacements
    assert float((card.displacements.cpu() - u).abs().max()) <= 1e-7 * float(u.abs().max())


# E on the card: the tube's five level shapes (385 to 25 node layers of a
# 256-segment annulus, valence 2), a rectangular section of valence 4 at a
# width of one and of two layers a lane, and operators of two layers
EXTRUDED_SECTIONS = {"tube": lambda: annulus_section(256, 0.09906, 0.1016),
                     "grid": lambda: generate_quad_grid(16, 12, 0.1, 0.08)}
EXTRUDED_CASES = [("tube", 385), ("tube", 193), ("tube", 97), ("tube", 49), ("tube", 25), ("tube", 2),
                  ("grid", 70), ("grid", 130), ("grid", 2)]
# f32: rounding of the inputs, Ke and sums of 2 x valence x 24 products, as
# K1's bound; f64: another summation order than the plain version's cuBLAS
EXTRUDED_BOUNDS = {torch.float32: 2e-5, torch.float64: 1e-12}


def _extruded_op(section: str, L: int, dtype, seed: int):
    """An extruded operator on the card: random symmetric Ke a section quad
    and a random 0/1 free mask (the apply's arithmetic needs no geometry)."""
    from fea_tpu_torch.ops.extruded import _make

    nodes2d, quads = EXTRUDED_SECTIONS[section]()
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(quads.shape[0], 24, 24))
    n2 = nodes2d.shape[0]
    free = (rng.random((n2 * L, 3)) > 0.1).astype(np.float64)
    op = _make(M + M.transpose(0, 2, 1), np.asarray(quads, np.int64), free, n2, L, dtype, torch.device("cuda"))
    x = torch.as_tensor(rng.normal(size=(n2 * L, 3)), dtype=dtype, device="cuda")
    return op, x


@pytest.mark.cuda
@pytest.mark.parametrize("section,L", EXTRUDED_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_extruded_apply_kernel_matches_the_plain_version_on_card(section, L, dtype):
    """E, masked and raw, against the plain version run in f64 on the card
    on the same (rounded) Ke and input; one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: kernel E has no CPU mode")
    from fea_tpu_torch.ops import cuda_extruded

    op, x = _extruded_op(section, L, dtype, 27 + L)
    op64, x64 = op.astype(torch.float64), x.double()
    F = op64.free

    def plain(u):
        return op64._accumulate(op64._element_forces(u.reshape(L, op.n2, 3))).reshape(-1, 3)

    key = "apply_f32" if dtype == torch.float32 else "apply_f64"
    n0 = cuda_extruded.LAUNCHES[key]
    for masked in (True, False):
        got = op.apply(x) if masked else op.apply_raw(x)
        torch.cuda.synchronize()
        want = F * plain(F * x64) + (1.0 - F) * x64 if masked else plain(x64)
        err = float((got.double() - want).abs().max()) / float(want.abs().max())
        assert got.dtype == dtype and got.shape == x.shape
        assert err <= EXTRUDED_BOUNDS[dtype], (section, L, dtype, masked, err)
    assert cuda_extruded.LAUNCHES[key] == n0 + 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_extruded_apply_kernel_gives_the_same_bits_twice_and_in_a_graph(dtype):
    """Two calls, and two replays of one captured launch, give E's answer
    bit for bit at the tube's finest shape."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: kernel E has no CPU mode")
    op, x = _extruded_op("tube", 385, dtype, 2027)
    first = op.apply(x)
    assert torch.equal(first, op.apply(x))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        op.apply(x)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = op.apply(x)
    graph.replay()
    a = out.clone()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(a, out) and torch.equal(a, first)


@pytest.mark.cuda
def test_extruded_solve_takes_the_apply_kernel_on_card(monkeypatch):
    """A 48-segment tube (17,280 DOF) through ``solve()`` on the card: every
    apply of a replay is E (2 x degree + 1 f32 launches a smoothed level, and
    the FCG's and the composition's f64 ones), the answer the CPU's (the
    extruded tests' tolerance) in no more iterations than the CPU's plain
    version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the staged loop captures on the card")
    import sys

    import fea_tpu_torch as ftt
    from fea_tpu_torch.mesh import extrude_quads
    from fea_tpu_torch.ops import cuda_extruded
    from fea_tpu_torch.scene import fix_where, make_scene
    from fea_tpu_torch.solve import staged

    monkeypatch.setattr(sys.modules["fea_tpu_torch.solve"], "_STRUCTURED_MIN_DOF", 0)
    monkeypatch.setattr(sys.modules["fea_tpu_torch.solve.cache"], "_BUILD_CACHE", {})
    nodes2d, quads = annulus_section(48, 0.08, 0.1)
    nodes, elements = extrude_quads(nodes2d, quads, np.linspace(0.0, 0.6, 61))
    fixed = fix_where(nodes, lambda p: p[:, 2] == 0.0, 3)
    loads = np.zeros_like(nodes)
    loads[nodes[:, 2] == nodes[:, 2].max(), 1] = 1.0
    sols = {}
    for dev in ("cpu", "cuda"):
        sc = make_scene(nodes, elements, fixed, loads, Material(E=2e6, nu=0.3), dtype=torch.float64, device=dev)
        sols[dev] = ftt.solve(sc, tol=1e-10)
        torch.cuda.synchronize()
    assert sols["cuda"].route == "fpcg-extruded-multigrid"
    _, pc = sys.modules["fea_tpu_torch.solve.cache"]._BUILD_CACHE[("extruded", 3)][-1][2]  # the card's build
    for c in (staged.COUNTS, cuda_extruded.LAUNCHES):
        for key in c:
            c[key] = 0
    again = ftt.solve(sc, tol=1e-10)
    torch.cuda.synchronize()
    steps = staged.COUNTS["steps"]
    assert staged.COUNTS["captures"] == 0 and steps > 0
    assert cuda_extruded.LAUNCHES["apply_f32"] == steps * (2 * pc.mg.degree + 1) * len(pc.mg.levels)
    # a replay's two; outside the steps the right-hand side, the reactions and certification's residuals
    assert 2 * steps + 2 <= cuda_extruded.LAUNCHES["apply_f64"] <= 2 * steps + 8
    assert torch.equal(again.displacements, sols["cuda"].displacements)
    cpu, card = sols["cpu"], sols["cuda"]
    assert card.stats.converged and card.stats.iterations <= cpu.stats.iterations
    u = cpu.displacements
    assert float((card.displacements.cpu() - u).abs().max()) <= 1e-7 * float(u.abs().max())
