"""The block-symmetric weight fields that K4/K5 read half of.

K4/K5 read the 14 upper blocks of a curvilinear weight field and take the
13 lower ones as their transposes at the neighbour (``W_{26-d}[n + d] =
W_d[n]^T``). Here, on the CPU: ``symmetrize_field`` moves an assembled
field by rounding only and makes the mirror exact; every producer of the
port hands the kernels an exactly mirrored field; the plain twin of the
kernels' read pattern (``curv_apply_grid_sym`` and its slab form, kept
here) is the plain version value for value on such fields, agrees with
JAX's Pallas kernels in interpret mode, and never reads a lower block;
the operator and the hierarchy refuse a field that is not mirrored; the masked
apply (``var_apply_masked``, the entry the operators now call) is JAX's
masked curvilinear apply.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fea_tpu as ft
from fea_tpu.ops import curvilinear as jcv

import fea_tpu_torch as ftt
from fea_tpu_torch.ops import cuda_varstencil as vs
from fea_tpu_torch.ops import curvilinear as cv
from fea_tpu_torch.parallel import curv as pcurv
from fea_tpu_torch.solve import embed

from test_torch_curvilinear import MAT, distorted
from torch_pin import one_torch_thread  # noqa: F401


DIMS = (3, 4, 6)


def _upper_read(w: torch.Tensor, slab: bool):
    """The 27 blocks of w (27, 3, 3, Z, Y, X) as K4/K5 read them: an upper
    block (index >= 13) as stored, a lower block d at n as the transpose of
    block 26 - d at n + d (zero toward a neighbour outside the grid, which
    the state's padding meets anyway), and, for a slab, the dz = -1 blocks
    of its first plane as stored (their mirrors lie on the neighbouring
    shard)."""
    Z, Y, X = w.shape[3:]
    for d in range(27):
        if d >= 13:
            yield w[d]
            continue
        m = torch.zeros_like(w[d])
        at, nb = zip(*(cv._in_grid(o, n) for o, n in zip(cv._OFFSETS[d], (Z, Y, X))))
        m[(slice(None), slice(None)) + at] = w[(26 - d, slice(None), slice(None)) + nb].transpose(0, 1)
        if slab and cv._OFFSETS[d][0] == -1:
            m[:, :, 0] = w[d][:, :, 0]
        yield m


def _apply_blocks(blocks, gp: torch.Tensor) -> torch.Tensor:
    """``curvilinear._apply_padded`` over the 27 (3, 3, Z, Y, X) blocks
    ``blocks`` yields, in offset order, and the padded state gp."""
    Z, Y, X = (n - 2 for n in gp.shape[1:])
    out = torch.zeros((3, Z, Y, X), dtype=gp.dtype)
    for (dz, dy, dx), wd in zip(cv._OFFSETS, blocks):
        out += (wd * gp[None, :, 1 + dz : 1 + dz + Z, 1 + dy : 1 + dy + Y, 1 + dx : 1 + dx + X]).sum(dim=1)
    return out.permute(1, 2, 3, 0).contiguous()


def curv_apply_grid_sym(w: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The plain twin of K4/K5's read pattern: ``curv_apply_grid`` reading
    the 14 upper blocks and the transposes of those for the 13 lower
    offsets, summed in ``curv_apply_grid``'s offset order (the kernels sum
    the same terms in pairs). It checks the mirrored index arithmetic, not
    the kernels' rounding."""
    return _apply_blocks(_upper_read(w, slab=False), torch.nn.functional.pad(g.permute(3, 0, 1, 2), (1,) * 6))


def curv_apply_slab_grid_sym(w: torch.Tensor, g_ext: torch.Tensor) -> torch.Tensor:
    """``curv_apply_slab_grid`` reading what K4-slab/K5-slab read: the upper
    blocks, their transposes, and the slab's own dz = -1 blocks on its
    first plane."""
    return _apply_blocks(_upper_read(w, slab=True), torch.nn.functional.pad(g_ext.permute(3, 0, 1, 2), (1,) * 4))


def random_symmetric(rng, Z, Y, X, *, zero_z_ends=False) -> torch.Tensor:
    """``symmetrize_field`` of a random f64 field; with ``zero_z_ends``, its
    blocks toward the planes past the z ends zeroed first, as an assembled
    field has them (the slab kernels' contract)."""
    w = torch.as_tensor(rng.standard_normal((27, 3, 3, Z, Y, X)))
    if zero_z_ends:
        w[:9, :, :, 0] = 0.0
        w[18:, :, :, -1] = 0.0
    return cv.symmetrize_field(w)


@pytest.mark.parametrize("chunk_elems", [24, 8192], ids=["slabs", "whole"])
def test_symmetrize_moves_assembled_field_by_rounding(chunk_elems, monkeypatch):
    """The port's assembly before ``symmetrize_field`` (the function
    patched out) is block-symmetric to within 1e-14 of its largest value,
    and the same assembly with it is exactly so and within that of the
    unsymmetrized field; the upper blocks are untouched."""
    nodes = distorted(*DIMS)[0]
    sym, _ = cv.assemble_curv_weights(torch.as_tensor(nodes), DIMS, ftt.Material(**MAT), chunk_elems=chunk_elems)
    monkeypatch.setattr(cv, "symmetrize_field", lambda w: w)
    raw, _ = cv.assemble_curv_weights(torch.as_tensor(nodes), DIMS, ftt.Material(**MAT), chunk_elems=chunk_elems)
    scale = float(raw.abs().max())
    assert 0.0 < cv.mirror_defect(raw) <= 1e-14 * scale
    assert cv.mirror_defect(sym) == 0.0
    assert float((sym - raw).abs().max()) <= 1e-14 * scale
    assert torch.equal(sym[13:], raw[13:])


def test_symmetrize_moves_the_reference_field_by_rounding():
    """The JAX package's host assembly, brought in by ``from_numpy``, moves
    by rounding only and leaves exactly mirrored."""
    w_np = jcv.assemble_curv_weights_np(distorted(*DIMS)[0], DIMS, ft.Material(**MAT))
    raw = torch.as_tensor(np.ascontiguousarray(w_np.transpose(0, 4, 5, 1, 2, 3)))
    op = cv.CurvilinearOperator.from_numpy(w_np, np.ones((raw[0, 0, 0].numel(), 3)), device="cpu")
    scale = float(raw.abs().max())
    assert cv.mirror_defect(raw) <= 1e-14 * scale
    assert cv.mirror_defect(op.w) == 0.0 and float((op.w - raw).abs().max()) <= 1e-14 * scale


def _producer_fields(name: str) -> list[torch.Tensor]:
    """The fields producer ``name`` hands K4/K5."""
    nodes = distorted(*DIMS)[0]
    if name in ("assembly-slabs", "assembly-whole"):
        chunk = 24 if name == "assembly-slabs" else 8192
        return [cv.assemble_curv_weights(torch.as_tensor(nodes), DIMS, ftt.Material(**MAT), chunk_elems=chunk)[0]]
    if name == "embedded":
        from test_torch_embed import l_arrays, scene_of
        from fea_tpu_torch.ops.canonical import infer_subgrid_embedding

        scene = scene_of(*l_arrays(4, 8)[:4])
        det = infer_subgrid_embedding(scene)
        assert not det[2].all()  # void cells
        _, op, mg, _ = embed.build_subgrid_embedded(scene, det)
        return [op.w] + [lv.w for lv in mg.levels]
    if name in ("rap-full", "rap-semi"):
        dims = (8, 8, 32) if name == "rap-full" else (10, 9, 32)
        nd, _, fx, _ = distorted(*dims)
        op = cv.assemble_curv_weights(torch.as_tensor(nd), dims, ftt.Material(**MAT))[0]
        mg = cv.build_curv_multigrid(op, dims, 1.0 - fx.astype(np.float64), f64_below_dof=1000)
        assert len(mg.levels) >= 2 and any(len(a) < 3 for a in mg.coarsen_axes) == (name == "rap-semi")
        return [lv.w for lv in mg.levels]
    if name == "from_numpy":
        dims = (8, 8, 32)
        nd, el, fx, ld = distorted(*dims)
        jsc = ft.make_scene(nd, el, fx, ld, ft.Material(**MAT), dtype=jnp.float64)
        jop = jcv.build_curv_operator(jsc, dims, dtype=jnp.float64)
        mg_j = jcv.build_curv_multigrid(nd, dims, 1.0 - fx.astype(np.float64), jsc.material, w0=jop.w,
                                        degree=2, f64_below_dof=1000)
        levels = [dict(w=np.asarray(lv.w), free=np.asarray(lv.free), inv_diag=np.asarray(lv.inv_diag),
                       lam=float(lv.lam_max), dims=lv.dims, dtype=np.asarray(lv.w).dtype) for lv in mg_j.levels]
        mg = cv.CurvMultigrid.from_numpy(levels, np.asarray(mg_j.coarse_inv), mg_j.coarsen_axes, device="cpu")
        op = cv.CurvilinearOperator.from_numpy(np.asarray(jop.w), np.asarray(jop.free), device="cpu")
        return [op.w] + [lv.w for lv in mg.levels]
    assert name == "weight-slabs"
    w = cv.assemble_curv_weights(torch.as_tensor(nodes), DIMS, ftt.Material(**MAT))[0]
    return pcurv._weight_slabs(w, ["cpu"] * 3, 3)


@pytest.mark.parametrize("name", ["assembly-slabs", "assembly-whole", "embedded", "rap-full", "rap-semi",
                                  "from_numpy", "weight-slabs"])
def test_every_producer_hands_the_kernels_a_mirrored_field(name):
    """Each field a producer makes equals its mirror exactly, in its own
    dtype: what K4/K5 read of it is the field. A slab is mirrored within
    itself (its first plane's lower blocks are read as stored)."""
    fields = _producer_fields(name)
    assert fields
    for w in fields:
        assert cv.mirror_defect(w) == 0.0, (name, tuple(w.shape), w.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_sym_twin_is_the_plain_version_and_jax(dtype):
    """``curv_apply_grid_sym`` (the kernels' read pattern) equals
    ``curv_apply_grid`` value for value on a symmetrized field (random and
    assembled), and agrees with JAX's ``var_apply_transposed`` /
    ``var_apply_transposed_dd`` (interpret mode) within
    ``test_var_apply_plain_matches_jax``'s tolerances."""
    from fea_tpu.ops import pallas_varstencil as pv

    nx, ny, nz = DIMS
    rng = np.random.default_rng(41)
    g64 = rng.standard_normal((nz + 1, ny + 1, nx + 1, 3))
    g = torch.as_tensor(g64).to(dtype)
    for w in (random_symmetric(rng, nz + 1, ny + 1, nx + 1),
              cv.assemble_curv_weights(torch.as_tensor(distorted(*DIMS)[0]), DIMS, ftt.Material(**MAT))[0]):
        wt = w.to(dtype)
        got = curv_apply_grid_sym(wt, g)
        assert torch.equal(got, cv.curv_apply_grid(wt, g))
    w64 = cv.grid_view(w).numpy()
    want = jcv.curv_apply_np(w64, g64)
    scale = np.abs(want).max()
    xT = jnp.asarray(np.transpose(g64, (3, 1, 2, 0)))
    got = got.double().numpy()
    if dtype == torch.float32:
        jk = pv.var_apply_transposed(pv.var_fields_f32(jnp.asarray(w64)), xT.astype(jnp.float32), interpret=True)
        jk = np.transpose(np.asarray(jk, np.float64), (3, 1, 2, 0))
        assert np.max(np.abs(got - want)) <= 2e-5 * scale and np.max(np.abs(got - jk)) <= 2e-5 * scale
    else:
        hi = xT.astype(jnp.float32)
        lo = (xT - hi.astype(jnp.float64)).astype(jnp.float32)
        oh, ol = pv.var_apply_transposed_dd(pv.var_fields_dd(jnp.asarray(w64)), hi, lo, interpret=True)
        jk = np.transpose(np.asarray(oh, np.float64) + np.asarray(ol, np.float64), (3, 1, 2, 0))
        assert np.max(np.abs(got - want)) <= 1e-13 * scale and np.max(np.abs(got - jk)) <= 1e-9 * scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("n", [1, 2, 3])
def test_sym_slab_twin_is_the_plain_slab_version(n, dtype):
    """``curv_apply_slab_grid_sym`` on each of n shards' slabs of a
    symmetrized field (zero toward the planes past the z ends, padding
    planes zero) equals ``curv_apply_slab_grid`` value for value, the
    slabs together are the whole grid's plain version, and padding planes
    come out 0."""
    nx, ny, nz = (4, 3, 8)
    Z, Y, X = nz + 1, ny + 1, nx + 1
    rng = np.random.default_rng(42 + n)
    w = random_symmetric(rng, Z, Y, X, zero_z_ends=True).to(dtype)
    g = torch.as_tensor(rng.standard_normal((Z, Y, X, 3))).to(dtype)
    zl = -(-Z // n) + (1 if n > 1 else 0)  # leave padding planes when cut in shards
    slabs = pcurv._weight_slabs(w, ["cpu"] * n, zl)
    g_pad = torch.zeros((n * zl + 2, Y, X, 3), dtype=dtype)
    g_pad[1 : Z + 1] = g
    got = []
    for i, s in enumerate(slabs):
        ext = g_pad[i * zl : i * zl + zl + 2]
        got.append(curv_apply_slab_grid_sym(s, ext))
        assert torch.equal(got[-1], cv.curv_apply_slab_grid(s, ext)), (n, i)
    got = torch.cat(got)
    assert torch.count_nonzero(got[Z:]) == 0
    assert torch.equal(got[:Z], curv_apply_grid_sym(w, g))


def test_sym_twin_never_reads_a_lower_block():
    """With every lower block perturbed, the whole twin's output does not
    change; the slab twin's changes only through its first plane's dz = -1
    blocks, which it reads as stored."""
    nx, ny, nz = DIMS
    Z, Y, X = nz + 1, ny + 1, nx + 1
    rng = np.random.default_rng(43)
    w = random_symmetric(rng, Z, Y, X)
    g = torch.as_tensor(rng.standard_normal((Z, Y, X, 3)))
    bent = w.clone()
    bent[:13] += torch.as_tensor(rng.standard_normal((13, 3, 3, Z, Y, X)))
    assert torch.equal(curv_apply_grid_sym(bent, g), curv_apply_grid_sym(w, g))
    assert not torch.equal(cv.curv_apply_grid(bent, g), cv.curv_apply_grid(w, g))
    ext = torch.cat([torch.as_tensor(rng.standard_normal((1, Y, X, 3))), g,
                     torch.as_tensor(rng.standard_normal((1, Y, X, 3)))])
    bent[:9, :, :, 0] = w[:9, :, :, 0]
    assert torch.equal(curv_apply_slab_grid_sym(bent, ext), curv_apply_slab_grid_sym(w, ext))
    bent[:9, :, :, 0] += 1.0
    assert not torch.equal(curv_apply_slab_grid_sym(bent, ext), curv_apply_slab_grid_sym(w, ext))


@pytest.fixture(scope="module")
def both_ops():
    """The port's and the reference's f64 curvilinear operator and
    hierarchy of one distorted (8, 8, 32) scene (an f32 level included)."""
    dims = (8, 8, 32)
    nodes, elements, fixed, loads = distorted(*dims)
    jsc = ft.make_scene(nodes, elements, fixed, loads, ft.Material(**MAT), dtype=jnp.float64)
    tsc = ftt.make_scene(nodes, elements, fixed, loads, ftt.Material(**MAT), dtype=torch.float64, device="cpu")
    free = 1.0 - fixed.astype(np.float64)
    jop = jcv.build_curv_operator(jsc, dims, dtype=jnp.float64)
    mg_j = jcv.build_curv_multigrid(nodes, dims, free, jsc.material, w0=jop.w, degree=2, f64_below_dof=1000)
    top = cv.build_curv_operator(tsc, dims)
    mg_t = cv.build_curv_multigrid(top.w, dims, free, degree=2, f64_below_dof=1000)
    return (top, mg_t), (jop, mg_j)


def test_masked_operator_apply_matches_jax(both_ops):
    """``CurvilinearOperator.apply`` (one ``var_apply_masked``) against the
    reference operator's ``apply`` (``fea_tpu/ops/curvilinear.py``
    ``CurvilinearOperator.apply``) on a random state: 1e-13 of max|y|;
    fixed rows carry x itself."""
    (top, _), (jop, _) = both_ops
    x = np.random.default_rng(44).standard_normal((top.n_nodes, 3))
    got = top.apply(torch.as_tensor(x)).numpy()
    want = np.asarray(jop.apply(jnp.asarray(x)))
    assert np.abs(got - want).max() <= 1e-13 * np.abs(want).max()
    fixed = top.free.numpy() == 0
    assert fixed.any() and np.array_equal(got[fixed], x[fixed])


def test_masked_level_apply_matches_jax(both_ops):
    """``_CurvLevel.apply`` at every level against the reference level's
    ``apply``, in each level's dtype (f32 rounding 2e-5, f64 1e-13), and
    value for value the expression it replaces."""
    (_, mg_t), (_, mg_j) = both_ops
    rng = np.random.default_rng(45)
    assert [lv.dtype for lv in mg_t.levels][:1] == [torch.float32]
    for lt, lj in zip(mg_t.levels, mg_j.levels):
        g = rng.standard_normal(tuple(lt.free.shape))
        gt = torch.as_tensor(g).to(lt.dtype)
        got = lt.apply(gt)
        F = lt.free
        assert torch.equal(got, F * cv.curv_apply_grid(lt.w, F * gt) + (1.0 - F) * gt)
        want = np.asarray(lj.apply(jnp.asarray(g).astype(np.asarray(lj.w).dtype)), np.float64)
        tol = 2e-5 if lt.dtype == torch.float32 else 1e-13
        assert np.abs(got.double().numpy() - want).max() <= tol * np.abs(want).max(), lt.dims


def test_masked_entries_check_their_arguments():
    """The masked wrappers refuse a mask that is not g's shape or dtype;
    the slab form's plain version reads the neighbours' planes through the
    mask."""
    w = random_symmetric(np.random.default_rng(46), 4, 2, 3)
    g = torch.ones((4, 2, 3, 3), dtype=torch.float64)
    with pytest.raises(ValueError, match="mask"):
        vs.var_apply_masked(w, torch.ones((4, 2, 3, 1), dtype=torch.float64), g)
    with pytest.raises(ValueError, match="mask"):
        vs.var_apply_masked(w, torch.ones_like(g, dtype=torch.float32), g)
    ext = torch.as_tensor(np.random.default_rng(47).standard_normal((6, 2, 3, 3)))
    F = torch.as_tensor((np.random.default_rng(48).random((6, 2, 3, 3)) < 0.7).astype(np.float64))
    with pytest.raises(ValueError, match="mask"):
        vs.var_apply_slab_masked(w, F[1:-1], ext)
    got = vs.var_apply_slab_masked(w, F, ext)
    want = F[1:-1] * cv.curv_apply_slab_grid(w, F * ext) + (1.0 - F[1:-1]) * ext[1:-1]
    assert torch.equal(got, want)


def test_mirror_defect_reads_every_pair():
    """``mirror_defect`` against a node-by-node loop over every (node,
    lower offset) pair with its neighbour inside the grid, on a random
    field and on that field with one block bent at a grid corner; 0 after
    ``symmetrize_field``."""
    Z, Y, X = 3, 2, 4
    rng = np.random.default_rng(49)
    w = torch.as_tensor(rng.standard_normal((27, 3, 3, Z, Y, X)))

    def by_loop(w):
        worst = 0.0
        for d in range(13):
            dz, dy, dx = cv._OFFSETS[d]
            for z, y, x in np.ndindex(Z, Y, X):
                if 0 <= z + dz < Z and 0 <= y + dy < Y and 0 <= x + dx < X:
                    diff = w[d, :, :, z, y, x] - w[26 - d, :, :, z + dz, y + dy, x + dx].T
                    worst = max(worst, float(diff.abs().max()))
        return worst

    assert cv.mirror_defect(w) == by_loop(w) > 0.0
    cv.symmetrize_field(w)
    assert cv.mirror_defect(w) == by_loop(w) == 0.0
    corner = w[0, 1, 2, Z - 1, Y - 1, X - 1].clone()
    w[0, 1, 2, Z - 1, Y - 1, X - 1] += 0.5  # toward (-1, -1, -1): its neighbour is inside
    assert cv.mirror_defect(w) == by_loop(w) > 0.25
    w[0, 1, 2, Z - 1, Y - 1, X - 1] = corner
    w[0, 1, 2, 0, 0, 0] += 0.5  # toward a neighbour outside the grid: no pair, no defect
    assert cv.mirror_defect(w) == by_loop(w) == 0.0


@pytest.mark.parametrize("entry", ["operator", "multigrid"])
def test_a_field_that_is_not_mirrored_is_refused(entry):
    """``CurvilinearOperator`` and ``build_curv_multigrid`` raise on a field
    whose lower blocks are not the mirrors of its upper ones (K4/K5 would
    apply another matrix on the card than the plain version on the CPU),
    and take the same field once symmetrized."""
    nx, ny, nz = DIMS
    Z, Y, X = nz + 1, ny + 1, nx + 1
    w = random_symmetric(np.random.default_rng(50), Z, Y, X)
    free = np.ones((Z * Y * X, 3))
    free[: Y * X] = 0.0

    def make(field):
        if entry == "operator":
            return cv.CurvilinearOperator(w=field, free=torch.as_tensor(free), dims=DIMS)
        return cv.build_curv_multigrid(field, DIMS, free)

    make(w)
    bent = w.clone()
    bent[4, 0, 1, 1, 1, 1] += 1e-9
    with pytest.raises(ValueError, match="not exactly block-symmetric"):
        make(bent)
    make(cv.symmetrize_field(bent))
