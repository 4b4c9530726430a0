"""Variable-weight block-stencil operator for hex8 meshes whose
connectivity is the box grid and whose node positions are free
(distorted or mapped grids: the curvilinear route).

The assembled stiffness of such a mesh is a 27-point block stencil with a
3x3 block per node and offset,

    (K u)[n] = sum_{d in {-1,0,1}^3}  W_d[n] @ u[n + d],

so K @ u needs no index arrays: :func:`curv_apply_grid` is the plain
torch version, and :func:`fea_tpu_torch.ops.cuda_varstencil.var_apply`
runs it as K4 (f32) or K5 (f64) on the card; on one z slab of a sharded
grid, :func:`curv_apply_slab_grid` and ``var_apply_slab`` (K4-slab,
K5-slab). The stiffness is symmetric, so the field is block-symmetric,
``W_{-d}[n + d] = W_d[n]^T``; every field made here leaves through
:func:`symmetrize_field`, which makes that hold exactly (it holds to
rounding before), and the kernels read 14 of the 27 blocks and mirror
the rest. :class:`CurvilinearOperator` and :func:`build_curv_multigrid`
refuse a field that is not (:func:`mirror_defect`). The weight field of a level
is stored once, in the kernels' plane-major layout (27, 3, 3, Z, Y, X);
:func:`grid_view` gives the (27, Z, Y, X, 3, 3) layout of the JAX package
as a view of the same storage; host fields in that layout come in through
the ``from_numpy`` constructors.

The weights are assembled once per operator on the device: element e at
grid position p contributes its (a, b) corner block ``Ke[3a:3a+3, 3b:3b+3]``
to ``W_{cb - ca}`` at node ``p + ca``. On the card one kernel does it
(``ops/cuda_curv_weights.py``: the 14 upper blocks, 8 launches); on the CPU
the plain version, in z-slab chunks (:func:`assemble_curv_weights_plain`).

Multigrid coarsens by Galerkin RAP: level l+1's stencil is the triple
product P^T A_l P of the V-cycle's own trilinear transfer operators
(:func:`rap_dev`), again a 27-offset block stencil, so every level runs
the same kernels. Levels under ``f64_below_dof`` DOFs run in f64, bigger
ones in f32, with certified-Gershgorin Chebyshev smoothing and a dense
masked coarsest inverse; the V-cycle over them is the voxel route's
``ops/multigrid.py::MultigridPreconditioner``.

Counterpart of ``fea_tpu/ops/curvilinear.py``, without its transposed
TPU pipeline.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F_nn

from ..dtypes import torch_dtype
from ..elements.hex8 import batched_ke
from ..materials import Material
from ..scene import Scene
from ..utils.profiling import count, span
from .cuda_curv_weights import curv_weights
from .cuda_varstencil import var_apply, var_apply_masked
from .multigrid import MultigridPreconditioner
from .structured import _CORNERS, _expected_box_elements

__all__ = [
    "CurvilinearOperator",
    "assemble_curv_weights",
    "assemble_curv_weights_plain",
    "build_curv_multigrid",
    "build_curv_operator",
    "coarsen_dims_partial",
    "curv_apply_grid",
    "curv_apply_slab_grid",
    "curv_coarsenable",
    "grid_view",
    "infer_topo_dims",
    "mirror_defect",
    "rap_coeffs",
    "rap_dev",
    "symmetrize_field",
]

# The 27 neighbour offsets (dz, dy, dx), index (dz+1)*9 + (dy+1)*3 + (dx+1).
_OFFSETS = tuple(
    (dz, dy, dx) for dz in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1)
)
_CENTRE = 13  # the offset (0, 0, 0)
# the coarsest level is inverted densely at this size or under
_MAX_COARSE_DOF = 4_000


def _offset_index(dz: int, dy: int, dx: int) -> int:
    return (dz + 1) * 9 + (dy + 1) * 3 + (dx + 1)


def grid_view(w: torch.Tensor) -> torch.Tensor:
    """The (27, Z, Y, X, 3, 3) view of a (27, 3, 3, Z, Y, X) weight field."""
    return w.permute(0, 3, 4, 5, 1, 2)


def _kernel_layout(w_grid: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    """A (27, Z, Y, X, 3, 3) host field as a contiguous, symmetrized
    (27, 3, 3, Z, Y, X) tensor on ``device``."""
    w = np.ascontiguousarray(np.asarray(w_grid).transpose(0, 4, 5, 1, 2, 3))
    return symmetrize_field(torch.as_tensor(w, device=device).to(dtype))


def _in_grid(o: int, n: int) -> tuple[slice, slice]:
    """Along one axis of n nodes: the nodes whose neighbour at offset o is
    inside the grid, and those neighbours."""
    return slice(max(0, -o), n - max(0, o)), slice(max(0, o), n + min(0, o))


def symmetrize_field(w: torch.Tensor) -> torch.Tensor:
    """Make a (27, 3, 3, Z, Y, X) field exactly block-symmetric, in place,
    and return it: for each of the 13 lower offsets d (index < 13),
    ``W_d[n] = W_{26-d}[n + d]^T`` wherever n + d is inside the grid. The
    14 upper blocks and the lower blocks toward a neighbour outside the
    grid stay as they are.

    An assembled stiffness and its Galerkin levels are symmetric up to the
    rounding of their sums (~1e-16 of the field's largest value in f64);
    this makes the mirror hold exactly, which K4/K5 rely on: they read only
    the upper blocks and the transposes of those."""
    Z, Y, X = w.shape[3:]
    for d in range(_CENTRE):
        at, nb = zip(*(_in_grid(o, n) for o, n in zip(_OFFSETS[d], (Z, Y, X))))
        w[(d, slice(None), slice(None)) + at] = w[(26 - d, slice(None), slice(None)) + nb].transpose(0, 1)
    return w


def mirror_defect(w: torch.Tensor) -> float:
    """max |W_d[n] - W_{26-d}[n + d]^T| of a (27, 3, 3, Z, Y, X) field over
    the 13 lower offsets d and the nodes whose neighbour n + d is inside
    the grid: 0.0 for the exactly block-symmetric field K4/K5 take (what
    :func:`symmetrize_field` leaves)."""
    Z, Y, X = w.shape[3:]
    worst = 0.0
    for d in range(_CENTRE):
        at, nb = zip(*(_in_grid(o, n) for o, n in zip(_OFFSETS[d], (Z, Y, X))))
        lower = w[(d, slice(None), slice(None)) + at]
        if lower.numel():
            upper = w[(26 - d, slice(None), slice(None)) + nb].transpose(0, 1)
            worst = max(worst, float((lower - upper).abs().max()))
    return worst


def _require_block_symmetric(w: torch.Tensor, what: str) -> None:
    """Raise ValueError unless ``w`` is exactly block-symmetric: on the card
    K4/K5 read 14 of its 27 blocks and mirror the rest, so any other field
    would be applied as a different matrix there than on the CPU."""
    defect = mirror_defect(w)
    if defect != 0.0:
        raise ValueError(
            f"{what}: the weight field is not exactly block-symmetric (largest mirror defect {defect:.3e}); "
            "K4/K5 read 14 of its 27 blocks. A stiffness field symmetric to rounding takes symmetrize_field first."
        )


def infer_topo_dims(scene: Scene) -> Optional[tuple[int, int, int]]:
    """(nx, ny, nz) if the scene's CONNECTIVITY is the box_hex_mesh grid
    (node positions unconstrained), else None. Pure index arithmetic and
    one O(E) array compare on the host."""
    if scene.family != "hex8":
        return None
    el = scene.host_elements
    if el.ndim != 2 or el.shape[1] != 8 or el.shape[0] == 0:
        return None
    e0 = el[0]
    if int(e0[0]) != 0:
        return None
    X = int(e0[3]) - int(e0[0])  # corner 3 is (dz,dy,dx)=(0,1,0) -> +X
    NXY = int(e0[4]) - int(e0[0])  # corner 4 is (1,0,0) -> +X*Yn
    if X < 2 or NXY < 2 * X or NXY % X:
        return None
    Yn = NXY // X
    N = scene.n_nodes
    if N % NXY:
        return None
    Zn = N // NXY
    nx, ny, nz = X - 1, Yn - 1, Zn - 1
    if min(nx, ny, nz) < 1 or el.shape[0] != nx * ny * nz:
        return None
    if not np.array_equal(el, _expected_box_elements(nx, ny, nz)):
        return None
    return (nx, ny, nz)


# -- apply ---------------------------------------------------------------------


def _apply_padded(w: torch.Tensor, gp: torch.Tensor) -> torch.Tensor:
    """27 shifted multiply-adds of w (27, 3, 3, Z, Y, X) over the state
    gp (3, Z + 2, Y + 2, X + 2), which holds one plane, row and column
    beyond the nodes on each side: -> (Z, Y, X, 3)."""
    Z, Y, X = w.shape[3:]
    out = torch.zeros((3, Z, Y, X), dtype=gp.dtype, device=gp.device)
    for d, (dz, dy, dx) in enumerate(_OFFSETS):
        xs = gp[:, 1 + dz : 1 + dz + Z, 1 + dy : 1 + dy + Y, 1 + dx : 1 + dx + X]
        out += (w[d] * xs[None]).sum(dim=1)
    return out.permute(1, 2, 3, 0).contiguous()


def curv_apply_grid(w: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """K @ u in grid space, the plain version of K4 (f32) and K5 (f64):
    w (27, 3, 3, Z, Y, X), g (Z, Y, X, 3) -> (Z, Y, X, 3), in g's dtype.

    27 shifted multiply-adds over the zero-padded state, in the
    component-major form of the weight field.
    """
    return _apply_padded(w, F_nn.pad(g.permute(3, 0, 1, 2), (1, 1, 1, 1, 1, 1)))


def curv_apply_slab_grid(w: torch.Tensor, g_ext: torch.Tensor) -> torch.Tensor:
    """K @ u on one z slab, the plain version of K4-slab (f32) and K5-slab
    (f64): the slab's weights w (27, 3, 3, Zl, Y, X) and its state between
    the neighbours' edge planes g_ext (Zl + 2, Y, X, 3) -> (Zl, Y, X, 3).
    The halo planes take the place of the zero padding along z: the same
    multiply-adds as :func:`curv_apply_grid` on the slab's planes."""
    return _apply_padded(w, F_nn.pad(g_ext.permute(3, 0, 1, 2), (1, 1, 1, 1)))


# -- assembly ------------------------------------------------------------------


def _scatter_blocks(wg, keg, z0: int, dims) -> None:
    """Add a z-slab's (cz, ny, nx, 8, 3, 8, 3) Ke blocks into the
    (27, Z, Y, X, 3, 3) field ``wg`` from element layer ``z0``: the 64
    corner pairs land on their 27 offsets as direct slice-adds."""
    nx, ny, _ = dims
    cz = keg.shape[0]
    for a, (az, ay, ax) in enumerate(_CORNERS):
        for b, (bz, by, bx) in enumerate(_CORNERS):
            d = _offset_index(bz - az, by - ay, bx - ax)
            wg[d, z0 + az : z0 + az + cz, ay : ay + ny, ax : ax + nx] += keg[:, :, :, a, :, b, :]


def assemble_curv_weights_plain(
    nodes: torch.Tensor,
    dims: tuple[int, int, int],
    material: Material,
    *,
    dtype: torch.dtype = torch.float64,
    chunk_elems: int = 8192,
    valid=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the assembly kernel
    (:func:`fea_tpu_torch.ops.cuda_curv_weights.curv_weights`), which
    ``assemble_curv_weights`` runs on the CPU: the weight field (27, 3, 3,
    Zn, Yn, Xn) in ``dtype`` on the nodes' device, all 27 blocks, not
    symmetrized, and the minimum detJ as a 0-d tensor.

    ``nodes`` (N, 3) in box grid order. Whole z element layers of about
    ``chunk_elems`` elements at a time: corner coordinates by slicing the
    node grid, one batched Ke, 64 slice-adds; no (E, 24, 24) batch of the
    whole mesh is ever held.

    ``valid``: an optional (nz, ny, nx) 0/1 host mask of the cells that
    exist (the embedded route, ``solve/embed.py``). A void cell adds
    exactly zero weights, its Ke selected away by ``where`` so that a
    degenerate synthetic cell cannot carry an inf or a NaN into the
    field, and its detJ is left out of the minimum.
    """
    nx, ny, nz = dims
    Zn, Yn, Xn = nz + 1, ny + 1, nx + 1
    cz = max(1, min(nz, chunk_elems // (nx * ny)))
    grid = nodes.to(dtype).reshape(Zn, Yn, Xn, 3)
    w = torch.zeros((27, 3, 3, Zn, Yn, Xn), dtype=dtype, device=nodes.device)
    wg = grid_view(w)
    cells = None if valid is None else torch.as_tensor(np.asarray(valid) != 0, device=nodes.device).reshape(nz, -1)
    min_detj = None
    for z0 in range(0, nz, cz):
        czi = min(cz, nz - z0)
        xe = torch.stack(
            [grid[z0 + az : z0 + az + czi, ay : ay + ny, ax : ax + nx] for az, ay, ax in _CORNERS],
            dim=3,
        )  # (czi, ny, nx, 8, 3)
        ke, detj = batched_ke(xe.reshape(-1, 8, 3), material)
        if cells is not None:
            live = cells[z0 : z0 + czi].reshape(-1)
            ke = torch.where(live[:, None, None], ke, ke.new_zeros(()))
            detj = torch.where(live, detj, torch.inf)
        _scatter_blocks(wg, ke.reshape(czi, ny, nx, 8, 3, 8, 3), z0, dims)
        mdj = detj.min()
        min_detj = mdj if min_detj is None else torch.minimum(min_detj, mdj)
    return w, min_detj


@span("fea.build.curv.weights")
def assemble_curv_weights(
    nodes: torch.Tensor,
    dims: tuple[int, int, int],
    material: Material,
    *,
    dtype: torch.dtype = torch.float64,
    chunk_elems: int = 8192,
    valid=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Weight field (27, 3, 3, Zn, Yn, Xn) in ``dtype`` (float32 or
    float64) on the nodes' device, symmetrized, and the minimum detJ as a
    0-d tensor.

    ``nodes`` (N, 3) in box grid order. On the card one kernel assembles
    it (:func:`fea_tpu_torch.ops.cuda_curv_weights.curv_weights`, 8
    launches); on the CPU the plain version, in z-slab chunks of about
    ``chunk_elems`` elements (:func:`assemble_curv_weights_plain`), the
    only reader of ``chunk_elems``. Another dtype raises TypeError, another
    device ValueError.
    ``valid``: an optional (nz, ny, nx) 0/1 host mask of the cells that
    exist (the embedded route, ``solve/embed.py``): a void cell adds
    exactly zero weights, even where its geometry is degenerate, and its
    detJ is left out of the minimum.
    """
    if nodes.device.type == "cpu":
        if dtype not in (torch.float32, torch.float64):
            raise TypeError(f"assemble_curv_weights: dtype {dtype} is neither float32 nor float64")
        w, min_detj = assemble_curv_weights_plain(nodes, dims, material, dtype=dtype, chunk_elems=chunk_elems,
                                                  valid=valid)
    else:
        w, min_detj = curv_weights(nodes, dims, material, dtype=dtype, valid=valid)
    return symmetrize_field(w), min_detj


# -- operator ------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CurvilinearOperator:
    """Block-stencil stiffness operator of a topologically structured
    mesh, with the interface of StructuredOperator (apply / apply_raw /
    rhs / free / dims), so the FCG solver and certification take it as
    they stand."""

    w: torch.Tensor  # (27, 3, 3, Zn, Yn, Xn) weight field, kernel layout, exactly block-symmetric
    free: torch.Tensor  # (N, 3) free-DOF mask (flat node order)
    dims: tuple[int, int, int]

    def __post_init__(self):
        _require_block_symmetric(self.w, "CurvilinearOperator")

    @classmethod
    def from_numpy(cls, w: np.ndarray, free: np.ndarray, *, device) -> "CurvilinearOperator":
        """The operator of a (27, Z, Y, X, 3, 3) host field (for example
        ``fea_tpu``'s operator's ``w``, pulled to the host) and its
        (N, 3) free mask, in the field's dtype on ``device``."""
        w = np.asarray(w)
        Z, Y, X = w.shape[1:4]
        dt = torch_dtype(w.dtype)
        return cls(
            w=_kernel_layout(w, dt, device),
            free=torch.as_tensor(np.array(free).reshape(-1, 3), device=device).to(dt),
            dims=(X - 1, Y - 1, Z - 1),
        )

    @property
    def grid_shape(self) -> tuple[int, int, int]:
        nx, ny, nz = self.dims
        return (nz + 1, ny + 1, nx + 1)

    @property
    def n_nodes(self) -> int:
        Z, Y, X = self.grid_shape
        return Z * Y * X

    @property
    def n_dof(self) -> int:
        return 3 * self.n_nodes

    def astype(self, dtype: torch.dtype) -> "CurvilinearOperator":
        return dataclasses.replace(self, w=self.w.to(dtype), free=self.free.to(dtype))

    def apply_raw(self, u: torch.Tensor) -> torch.Tensor:
        """K @ u over all DOFs. u (N, 3) flat -> (N, 3) flat."""
        Z, Y, X = self.grid_shape
        return var_apply(self.w, u.reshape(Z, Y, X, 3).contiguous()).reshape(-1, 3)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """The masked operator F K(F x) + (1 - F) x, one masked launch."""
        Z, Y, X = self.grid_shape
        F = self.free.to(x.dtype).reshape(Z, Y, X, 3)
        return var_apply_masked(self.w, F, x.reshape(Z, Y, X, 3).contiguous()).reshape(-1, 3)

    def rhs(self, loads: torch.Tensor, prescribed: torch.Tensor) -> torch.Tensor:
        F = self.free.to(loads.dtype)
        xp = (1.0 - F) * prescribed.to(loads.dtype)
        return F * (loads - self.apply_raw(xp)) + xp


@span("fea.build.operator")
def build_curv_operator(
    scene: Scene,
    dims: tuple[int, int, int],
    *,
    dtype: torch.dtype = torch.float64,
    check_jacobians: bool = True,
) -> CurvilinearOperator:
    """Operator of a topologically structured scene, assembled on the
    scene's device; raises ValueError on a non-positive Jacobian
    determinant (distorted meshes are where inverted elements happen)."""
    w, min_detj = assemble_curv_weights(scene.nodes, dims, scene.material, dtype=dtype)
    if check_jacobians:
        with span("fea.build.curv.jacobians"):  # reading the minimum waits for the assembly
            mdj = float(min_detj)
        if mdj <= 0.0:
            raise ValueError(
                f"Non-positive Jacobian determinant (min detJ = {mdj:g}); "
                "check element shapes / node ordering."
            )
    return CurvilinearOperator(w=w, free=scene.free_mask(dtype), dims=dims)


# -- multigrid -----------------------------------------------------------------


def coarsen_dims_partial(
    dims: tuple[int, int, int]
) -> Optional[tuple[tuple[int, int, int], tuple[int, ...]]]:
    """Halve every axis that CAN halve (even element count >= 2); returns
    ``(new_dims, grid_axes)`` with ``grid_axes`` the coarsened axes in
    (z, y, x) = (0, 1, 2) grid order, or None when no axis can coarsen.
    Semi-coarsening keeps odd-dimensioned meshes multilevel."""
    nx, ny, nz = dims
    new = [nx, ny, nz]
    axes = []
    for grid_axis, di in ((0, 2), (1, 1), (2, 0)):  # z <- nz, y <- ny, x <- nx
        if new[di] % 2 == 0 and new[di] >= 2:
            new[di] //= 2
            axes.append(grid_axis)
    if not axes:
        return None
    return (new[0], new[1], new[2]), tuple(sorted(axes))


def rap_coeffs(axes: tuple[int, ...]) -> np.ndarray:
    """(27 D, 27 a, 27 d) Galerkin-RAP coefficient tensor.

    ``Ac_D[pc] = sum_{a,d} C[D,a,d] * w_d[sigma(pc) + a]`` where sigma
    doubles the coarsened axes, a is the fine-side support offset of the
    trilinear prolongation column at pc, d the fine stencil offset, and
    the coarse-side support offset ``b = a + d - 2D`` (per coarsened
    axis) must stay within |b| <= 1. The weights are those of
    ``_prolong`` / ``_restrict`` ([1/2, 1, 1/2] per coarsened axis,
    identity on the others), so the coarse operator is the exact P^T A P.
    """
    axes = tuple(sorted(axes))
    C = np.zeros((27, 27, 27))
    for Di, Dv in enumerate(_OFFSETS):
        for ai, av in enumerate(_OFFSETS):
            for di, dv in enumerate(_OFFSETS):
                coef, ok = 1.0, True
                for axn in range(3):
                    D_, a_, d_ = Dv[axn], av[axn], dv[axn]
                    if axn in axes:
                        b_ = a_ + d_ - 2 * D_
                        if abs(b_) > 1:
                            ok = False
                            break
                        coef *= (0.5 if a_ else 1.0) * (0.5 if b_ else 1.0)
                    elif a_ != 0 or d_ != D_:
                        ok = False
                        break
                if ok:
                    C[Di, ai, di] = coef
    return C


def _coarse_sizes(fine: tuple[int, int, int], axes) -> list[int]:
    cs = list(fine)
    for ax in axes:
        cs[ax] = (cs[ax] + 1) // 2
    return cs


def _rap_slices(av, axes, cs) -> Optional[tuple[slice, slice, slice]]:
    """(z, y, x) slices of a once-padded field selecting w_d[sigma(pc) + a]
    for every coarse node pc, or None when offset ``a`` is inadmissible
    (nonzero on a pass-through axis)."""
    sl = []
    for axn, n_c in zip(range(3), cs):
        a_ = av[axn]
        if axn in axes:
            start = 1 + a_  # +1: pad offset
            sl.append(slice(start, start + 2 * (n_c - 1) + 1, 2))
        else:
            if a_ != 0:
                return None
            sl.append(slice(1, 1 + n_c))
    return tuple(sl)


@span("fea.build.curv.rap")
def rap_dev(w: torch.Tensor, axes: tuple[int, ...]) -> torch.Tensor:
    """Galerkin RAP of a (27, 3, 3, Z, Y, X) block stencil -> the coarse
    (27, 3, 3, Zc, Yc, Xc) stencil, on the field's device: one
    (27, 27) @ (27, 9 Nc) product per admissible prolongation offset,
    symmetrized."""
    Cnp = rap_coeffs(axes)
    C = torch.as_tensor(Cnp, dtype=w.dtype, device=w.device)
    cs = _coarse_sizes(tuple(w.shape[3:]), axes)
    wp = F_nn.pad(w, (1, 1, 1, 1, 1, 1))
    wc = torch.zeros((27, 9 * cs[0] * cs[1] * cs[2]), dtype=w.dtype, device=w.device)
    for ai, av in enumerate(_OFFSETS):
        sl = _rap_slices(av, axes, cs)
        if sl is None or not Cnp[:, ai, :].any():
            continue
        wc += C[:, ai, :] @ wp[(slice(None),) * 3 + sl].reshape(27, -1)
    return symmetrize_field(wc.reshape(27, 3, 3, *cs))


def curv_coarsenable(dims: tuple[int, int, int], *, max_coarse_dof: int = _MAX_COARSE_DOF) -> bool:
    """True when (semi-)coarsening can reach a dense-invertible coarsest
    level."""
    d = dims
    while 3 * (d[0] + 1) * (d[1] + 1) * (d[2] + 1) > max_coarse_dof:
        step = coarsen_dims_partial(d)
        if step is None:
            return False
        d = step[0]
    return True


def _gershgorin_dev(w: torch.Tensor, free: torch.Tensor) -> tuple[torch.Tensor, float]:
    """(inv_diag (Z, Y, X, 3), lam_max) of the Jacobi-scaled MASKED
    stencil (27, 3, 3, Z, Y, X) with the (Z, Y, X, 3) free grid, in the
    field's dtype: row sums bounded by the entrywise triangle inequality
    with masked columns, so the bound can never under-estimate."""
    Z, Y, X = free.shape[:3]
    fr = free.to(w.dtype)
    fp = F_nn.pad(fr.permute(3, 0, 1, 2), (1, 1, 1, 1, 1, 1))
    rs = torch.zeros((3, Z, Y, X), dtype=w.dtype, device=w.device)
    for d, (dz, dy, dx) in enumerate(_OFFSETS):
        fcol = fp[:, 1 + dz : 1 + dz + Z, 1 + dy : 1 + dy + Y, 1 + dx : 1 + dx + X]
        rs += (w[d].abs() * fcol[None]).sum(dim=1)
    rs = rs.permute(1, 2, 3, 0)
    diag = torch.diagonal(w[_CENTRE], dim1=0, dim2=1)  # (Z, Y, X, 3)
    d_masked = torch.where((fr > 0) & (diag > 0), diag, torch.ones_like(diag))
    rs_masked = torch.where(fr > 0, fr * rs, torch.ones_like(rs))
    lam = max(float((rs_masked / d_masked).max()), 1.0)
    return 1.0 / d_masked, lam


def _dense_from_w(w: torch.Tensor, free: torch.Tensor) -> torch.Tensor:
    """Masked dense matrix ``F K F + diag(1 - F)`` of a (27, 3, 3, Z, Y, X)
    stencil with the (Z, Y, X, 3) free grid (the coarsest level only), on
    the field's device and in its dtype. Within one offset the (row, col)
    pairs are distinct and two offsets give a row different columns, so
    each entry is written once: one indexed write, no accumulation."""
    Z, Y, X = free.shape[:3]
    n = 3 * Z * Y * X
    nid = 3 * torch.arange(Z * Y * X, device=w.device).reshape(Z, Y, X)
    comp = torch.arange(3, device=w.device)
    rows, cols, vals = [], [], []
    for d, off in enumerate(_OFFSETS):
        at, nb = zip(*(_in_grid(o, m) for o, m in zip(off, (Z, Y, X))))
        r, c = nid[at].reshape(-1), nid[nb].reshape(-1)
        rows.append((r[None, None, :] + comp[:, None, None]).expand(3, 3, -1).reshape(-1))
        cols.append((c[None, None, :] + comp[None, :, None]).expand(3, 3, -1).reshape(-1))
        vals.append(w[(d, slice(None), slice(None)) + at].reshape(-1))
    K = torch.zeros((n, n), dtype=w.dtype, device=w.device)
    K.index_put_((torch.cat(rows), torch.cat(cols)), torch.cat(vals))
    f = free.reshape(-1).to(w.dtype)
    K.mul_(f[:, None]).mul_(f[None, :])
    K.diagonal().add_(1.0 - f)
    return K


def _coarse_inverse(w: torch.Tensor, free: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`_dense_from_w`'s matrix on the field's device.

    The masked Galerkin matrix of a supported mesh is SPD: its Cholesky
    factor is written over the matrix and inverted in place (at most two
    n x n buffers: the matrix and cholesky_inverse's working copy), counted
    ``curv.coarse.cholesky``. Any other nonsingular matrix is rebuilt and
    inverted by LU, counted ``curv.coarse.lu``. The factor's status is
    the one host read."""
    K = _dense_from_w(w, free)
    L = K.mT  # K is symmetric: its column-major view holds the same values
    info = torch.empty((), dtype=torch.int32, device=K.device)
    torch.linalg.cholesky_ex(L, out=(L, info))
    if int(info) == 0:
        count("curv.coarse.cholesky")
        return torch.cholesky_inverse(L, out=L)
    count("curv.coarse.lu")
    del K, L
    return torch.linalg.inv(_dense_from_w(w, free))


@dataclasses.dataclass(frozen=True)
class _CurvLevel:
    """One level of a curvilinear :class:`MultigridPreconditioner`, in its
    own dtype (K4 or K5). ``MultigridPreconditioner.from_numpy(...,
    level_type=_CurvLevel)`` packs a host hierarchy of them."""

    w: torch.Tensor  # (27, 3, 3, Z, Y, X), kernel layout
    free: torch.Tensor  # (Z, Y, X, 3)
    inv_diag: torch.Tensor  # (Z, Y, X, 3)
    lam_max: float  # certified Gershgorin bound
    dims: tuple[int, int, int]

    @classmethod
    def from_numpy(cls, lv: dict, device) -> "_CurvLevel":
        """Pack a host level ``{w, free, inv_diag, lam, dims, dtype}``, ``w``
        in the (27, Z, Y, X, 3, 3) layout (for example a level of a
        ``fea_tpu`` CurvMultigrid, pulled to the host), onto ``device``."""
        dt = torch_dtype(lv["dtype"])
        return cls(
            w=_kernel_layout(lv["w"], dt, device),
            free=torch.as_tensor(np.array(lv["free"]), device=device).to(dt),
            inv_diag=torch.as_tensor(np.array(lv["inv_diag"]), device=device).to(dt),
            lam_max=float(lv["lam"]),
            dims=tuple(lv["dims"]),
        )

    @property
    def dtype(self) -> torch.dtype:
        return self.w.dtype

    def apply(self, g: torch.Tensor) -> torch.Tensor:
        """Masked operator in grid space, in g's dtype (the finest level
        takes the residual in the preconditioner's dtype, whatever its
        own)."""
        w = self.w if self.w.dtype == g.dtype else self.w.to(g.dtype)
        return var_apply_masked(w, self.free.to(g.dtype), g.contiguous())


@span("fea.build.hierarchy")
def build_curv_multigrid(
    w0: torch.Tensor,
    dims: tuple[int, int, int],
    free_np: np.ndarray,
    *,
    degree: int = 2,
    f64_below_dof: int = 50_000,
) -> MultigridPreconditioner:
    """Galerkin (RAP) multigrid over the fine weight field ``w0``
    (27, 3, 3, Z, Y, X), on its device; ``w0`` must be exactly
    block-symmetric (ValueError otherwise, as for CurvilinearOperator).

    Each coarser level is :func:`rap_dev` of the one above, chained in
    f64 from the resident fine field. Then each level's certified
    Gershgorin bound from its f64 field, and its cast (span
    ``fea.build.curv.levels``): levels under ``f64_below_dof`` DOFs keep
    f64; bigger ones are cast to f32. Last the dense masked matrix of the
    coarsest level and its inverse, both on the field's device (span
    ``fea.build.curv.coarse``).
    """
    _require_block_symmetric(w0, "build_curv_multigrid")
    nx, ny, nz = dims
    device = w0.device
    f = np.asarray(free_np, np.float64).reshape(nz + 1, ny + 1, nx + 1, 3)
    d, w = dims, w0.to(torch.float64)
    fields, coarsen_axes = [(d, w, f)], []  # each level's dims, f64 field and free mask
    while 3 * int(np.prod([s + 1 for s in d])) > _MAX_COARSE_DOF:
        step = coarsen_dims_partial(d)
        if step is None:
            break
        d, axes = step
        coarsen_axes.append(axes)
        w = rap_dev(w, axes)
        f = np.ascontiguousarray(f[tuple(slice(None, None, 2) if ax in axes else slice(None) for ax in range(3))])
        fields.append((d, w, f))

    levels = []
    with span("fea.build.curv.levels"):  # the first bound read waits for the RAP chain's card work
        for d, w, f in fields:
            lvl_dtype = torch.float64 if 3 * int(np.prod([s + 1 for s in d])) < f64_below_dof else torch.float32
            f_dev = torch.as_tensor(f, device=device)
            inv_diag, lam = _gershgorin_dev(w, f_dev)
            levels.append(_CurvLevel(w=w.to(lvl_dtype), free=f_dev.to(lvl_dtype), inv_diag=inv_diag.to(lvl_dtype),
                                     lam_max=lam, dims=d))
    del fields  # the f64 fields that no level keeps go before the dense step's two matrices
    with span("fea.build.curv.coarse"):
        coarse_inv = _coarse_inverse(w, levels[-1].free).to(levels[-1].dtype)
    return MultigridPreconditioner(
        levels=tuple(levels), coarse_inv=coarse_inv, coarsen_axes=tuple(coarsen_axes), degree=degree
    )
