"""Geometric multigrid preconditioner for the structured voxel operator.

Counterpart of ``fea_tpu/ops/multigrid.py``, same hierarchy and V-cycle:

  * level operators: the fine 24x24 reference Ke scaled by 2x per
    coarsening (hex8 elasticity Ke is exactly linear in h under uniform
    scaling), applied through the stencil wrapper, so every level runs
    K1 (f32 levels) or K2 (f64 levels) on the card;
  * prolongation: trilinear interpolation, axis-wise [1/2, 1, 1/2];
  * restriction: its exact adjoint P^T;
  * smoother: Chebyshev polynomial on the Jacobi-scaled operator over
    [lambda_max/6, lambda_max], lambda_max a certified Gershgorin upper
    bound computed on the host (an under-estimate makes the smoother
    amplify the top of the spectrum);
  * coarsest level: a dense inverse of the masked matrix, assembled on
    the host in f64 and applied as one matrix-vector product.

The hierarchy is built on the host in NumPy; only the level tensors go
to the device. Per-level precision follows the reference: f32 at level 0
and at >= ``small_level_dof`` DOFs, f64 below.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..dtypes import torch_dtype
from ..utils.profiling import span
from .cuda_stencil import StencilWeights, check_free_mask, stencil_apply, stencil_weights
from .structured import StructuredOperator, corner_table_np, fill_regions_np

__all__ = ["MultigridPreconditioner", "build_multigrid", "coarsen_dims", "chebyshev_smooth"]


def chebyshev_smooth(apply_fn, inv_diag, lam_max, lam_min_frac, degree, x, r):
    """Chebyshev smoothing on the Jacobi-scaled operator (the d-vector
    recurrence of hypre/PETSc), ``degree`` applications of ``apply_fn``,
    over the precomputed scalar schedule ``d_k = a_k d_{k-1} + b_k z_k``
    with ``a_0 = 0``."""
    lam_min = lam_max * lam_min_frac
    theta = 0.5 * (lam_max + lam_min)
    delta = 0.5 * (lam_max - lam_min)
    sigma = theta / delta
    rho = 1.0 / sigma
    schedule = [(0.0, 1.0 / theta)]
    for _ in range(degree - 1):
        rho_new = 1.0 / (2.0 * sigma - rho)
        schedule.append((rho_new * rho, 2.0 * rho_new / delta))
        rho = rho_new
    d = torch.zeros_like(x)
    for a, b in schedule:
        z = inv_diag * (r - apply_fn(x))
        d = a * d + b * z
        x = x + d
    return x


def coarsen_dims(dims: tuple[int, int, int]) -> Optional[tuple[int, int, int]]:
    """Halve element counts; None when any axis is odd or would vanish."""
    if any(d % 2 or d < 2 for d in dims):
        return None
    return tuple(d // 2 for d in dims)


@dataclasses.dataclass(frozen=True)
class _Level:
    weights: StencilWeights  # this level's reference Ke, in the level dtype
    free: torch.Tensor  # (Z, Y, X, 3) free mask grid
    inv_diag: torch.Tensor  # (Z, Y, X, 3) 1 / diag of the MASKED operator
    lam_max: float  # certified upper bound on lambda_max of D^-1 A (masked)
    dims: tuple[int, int, int]

    @property
    def dtype(self) -> torch.dtype:
        return self.free.dtype

    def apply(self, g: torch.Tensor) -> torch.Tensor:
        """Masked operator in grid space, one kernel launch on the card
        (the mask is applied inside the stencil)."""
        return stencil_apply(self.weights, g.contiguous(), self.free)


def _sl(ndim: int, axis: int, s: slice) -> tuple:
    return tuple(s if d == axis else slice(None) for d in range(ndim))


def _prolong(c: torch.Tensor, axes: tuple[int, ...] = (0, 1, 2)) -> torch.Tensor:
    """Trilinear interpolation: coarse grid (Zc,Yc,Xc,3) -> fine grid
    (2Zc-1, 2Yc-1, 2Xc-1, 3); axis-wise [1/2, 1, 1/2]. Only the grid
    ``axes`` are refined (semi-coarsening leaves the others as they are).
    Any rank: the extruded hierarchy refines (L, n2, 3) fields along 0."""
    out = c
    nd = c.ndim
    for axis in axes:
        n = out.shape[axis]
        shape = list(out.shape)
        shape[axis] = 2 * n - 1
        fine = torch.empty(shape, dtype=out.dtype, device=out.device)
        fine[_sl(nd, axis, slice(0, None, 2))] = out
        fine[_sl(nd, axis, slice(1, None, 2))] = 0.5 * (
            out[_sl(nd, axis, slice(0, n - 1))] + out[_sl(nd, axis, slice(1, n))]
        )
        out = fine
    return out


def _restrict(f: torch.Tensor, axes: tuple[int, ...] = (0, 1, 2)) -> torch.Tensor:
    """Exact adjoint of _prolong: c[i] = f[2i] + (f[2i-1] + f[2i+1]) / 2
    along each of the grid ``axes``."""
    out = f
    nd = f.ndim
    for axis in reversed(axes):
        even = out[_sl(nd, axis, slice(0, None, 2))]
        odd = out[_sl(nd, axis, slice(1, None, 2))]
        # odd fine points contribute half to both coarse neighbours
        pad_lo = [0] * (2 * nd)
        pad_hi = [0] * (2 * nd)
        # F.pad lists (last dim first) pairs; axis a is pair index nd - 1 - a
        pad_lo[2 * (nd - 1 - axis)] = 1
        pad_hi[2 * (nd - 1 - axis) + 1] = 1
        out = even + 0.5 * (
            torch.nn.functional.pad(odd, pad_lo) + torch.nn.functional.pad(odd, pad_hi)
        )
    return out


@dataclasses.dataclass(frozen=True)
class MultigridPreconditioner:
    """V-cycle preconditioner z = M^-1 r for the masked structured operator.

    Callable on flat (N, 3) residuals in the dtype of level 0.
    """

    levels: tuple[_Level, ...]
    coarse_inv: torch.Tensor  # (nc, nc) dense inverse of coarsest masked A
    degree: int = 4
    # lam_max is a certified upper bound, so the window top needs no
    # safety factor; 1/6 (vs the textbook 1/4) re-covers the low end the
    # over-estimate would otherwise leave to the coarse grid.
    lam_min_frac: float = 1.0 / 6.0

    @classmethod
    def from_numpy(cls, levels, coarse_inv, degree: int = 4, *, device) -> "MultigridPreconditioner":
        """Pack a host hierarchy, exactly what ``_build_hierarchy_host``
        returns here or in ``fea_tpu.ops.multigrid``, onto ``device``."""
        packed = []
        for lv in levels:
            dt = torch_dtype(lv["dtype"])
            packed.append(
                _Level(
                    weights=stencil_weights(lv["ke"], dt, device),
                    free=check_free_mask(torch.as_tensor(np.asarray(lv["free"]), device=device).to(dt)),
                    inv_diag=torch.as_tensor(np.asarray(lv["inv_diag"]), device=device).to(dt),
                    lam_max=float(lv["lam"]),
                    dims=tuple(lv["dims"]),
                )
            )
        inv = torch.as_tensor(np.asarray(coarse_inv), device=device).to(packed[-1].dtype)
        return cls(levels=tuple(packed), coarse_inv=inv, degree=degree)

    def _smooth(self, level: _Level, x: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
        return chebyshev_smooth(
            level.apply, level.inv_diag, level.lam_max, self.lam_min_frac, self.degree, x, r
        )

    def _vcycle(self, idx: int, r: torch.Tensor) -> torch.Tensor:
        level = self.levels[idx]
        if idx == len(self.levels) - 1:
            return (self.coarse_inv.to(r.dtype) @ r.reshape(-1)).reshape(r.shape)
        z = self._smooth(level, torch.zeros_like(r), r)
        coarse = self.levels[idx + 1]
        rc = coarse.free * _restrict(r - level.apply(z)).to(coarse.dtype)
        zc = self._vcycle(idx + 1, rc)
        z = z + level.free * _prolong(coarse.free * zc).to(r.dtype)
        return self._smooth(level, z, r)

    def __call__(self, r_flat: torch.Tensor) -> torch.Tensor:
        g = r_flat.reshape(self.levels[0].free.shape)
        return self._vcycle(0, g).reshape(r_flat.shape)


def _gershgorin_lam_max(ke_np: np.ndarray) -> float:
    """Certified upper bound on lambda_max of D^-1 A (masked), host-side.

    Gershgorin on the Jacobi-scaled operator: lambda_max <= max_i
    (sum_j |A_ij|) / D_ii, with the row sums over-counted as
    sum_e sum_j |Ke_ij| (still an upper bound). On a uniform voxel box
    both are constant over the 27 boundary-class regions, so the bound is
    O(1) table math. The max runs over ALL regions regardless of the BC
    mask, so it can never under-estimate; scale invariance (Ke -> 2 Ke)
    makes it level-independent.
    """
    ke64 = np.asarray(ke_np, np.float64)
    rowsum_tab = corner_table_np(np.abs(ke64).sum(axis=1))
    diag_tab = corner_table_np(np.ascontiguousarray(np.diagonal(ke64)))
    return float(max((rowsum_tab / diag_tab).max(), 1.0))


def _assemble_coarse_dense_np(ke_np: np.ndarray, free_np: np.ndarray, dims) -> np.ndarray:
    """Dense masked stiffness of a coarse level, assembled on the host in
    f64, in the stencil's grid flattening (z layer-major, y rows, x
    fastest)."""
    from ..mesh import box_hex_mesh

    _, elements = box_hex_mesh(*dims, 1.0, 1.0, 1.0)
    n_dof = free_np.size
    ke64 = np.asarray(ke_np, np.float64)
    A = np.zeros((n_dof, n_dof))
    for el in elements:
        dof = (3 * el[:, None] + np.arange(3)).ravel()
        A[np.ix_(dof, dof)] += ke64
    f = free_np.reshape(-1).astype(np.float64)
    A = A * f[:, None] * f[None, :]
    A[np.diag_indices_from(A)] += 1.0 - f
    return A


def _build_hierarchy_host(
    op: StructuredOperator,
    *,
    coarse_dof_limit: int = 3000,
    max_levels: int = 10,
    dtype: torch.dtype = torch.float32,
    small_level_dof: int = 100_000,
    free_np: Optional[np.ndarray] = None,
) -> tuple[list[dict], np.ndarray]:
    """Host-side (NumPy) hierarchy construction.

    Returns (levels, coarse_inv) where each level is a dict of NumPy
    arrays ``{ke, free, inv_diag, inv_tab, lam, dims, dtype}`` in the
    (Z, Y, X, 3) grid layout; :meth:`MultigridPreconditioner.from_numpy`
    packs them onto the device.
    """
    levels: list[dict] = []
    dims = op.dims
    if free_np is None:
        free_np = op.free.cpu().numpy()
    free_np = np.asarray(free_np, np.float64).reshape(op.grid_shape + (3,))
    level_idx = 0
    ke_np = None
    while True:
        n_dof_level = 3 * (dims[0] + 1) * (dims[1] + 1) * (dims[2] + 1)
        level_dtype = dtype if (level_idx == 0 or n_dof_level >= small_level_dof) else torch.float64
        # each level's Ke is exactly 2x the finer one (hex8 elasticity Ke
        # is linear in h): one host integration in total
        ke_np = op.ke.cpu().numpy().astype(np.float64) if level_idx == 0 else 2.0 * ke_np
        if level_idx == 0:
            # scale-invariant region-table quantities: the Gershgorin
            # bound is O(1), and 1/diag halves per level (Ke doubles)
            lam = _gershgorin_lam_max(ke_np)
            inv_diag_tab = 1.0 / corner_table_np(np.ascontiguousarray(np.diagonal(ke_np)))
        else:
            inv_diag_tab = 0.5 * inv_diag_tab
        inv_diag = np.where(free_np > 0, fill_regions_np(inv_diag_tab, dims), 1.0)
        levels.append(
            dict(
                ke=ke_np,
                free=free_np,
                inv_diag=inv_diag,
                inv_tab=inv_diag_tab,
                lam=lam,
                dims=dims,
                dtype=level_dtype,
            )
        )
        nxt = coarsen_dims(dims)
        if nxt is None or n_dof_level <= coarse_dof_limit or level_idx + 1 >= max_levels:
            break
        dims = nxt
        free_np = free_np[::2, ::2, ::2]  # even-index subsampling of BCs
        level_idx += 1

    A_c = _assemble_coarse_dense_np(levels[-1]["ke"], free_np, levels[-1]["dims"])
    return levels, np.linalg.inv(A_c)


@span("fea.build.hierarchy")
def build_multigrid(
    op: StructuredOperator,
    *,
    degree: int = 4,
    coarse_dof_limit: int = 3000,
    max_levels: int = 10,
    dtype: torch.dtype = torch.float32,
    small_level_dof: int = 100_000,
    free_np: Optional[np.ndarray] = None,
) -> MultigridPreconditioner:
    """Construct the hierarchy under a fine-level structured operator, on
    the operator's device.

    Coarsening stops when an axis count goes odd or the level drops under
    ``coarse_dof_limit`` DOFs, where a dense masked inverse is taken.
    Levels below ``small_level_dof`` DOFs (other than level 0) run in f64.
    """
    levels_np, coarse_inv_np = _build_hierarchy_host(
        op,
        coarse_dof_limit=coarse_dof_limit,
        max_levels=max_levels,
        dtype=dtype,
        small_level_dof=small_level_dof,
        free_np=free_np,
    )
    return MultigridPreconditioner.from_numpy(
        levels_np, coarse_inv_np, degree=degree, device=op.free.device
    )
