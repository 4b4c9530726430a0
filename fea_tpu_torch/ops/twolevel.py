"""Two-level preconditioners for unstructured hex8 meshes: geometric node
aggregation, a rigid-body-mode coarse space with its exact Galerkin
matrix, and a nodal 3x3 block-Jacobi or Chebyshev smoother.

A general mesh has no grid to coarsen, and (block-)Jacobi PCG needs
O(1/h) iterations; a coarse space restores global error transport.

  * Aggregates come from coordinate binning on the host (O(N), any mesh).
  * The coarse space is 6 rigid-body modes an aggregate (3 translations,
    3 rotations about the aggregate's centroid, radius-normalized):
    ``P_n = [I3 | S(xrel_n)]``, S the cross-product matrix.
  * The coarse matrix is the exact Galerkin product P^T A P of the MASKED
    operator, accumulated on the operator's device in chunks of elements
    (one ``index_add_`` a chunk into the dense (6A, 6A) matrix), with a
    tiny ridge on the diagonal for the null rotational modes of collinear
    aggregates (data never has components there).
  * The coarse inverse is dense, inverted once in f64 on the operator's
    device (``torch.linalg.inv``; 6144^2 at the 1024-aggregate cap).

:class:`TwoLevelPrecond` is the additive form (block-Jacobi plus the
coarse correction); :class:`TwoLevelChebPrecond` the multiplicative one
(Chebyshev pre-smoothing, coarse correction, post-smoothing, all in f32),
the preconditioner of the FCG fallback route of ``solve()``.

Counterpart of ``fea_tpu/ops/twolevel.py``. Its f32 build (``dtype=`` /
``build_dtype=``) is not ported: it exists because f64 is emulated on the
TPU, and the card accumulates in f64.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..elements import hex8 as hex8_el
from ..utils.profiling import span

__all__ = [
    "TwoLevelChebPrecond",
    "TwoLevelPrecond",
    "aggregate_nodes",
    "build_two_level",
    "build_two_level_cheb",
    "coarse_matrix",
    "jacobi_gershgorin",
    "rigid_body_geometry",
]


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def aggregate_nodes(nodes: np.ndarray, target: int) -> tuple[np.ndarray, int]:
    """Geometric aggregation: bin nodes into ~``target`` bounding-box
    cells (cell counts per axis proportional to extent), compacted to
    contiguous aggregate ids. Returns (agg (N,) int32, n_aggs)."""
    nodes = np.asarray(nodes, np.float64)
    lo = nodes.min(axis=0)
    span = nodes.max(axis=0) - lo
    span = np.where(span > 0, span, 1.0)
    # cells per axis ~ span / h, with h chosen so that prod(span / h) ~ target
    h = (np.prod(span) / max(target, 1)) ** (1.0 / 3.0)
    k = np.maximum(1, np.round(span / h)).astype(np.int64)
    ix = np.minimum((nodes - lo) / (span / k), k - 1e-9).astype(np.int64)
    cell = (ix[:, 0] * k[1] + ix[:, 1]) * k[2] + ix[:, 2]
    _, agg = np.unique(cell, return_inverse=True)
    return agg.astype(np.int32), int(agg.max()) + 1


def rigid_body_geometry(nodes: np.ndarray, agg: np.ndarray, n_aggs: int) -> np.ndarray:
    """Radius-normalized node offsets from their aggregate centroid,
    (N, 3) f64: the rotational part of ``P_n = [I3 | S(xrel_n)]``."""
    nodes = np.asarray(nodes, np.float64)
    counts = np.bincount(agg, minlength=n_aggs).astype(np.float64)
    centers = np.zeros((n_aggs, 3))
    np.add.at(centers, agg, nodes)
    centers /= counts[:, None]
    xrel = nodes - centers[agg]
    rad = np.zeros(n_aggs)
    np.maximum.at(rad, agg, np.linalg.norm(xrel, axis=1))
    rad = np.where(rad > 0, rad, 1.0)
    return xrel / rad[agg, None]


def _skew(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) cross-product matrices, S(v) w = v x w."""
    z = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([z, -v[..., 2], v[..., 1]], -1),
        torch.stack([v[..., 2], z, -v[..., 0]], -1),
        torch.stack([-v[..., 1], v[..., 0], z], -1),
    ], -2)


def _rbm_blocks(xrel: torch.Tensor) -> torch.Tensor:
    """(..., 3) offsets -> (..., 3, 6) prolongation blocks [I3 | S(x)]."""
    eye = torch.eye(3, dtype=xrel.dtype, device=xrel.device).expand(xrel.shape[:-1] + (3, 3))
    return torch.cat([eye, _skew(xrel)], dim=-1)


def _accumulate_chunk(Ac, rs, d, ke_chunk, el, free_flat, xrel, agg, with_gg: bool = True) -> None:
    """Add one chunk of elements into the dense coarse matrix ``Ac`` (the
    masked, rigid-body-projected blocks, one ``index_add_``) and, with
    ``with_gg``, into the Gershgorin row sums ``rs`` and diagonal ``d`` of
    the Chebyshev smoother's bound. Everything is derived on the device
    from the element slice ``el (C, 8)``."""
    C = ke_chunk.shape[0]
    n_c = Ac.shape[0]
    three = torch.arange(3, device=el.device)
    dof = (3 * el[:, :, None] + three).reshape(C, 24)
    f = free_flat[dof]  # (C, 24)
    km5 = (f[:, :, None] * ke_chunk * f[:, None, :]).reshape(C, 8, 3, 8, 3)
    P_e = _rbm_blocks(xrel[el])  # (C, 8, 3, 6)
    # two products, so that no intermediate is larger than (C, 8, 6, 8, 3)
    t = torch.einsum("caim,caibj->cambj", P_e, km5)
    kc = torch.einsum("cambj,cbjn->cambn", t, P_e).reshape(C, 48, 48)
    rowcol = (6 * agg[el][:, :, None] + torch.arange(6, device=el.device)).reshape(C, 48)
    Ac.view(-1).index_add_(0, (rowcol[:, :, None] * n_c + rowcol[:, None, :]).reshape(-1), kc.reshape(-1))
    if with_gg:
        # Gershgorin data of the MASKED operator: row sums bounded by the
        # triangle inequality over element |ke| with masked columns, the
        # diagonal assembled exactly (see jacobi_gershgorin)
        rs.index_add_(0, dof.reshape(-1), (ke_chunk.abs() * f[:, None, :]).sum(-1).reshape(-1))
        d.index_add_(0, dof.reshape(-1), torch.diagonal(ke_chunk, dim1=1, dim2=2).reshape(-1))


def _element_ke_chunk(op, sl: slice) -> torch.Tensor:
    """(C, 24, 24) f64 element stiffnesses of ``elements[sl]``, by kind,
    with padded element slots zeroed."""
    C = sl.stop - sl.start
    f64 = torch.float64
    if op.kind == "hex8_matfree":
        geom = hex8_el.Hex8Geometry(op.geom.grads[sl].to(f64), op.geom.wdetj[sl].to(f64), op.geom.min_detj)
        ke = hex8_el.stiffness_from_geometry(geom, op.material)
    elif op.kind == "uniform":
        ke = op.ke.to(f64).expand(C, 24, 24)
    else:
        ke = op.ke[sl].to(f64)
    if op.valid is not None:
        ke = ke * op.valid[sl].to(f64)[:, None, None]
    return ke


def _gershgorin_bound(free: torch.Tensor, rs: torch.Tensor, d: torch.Tensor) -> tuple[torch.Tensor, float]:
    """(inv_diag (N, 3), lam_max) of the Jacobi-scaled masked operator from
    its element row sums and diagonal (flat, 3N)."""
    f = free.reshape(-1)
    d_masked = torch.where((f > 0) & (d > 0), d, 1.0)
    rs_masked = torch.where(f > 0, f * rs, 1.0)
    lam = max(float((rs_masked / d_masked).max()), 1.0)
    return (1.0 / d_masked).reshape(-1, 3), lam


def coarse_matrix(op, agg: np.ndarray, n_aggs: int, xrel: np.ndarray, *, chunk: int = 8192,
                  ridge: Optional[float] = None, with_gershgorin: bool = False):
    """Exact Galerkin coarse matrix P^T A P, (6A, 6A) f64 on the operator's
    device, of the MASKED operator (A = F K F + (1 - F) I) with the
    rigid-body-mode P, plus ``ridge`` (default 1e-12) times the largest
    diagonal entry on the diagonal.

    ``with_gershgorin=True`` also returns ``(inv_diag (N, 3), lam_max)``
    for the Chebyshev smoother, accumulated in the same pass over the
    element Ke (:func:`jacobi_gershgorin` recomputes every Ke)."""
    if ridge is None:
        ridge = 1e-12
    elif ridge < 0:
        raise ValueError(f"coarse_matrix: ridge must be >= 0, got {ridge:g}")
    f64 = torch.float64
    dev = op.free.device
    elements = op.elements
    E = elements.shape[0]
    free = op.free.to(f64)
    N = free.shape[0]
    n_c = 6 * n_aggs
    Ac = torch.zeros((n_c, n_c), dtype=f64, device=dev)
    rs = torch.zeros(3 * N, dtype=f64, device=dev)
    dg = torch.zeros(3 * N, dtype=f64, device=dev)
    free_flat = free.reshape(-1)
    xrel_t = torch.as_tensor(np.asarray(xrel, np.float64), device=dev)
    agg_t = torch.as_tensor(np.asarray(agg, np.int64), device=dev)
    for start in range(0, E, chunk):
        sl = slice(start, min(start + chunk, E))
        _accumulate_chunk(Ac, rs, dg, _element_ke_chunk(op, sl), elements[sl], free_flat, xrel_t, agg_t,
                          with_gg=with_gershgorin)
    # P^T (1 - F) P: the identity rows of the masked operator, a 6x6 block
    # a node into its aggregate's diagonal block
    P_node = _rbm_blocks(xrel_t)  # (N, 3, 6)
    contrib = torch.einsum("nim,ni,nio->nmo", P_node, 1.0 - free, P_node)
    Pt1P = torch.zeros((n_aggs, 6, 6), dtype=f64, device=dev).index_add_(0, agg_t, contrib)
    a = torch.arange(n_aggs, device=dev)
    Ac.view(n_aggs, 6, n_aggs, 6)[a, :, a, :] += Pt1P
    # ridge: null rotational modes (collinear aggregates) get a positive
    # diagonal; data never has components there (range(P^T) is null(P)'s
    # orthogonal complement)
    diag = Ac.diagonal()
    scale = max(float(diag.max()), 1.0)
    diag += ridge * scale
    diag.copy_(torch.where(diag <= 0, 1.0, diag))
    if not with_gershgorin:
        return Ac
    inv_diag, lam = _gershgorin_bound(free, rs, dg)
    return Ac, inv_diag, lam


def _coarse_correct(agg: torch.Tensor, xrel: torch.Tensor, ac_inv: torch.Tensor, n_aggs: int,
                    r: torch.Tensor) -> torch.Tensor:
    """P A_c^-1 P^T r for the rigid-body-mode coarse space, in r's dtype
    (``xrel`` and ``ac_inv`` are held in it)."""
    # restriction: translations sum r, rotations sum S(x)^T r = r x x
    rc = torch.cat([r, torch.linalg.cross(r, xrel)], dim=-1)  # (N, 6)
    rc = torch.zeros((n_aggs, 6), dtype=r.dtype, device=r.device).index_add_(0, agg, rc)
    zc = (ac_inv @ rc.reshape(-1)).reshape(n_aggs, 6)
    # prolongation: translation + S(x) rot = x x rot
    zca = zc[agg]
    return zca[:, :3] + torch.linalg.cross(xrel, zca[:, 3:])


@dataclasses.dataclass(frozen=True)
class TwoLevelPrecond:
    """z = B^-1 r + P A_c^-1 P^T r: additive Schwarz of the nodal 3x3
    block-Jacobi and the exact coarse correction, in f64. The ``precond``
    of :func:`fea_tpu_torch.solvers.cg.pcg`."""

    agg: torch.Tensor  # (N,) int64 aggregate of each node
    xrel: torch.Tensor  # (N, 3) f64 radius-normalized centroid offsets
    binv: torch.Tensor  # (N, 3, 3) inverted masked diagonal blocks
    ac_inv: torch.Tensor  # (6A, 6A) f64 dense coarse inverse
    n_aggs: int

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        z1 = torch.einsum("nij,nj->ni", self.binv.to(r.dtype), r)
        return z1 + _coarse_correct(self.agg, self.xrel.to(r.dtype), self.ac_inv.to(r.dtype), self.n_aggs, r)


def _aggregate_setup(nodes, target_aggregates: Optional[int]):
    """Coarse-space sizing and aggregation of both build functions: ``None``
    scales the aggregates with the mesh (n_nodes / 40, clamped to [64,
    1024]; the cap bounds the dense (6A, 6A) inverse at 6144^2)."""
    nodes = _host(nodes)
    if target_aggregates is None:
        target_aggregates = min(1024, max(64, nodes.shape[0] // 40))
    agg, n_aggs = aggregate_nodes(nodes, target_aggregates)
    return agg, n_aggs, rigid_body_geometry(nodes, agg, n_aggs)


def build_two_level(op, nodes, *, target_aggregates: Optional[int] = None, chunk: int = 8192) -> TwoLevelPrecond:
    """The additive two-level preconditioner of ``op`` (any kind): the
    chunked Galerkin assembly and the f64 inverse of the coarse matrix, on
    the operator's device."""
    agg, n_aggs, xrel = _aggregate_setup(nodes, target_aggregates)
    dev = op.free.device
    Ac = coarse_matrix(op, agg, n_aggs, xrel, chunk=chunk)
    return TwoLevelPrecond(
        agg=torch.as_tensor(agg, dtype=torch.int64, device=dev),
        xrel=torch.as_tensor(xrel, device=dev),
        binv=op.block_diag_inv_masked(),
        ac_inv=torch.linalg.inv(Ac),
        n_aggs=n_aggs,
    )


def jacobi_gershgorin(op, *, chunk: int = 8192) -> tuple[torch.Tensor, float]:
    """Masked-operator Jacobi data with a CERTIFIED Chebyshev bound:
    ``(inv_diag (N, 3), lam_max)`` with ``lam_max >= lambda_max(D^-1 A)``.

    Gershgorin on the Jacobi-scaled masked operator, its row sums bounded
    entrywise by the triangle inequality over element contributions
    ``sum_e sum_{j free} |ke_e[i, j]|``, in one chunked pass without
    assembling A. Power iteration under-estimates, and a Chebyshev smoother
    run past the true spectrum diverges."""
    f64 = torch.float64
    free = op.free.to(f64)
    dev = free.device
    E = op.elements.shape[0]
    rs = torch.zeros(free.numel(), dtype=f64, device=dev)
    d = torch.zeros(free.numel(), dtype=f64, device=dev)
    dof = (3 * op.elements[:, :, None] + torch.arange(3, device=dev)).reshape(E, 24)
    free_flat = free.reshape(-1)
    for start in range(0, E, chunk):
        sl = slice(start, min(start + chunk, E))
        ke = _element_ke_chunk(op, sl)
        idx = dof[sl].reshape(-1)
        rs.index_add_(0, idx, (ke.abs() * free_flat[dof[sl]][:, None, :]).sum(-1).reshape(-1))
        d.index_add_(0, idx, torch.diagonal(ke, dim1=1, dim2=2).reshape(-1))
    return _gershgorin_bound(free, rs, d)


@dataclasses.dataclass(frozen=True)
class TwoLevelChebPrecond:
    """Chebyshev-smoothed MULTIPLICATIVE two-level preconditioner, all its
    work in f32:

        y = Cheb_nu(0, r)                    pre-smooth
        y = y + P A_c^-1 P^T (r - A32 y)     exact rigid-body coarse correction
        z = Cheb_nu(y, r)                    post-smooth

    The ``precond`` of the f64 FCG loop (``solve/staged.py``): the f64
    recurrence tracks the true residual while this does the
    bandwidth-heavy work in f32. A symmetric V(nu, nu) with an SPD smoother
    keeps it SPD; flexible CG absorbs the f32 rounding. Each application
    is 2 * degree + 1 f32 operator applies and one (6A, 6A) f32 product."""

    op32: object  # f32 StiffnessOperator
    agg: torch.Tensor  # (N,) int64
    xrel: torch.Tensor  # (N, 3) f32
    inv_diag: torch.Tensor  # (N, 3) f32 1 / diag of the masked operator
    lam_max: float  # certified Gershgorin bound
    ac_inv: torch.Tensor  # (6A, 6A) f32 dense coarse inverse
    n_aggs: int
    degree: int = 2
    lam_min_frac: float = 1.0 / 6.0

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        from .multigrid import chebyshev_smooth

        r32 = r.to(torch.float32)
        apply = self.op32.apply
        y = chebyshev_smooth(apply, self.inv_diag, self.lam_max, self.lam_min_frac, self.degree,
                             torch.zeros_like(r32), r32)
        # the correction is masked: the masked operator's fixed rows are the
        # identity, decoupled from the free ones, and their residual is zero
        y = y + self.op32.free * _coarse_correct(self.agg, self.xrel, self.ac_inv, self.n_aggs, r32 - apply(y))
        return chebyshev_smooth(apply, self.inv_diag, self.lam_max, self.lam_min_frac, self.degree, y, r32)


@span("fea.build.hierarchy")
def build_two_level_cheb(op, nodes, *, target_aggregates: Optional[int] = None, degree: int = 2,
                         lam_min_frac: float = 1.0 / 6.0, chunk: int = 8192,
                         ridge: float = 1e-7) -> TwoLevelChebPrecond:
    """The Chebyshev-smoothed two-level preconditioner of ``op``: one f64
    pass over the element Ke gives the Galerkin coarse matrix and the
    certified smoother bound; the coarse matrix is inverted in f64 on the
    operator's device and kept in f32, as every consumer here is f32.

    ``ridge`` is the reference's floor for a coarse matrix used in f32
    (1e-7 of the largest diagonal entry): the data has no component along
    a null rotational mode only in exact arithmetic, and at the f64 build's
    1e-12 the inverse scales f32 rounding there by 1e12 / scale (the
    73,899-DOF L-domain then took 264-334 iterations instead of 26)."""
    agg, n_aggs, xrel = _aggregate_setup(nodes, target_aggregates)
    dev = op.free.device
    f32 = torch.float32
    Ac, inv_diag, lam = coarse_matrix(op, agg, n_aggs, xrel, chunk=chunk, ridge=ridge, with_gershgorin=True)
    return TwoLevelChebPrecond(
        op32=op.astype(f32),
        agg=torch.as_tensor(agg, dtype=torch.int64, device=dev),
        xrel=torch.as_tensor(xrel, device=dev).to(f32),
        inv_diag=inv_diag.to(f32),
        lam_max=lam,
        ac_inv=torch.linalg.inv(Ac).to(f32),
        n_aggs=n_aggs,
        degree=degree,
        lam_min_frac=lam_min_frac,
    )
