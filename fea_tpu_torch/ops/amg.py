"""Arbitrary-topology hex8 meshes: the stiffness assembled into node-major
block-CSR (BCSR) and a smoothed-aggregation (SA) multigrid over it.

**The apply.** The stiffness is assembled once into, per node, a padded
list of at most V neighbour nodes and their b x b coupling blocks,

    (K u)[n] = sum_v  W[n, v] @ u[nbr[n, v]],

so an apply is one gather and one batched product, with no scatter and
no element geometry (padded entries point at node 0 with a zero block).
:class:`BCSROperator` runs it in torch: in f64 for the FCG apply and the
certification, in f32 on the V-cycle's levels. There is no Pallas kernel
for it in the reference, and none is written here.

**The hierarchy.** Geometric aggregation (``ops/twolevel.py``), a
tentative prolongation per aggregate from the rigid-body near-null space
orthonormalized by its normal equations, Galerkin coarse operators (BCSR
again, block size 6), certified-Gershgorin Chebyshev smoothing on every
level, and a dense f64 inverse of the coarsest.

Everything is built in torch on the device of the assembly (the scene's),
in f64: the element Ke batch, the sort of the block triplets, the
Galerkin products, the coarse inverse; only the aggregation and the
aggregate centroids run in NumPy on the host. The restriction sums by
``index_add_``, so on the card its f32 sums are not in a fixed order.

Counterpart of ``fea_tpu/ops/amg.py``. Its ``BCSRPairOperator`` and
``split_bcsr_pair`` (the double-f32 pair apply) are not ported: they exist
because the TPU has no f64, and the card applies in native f64.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..elements import hex8 as hex8_el
from ..utils.profiling import span
from .multigrid import chebyshev_smooth

__all__ = [
    "AMGPrecond",
    "BCSRHost",
    "BCSROperator",
    "assemble_bcsr",
    "build_amg",
]


# -- assembly ------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BCSRHost:
    """Node-major block-sparse stiffness in f64, the assembly's result (on
    the device it was assembled on).

    ``nbr (N, V)`` int64 neighbour node ids (padded entries point at node
    0 with an all-zero block); ``W (N, V, b, b)`` the coupling blocks of
    the RAW (unmasked) operator; ``free (N, b)`` 0/1. The masked operator
    is ``F A F + (1 - F)``."""

    nbr: torch.Tensor
    W: torch.Tensor
    free: torch.Tensor
    min_detj: float = 1.0  # least element Jacobian determinant seen at assembly


def _reduce_triplets(rows: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor, N: int):
    """Sum duplicate (row, col) block triplets: ``(rows_u, cols_u, sums)``
    sorted by (row, col)."""
    key, order = torch.sort(rows * N + cols, stable=True)
    uniq, inverse = torch.unique_consecutive(key, return_inverse=True)
    slot = torch.empty_like(inverse)
    slot[order] = inverse
    sums = vals.new_zeros((uniq.numel(),) + vals.shape[1:]).index_add_(0, slot, vals)
    return uniq // N, uniq % N, sums


def _pad_bcsr(rows_u: torch.Tensor, cols_u: torch.Tensor, sums: torch.Tensor, N: int, b: int):
    """Sorted-unique triplets -> padded ``(nbr (N, V), W (N, V, b, b))``."""
    counts = torch.bincount(rows_u, minlength=N)
    V = max(int(counts.max()), 1) if N else 1
    row_start = torch.cumsum(counts, 0) - counts
    slot = torch.arange(rows_u.numel(), device=rows_u.device) - row_start[rows_u]
    nbr = torch.zeros((N, V), dtype=torch.int64, device=rows_u.device)
    W = sums.new_zeros((N, V, b, b))
    nbr[rows_u, slot] = cols_u
    W[rows_u, slot] = sums
    return nbr, W


@span("fea.build.operator")
def assemble_bcsr(nodes: torch.Tensor, elements: torch.Tensor, material, fixed: torch.Tensor, *,
                  chunk: int = 32_768) -> BCSRHost:
    """Assemble the hex8 stiffness into node-major BCSR in f64 on the
    nodes' device: Ke in chunks of elements (the element-by-element
    operator's integration), its 64 corner blocks an element as (row, col)
    triplets, summed by one sort."""
    f64 = torch.float64
    nodes = nodes.to(f64)
    elements = elements.to(torch.int64)
    N = nodes.shape[0]
    E = elements.shape[0]
    kes, min_detj = [], float("inf")
    for s in range(0, E, chunk):
        geom = hex8_el.precompute_geometry(nodes, elements[s : s + chunk])
        kes.append(hex8_el.stiffness_from_geometry(geom, material))
        min_detj = min(min_detj, float(geom.min_detj))
    ke = torch.cat(kes) if kes else nodes.new_zeros((0, 24, 24))
    del kes
    # (E, 8a, 8b, 3, 3) corner blocks: row node a, column node b
    blocks = ke.reshape(E, 8, 3, 8, 3).transpose(2, 3).reshape(-1, 3, 3)
    del ke
    rows = elements.repeat_interleave(8, dim=1).reshape(-1)
    cols = elements.repeat(1, 8).reshape(-1)
    nbr, W = _pad_bcsr(*_reduce_triplets(rows, cols, blocks, N), N, 3)
    free = 1.0 - fixed.to(f64)
    return BCSRHost(nbr=nbr, W=W, free=free, min_detj=min_detj if E else 1.0)


# -- operator ------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BCSROperator:
    """BCSR stiffness with the interface of ``CurvilinearOperator``
    (``apply``, ``apply_raw``, ``rhs``, ``free``, ``n_dof``), so the staged
    FCG loop and ``certify.refine_true`` take it as they stand.

    The blocks are held as ``Wt (N, b, V, b)`` (entry [n, i, v, j] =
    W[n, v, i, j]), so that an apply is one gather of the (N, V * b)
    neighbour values and one batched (b, V b) @ (V b, 1) product a node."""

    nbr: torch.Tensor  # (N, V) int64
    Wt: torch.Tensor  # (N, b, V, b)
    free: torch.Tensor  # (N, b) 0/1, the blocks' dtype

    @classmethod
    def from_blocks(cls, nbr: torch.Tensor, W: torch.Tensor, free: torch.Tensor,
                    dtype: torch.dtype = torch.float32) -> "BCSROperator":
        """The operator of ``(N, V)`` ids and ``(N, V, b, b)`` blocks."""
        return cls(nbr=nbr, Wt=W.permute(0, 2, 1, 3).to(dtype).contiguous(), free=free.to(dtype))

    @property
    def n_nodes(self) -> int:
        return self.free.shape[0]

    @property
    def dofs_per_node(self) -> int:
        return self.free.shape[1]

    @property
    def n_dof(self) -> int:
        return self.free.numel()

    @property
    def dtype(self) -> torch.dtype:
        return self.free.dtype

    def astype(self, dtype: torch.dtype) -> "BCSROperator":
        return dataclasses.replace(self, Wt=self.Wt.to(dtype), free=self.free.to(dtype))

    def apply_raw(self, u: torch.Tensor) -> torch.Tensor:
        """K @ u over all DOFs, u (N, b) in the blocks' dtype."""
        N, b, V, _ = self.Wt.shape
        g = u.index_select(0, self.nbr.reshape(-1)).reshape(N, V * b, 1)
        return torch.bmm(self.Wt.reshape(N, b, V * b), g).reshape(N, b)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        F = self.free
        return F * self.apply_raw(F * x) + (1.0 - F) * x

    def rhs(self, loads: torch.Tensor, prescribed: torch.Tensor) -> torch.Tensor:
        F = self.free.to(loads.dtype)
        xp = (1.0 - F) * prescribed.to(loads.dtype)
        return F * (loads - self.apply_raw(xp)) + xp

    def diag_masked(self) -> torch.Tensor:
        """The masked operator's diagonal; the self block sits in slot 0
        (:func:`build_amg` puts it there)."""
        d = torch.diagonal(self.Wt[:, :, 0, :], dim1=1, dim2=2)
        return self.free * d + (1.0 - self.free)


def _self_first(nbr: torch.Tensor, W: torch.Tensor, N: int):
    """Each row reordered so that its self entry (col == row) sits in slot
    0; a row without one keeps slot 0 as it is."""
    rows = torch.arange(N, device=nbr.device)
    is_self = nbr == rows[:, None]
    sidx = torch.where(is_self.any(dim=1), is_self.to(torch.int8).argmax(dim=1), 0)
    o = torch.arange(nbr.shape[1], device=nbr.device).repeat(N, 1)
    o[rows, sidx] = o[rows, 0]
    o[rows, 0] = sidx
    return torch.take_along_dim(nbr, o, 1), torch.take_along_dim(W, o[:, :, None, None], 1)


# -- smoothed-aggregation hierarchy -------------------------------------------


def _merge_tiny_aggregates(coords: np.ndarray, agg: np.ndarray, n_aggs: int, *, min_size: int):
    """Aggregates below ``min_size`` nodes merged into the nearest aggregate
    of adequate size (by centroid), ids compacted. Geometric binning leaves
    tiny cells at the corners of irregular domains, whose near-singular
    rigid-body Gram injects near-null coarse directions."""
    counts = np.bincount(agg, minlength=n_aggs)
    tiny = counts < min_size
    if not tiny.any() or (~tiny).sum() == 0:
        return agg, n_aggs
    centers = np.zeros((n_aggs, 3))
    np.add.at(centers, agg, np.asarray(coords, np.float64))
    centers /= np.maximum(counts, 1)[:, None]
    big_ids = np.nonzero(~tiny)[0]
    tc = centers[tiny]
    nearest = np.empty(tc.shape[0], np.int64)
    for i0 in range(0, tc.shape[0], 1024):
        d = np.linalg.norm(tc[i0 : i0 + 1024, None, :] - centers[big_ids][None], axis=-1)
        nearest[i0 : i0 + 1024] = big_ids[d.argmin(axis=1)]
    remap = np.arange(n_aggs)
    remap[np.nonzero(tiny)[0]] = nearest
    new_ids, agg2 = np.unique(remap[agg], return_inverse=True)
    return agg2.astype(np.int32), int(new_ids.size)


def _tentative_P(agg: torch.Tensor, n_aggs: int, B: torch.Tensor, free: torch.Tensor):
    """Tentative prolongation blocks from the near-null space ``B (N, b,
    6)``, zeroed on fixed DOFs, orthonormalized an aggregate by its normal
    equations (Q = B_a G^-1/2, G = B_a^T B_a; zero rows stay exactly zero).
    Near-singular modes (weaker than 1e-6 of the aggregate's strongest) are
    dropped: their columns are zero and the coarse level pins them.

    Returns ``(P (N, b, 6), Bc (n_aggs, 6, 6), weak (n_aggs, 6) bool)``."""
    Bf = B * free[:, :, None]
    G = B.new_zeros((n_aggs, 6, 6)).index_add_(0, agg, torch.einsum("nbi,nbj->nij", Bf, Bf))
    evals, evecs = torch.linalg.eigh(G)  # ascending
    emax = evals[:, -1].clamp_min(1e-300)
    weak = evals < 1e-6 * emax[:, None]
    inv_sqrt = torch.where(weak, 0.0, 1.0 / torch.sqrt(torch.where(weak, 1.0, evals)))
    Ghalf_inv = torch.einsum("aik,ak,ajk->aij", evecs, inv_sqrt, evecs)
    P = torch.einsum("nbi,nij->nbj", Bf, Ghalf_inv[agg])
    # coarse near-null space: B = P Bc, Bc = G^1/2 with the weak modes zeroed
    sqrtv = torch.where(weak, 0.0, torch.sqrt(evals.clamp_min(0.0)))
    Bc = torch.einsum("aik,ak,ajk->aij", evecs, sqrtv, evecs)
    return P, Bc, weak


def _galerkin_bcsr(nbr, W, free, P, agg, n_aggs: int, *, chunk: int = 65_536):
    """Coarse BCSR = P^T (F A F) P of a BCSR level, in chunks of rows: the
    fine entry (n, v) with column m = nbr[n, v] adds ``P[n]^T (F_n W F_m)
    P[m]`` to the coarse pair (agg[n], agg[m])."""
    N, V = nbr.shape
    parts = []
    for s0 in range(0, N, chunk):
        s1 = min(s0 + chunk, N)
        nb = nbr[s0:s1]
        Wm = W[s0:s1] * free[s0:s1, None, :, None] * free[nb][:, :, None, :]
        term = torch.einsum("cbi,cvbd,cvdj->cvij", P[s0:s1], Wm, P[nb])
        parts.append(_reduce_triplets(agg[s0:s1].repeat_interleave(V), agg[nb].reshape(-1),
                                      term.reshape(-1, 6, 6), n_aggs))
    rows, cols, vals = (torch.cat(p) for p in zip(*parts))
    return _pad_bcsr(*_reduce_triplets(rows, cols, vals, n_aggs), n_aggs, 6)


def _gershgorin_bcsr(nbr, W, free) -> tuple[torch.Tensor, float]:
    """(inv_diag (N, b), lam_max) of the Jacobi-scaled MASKED operator:
    a certified row-sum bound."""
    N = nbr.shape[0]
    Wm = W * free[:, None, :, None] * free[nbr][:, :, None, :]
    rs = Wm.abs().sum(dim=(1, 3))  # (N, b)
    is_self = (nbr == torch.arange(N, device=nbr.device)[:, None]).to(W.dtype)
    diag = (torch.diagonal(Wm, dim1=2, dim2=3) * is_self[:, :, None]).sum(dim=1)
    d_masked = torch.where((free > 0) & (diag > 0), diag, 1.0)
    rs_masked = torch.where(free > 0, rs, 1.0)
    lam = max(float((rs_masked / d_masked).max()), 1.0)
    return 1.0 / d_masked, lam


def _dense_from_bcsr(nbr, W, free) -> torch.Tensor:
    """The masked dense matrix of a (small) BCSR level."""
    N, V, b, _ = W.shape
    n = N * b
    dev = W.device
    blk = W * free[:, None, :, None] * free[nbr][:, :, None, :]
    ib = torch.arange(b, device=dev)
    rows = (torch.arange(N, device=dev)[:, None, None, None] * b + ib[None, None, :, None]).expand(N, V, b, b)
    cols = (nbr[:, :, None, None] * b + ib[None, None, None, :]).expand(N, V, b, b)
    K = W.new_zeros((n, n)).index_put_((rows.reshape(-1), cols.reshape(-1)), blk.reshape(-1), accumulate=True)
    f = free.reshape(-1)
    K = f[:, None] * K * f[None, :]
    K.diagonal().add_(1.0 - f)
    return K


@dataclasses.dataclass(frozen=True)
class _AMGLevel:
    op: BCSROperator  # f32, masked apply
    inv_diag: torch.Tensor  # (N, b) f32
    lam_max: float  # certified Gershgorin bound, on the host
    # the transfer to the next (coarser) level; None on the coarsest
    P: Optional[torch.Tensor] = None  # (N, b, 6) f32
    agg: Optional[torch.Tensor] = None  # (N,) int64
    n_aggs: int = 0


@dataclasses.dataclass(frozen=True)
class AMGPrecond:
    """The SA V-cycle, callable on (N, 3) residuals (returns f32): the
    ``precond`` of the staged FCG loop. Nothing in it reads a value back
    to the host, so its calls can be captured in a CUDA graph."""

    levels: tuple  # of _AMGLevel
    coarse_inv: torch.Tensor  # (nc, nc) f64
    degree: int = 2
    lam_min_frac: float = 1.0 / 6.0

    def _smooth(self, level: _AMGLevel, x: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
        return chebyshev_smooth(level.op.apply, level.inv_diag, level.lam_max, self.lam_min_frac, self.degree, x, r)

    def _restrict(self, level: _AMGLevel, r: torch.Tensor) -> torch.Tensor:
        # r_c[a] = sum_{n in a} P[n]^T r[n]
        contrib = torch.einsum("nbi,nb->ni", level.P, r)
        return contrib.new_zeros((level.n_aggs, 6)).index_add_(0, level.agg, contrib)

    def _prolong(self, level: _AMGLevel, zc: torch.Tensor) -> torch.Tensor:
        return torch.einsum("nbi,ni->nb", level.P, zc[level.agg])

    def _vcycle(self, idx: int, r: torch.Tensor) -> torch.Tensor:
        level = self.levels[idx]
        if idx == len(self.levels) - 1:
            # the coarsest matrix carries the mesh's whole conditioning: an
            # f32 inverse there is O(kappa eps32), garbage in the modes this
            # level owns
            return (self.coarse_inv @ r.reshape(-1).to(torch.float64)).to(r.dtype).reshape(r.shape)
        z = self._smooth(level, torch.zeros_like(r), r)
        rc = self._restrict(level, r - level.op.apply(z))
        coarse_free = self.levels[idx + 1].op.free
        zc = self._vcycle(idx + 1, coarse_free * rc)
        z = z + self._prolong(level, coarse_free * zc)
        return self._smooth(level, z, r)

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        return self._vcycle(0, r.to(torch.float32))


@span("fea.build.hierarchy")
def build_amg(
    nodes,
    host: BCSRHost,
    *,
    degree: int = 2,
    nodes_per_aggregate: int = 32,
    max_coarse_dof: int = 4000,
    max_levels: int = 6,
    progress: Optional[Callable[[str], None]] = None,
) -> AMGPrecond:
    """The SA hierarchy over the assembled level 0, on its device.

    Aggregation is geometric on each level's coordinates (node positions,
    then aggregate centroids), the near-null space is carried down by the
    tentative prolongations (B_{l+1} = G^1/2), and every level's smoother
    bound is a certified Gershgorin row sum, computed here on the host
    (never inside a V-cycle). ``progress`` is given a line at each stage."""
    from .twolevel import _rbm_blocks, aggregate_nodes

    say = progress if progress is not None else (lambda s: None)
    dev = host.W.device
    f64 = torch.float64
    nbr, W = _self_first(host.nbr, host.W, host.nbr.shape[0])
    free = host.free
    coords = nodes.cpu().numpy() if isinstance(nodes, torch.Tensor) else np.asarray(nodes)
    coords = coords.astype(np.float64)
    b = W.shape[2]

    # fine near-null space: rigid-body modes [I3 | S(xrel)] about the global
    # centre, radius-normalized
    xrel = coords - coords.mean(axis=0)
    xrel = xrel / max(float(np.linalg.norm(xrel, axis=1).max()), 1e-30)
    B = _rbm_blocks(torch.as_tensor(xrel, device=dev))

    levels = []
    while True:
        n_dof = nbr.shape[0] * b
        inv_diag, lam = _gershgorin_bcsr(nbr, W, free)
        say(f"amg level {len(levels)}: {nbr.shape[0]} nodes x {b} dof, V={nbr.shape[1]}, lam_max {lam:.2f}")
        lvl = dict(op=BCSROperator.from_blocks(nbr, W, free), inv_diag=inv_diag.to(torch.float32), lam_max=lam)
        if n_dof <= max_coarse_dof or len(levels) + 1 >= max_levels:
            levels.append(_AMGLevel(**lvl))
            break
        agg, n_aggs = aggregate_nodes(coords, max(1, nbr.shape[0] // nodes_per_aggregate))
        agg, n_aggs = _merge_tiny_aggregates(coords, agg, n_aggs, min_size=max(2, nodes_per_aggregate // 8))
        if n_aggs >= nbr.shape[0]:  # aggregation stopped making progress
            levels.append(_AMGLevel(**lvl))
            break
        say(f"amg aggregate -> {n_aggs} aggregates")
        agg_t = torch.as_tensor(agg, dtype=torch.int64, device=dev)
        P, Bc, weak = _tentative_P(agg_t, n_aggs, B, free)
        nbr_c, W_c = _galerkin_bcsr(nbr, W, free, P, agg_t, n_aggs)
        nbr_c, W_c = _self_first(nbr_c, W_c, n_aggs)
        # dropped (weak) coarse modes are pinned, with a unit diagonal where
        # theirs is not positive (slot 0 is the self block)
        free_c = torch.where(weak, 0.0, 1.0).to(f64)
        for k in range(6):
            d = W_c[:, 0, k, k]
            W_c[:, 0, k, k] = torch.where(weak[:, k] & ~(d > 0), 1.0, d)
        levels.append(_AMGLevel(**lvl, P=P.to(torch.float32), agg=agg_t, n_aggs=n_aggs))
        counts = np.bincount(agg, minlength=n_aggs).astype(np.float64)
        centers = np.zeros((n_aggs, 3))
        np.add.at(centers, agg, coords)
        coords = centers / counts[:, None]
        nbr, W, free, B, b = nbr_c, W_c, free_c, Bc, 6

    say(f"amg coarsest dense inverse ({nbr.shape[0] * b} DOF)")
    coarse_inv = torch.linalg.inv(_dense_from_bcsr(nbr, W, free))
    return AMGPrecond(levels=tuple(levels), coarse_inv=coarse_inv, degree=degree)
