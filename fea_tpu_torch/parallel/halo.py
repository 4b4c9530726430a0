"""The z-sharded voxel solve: flexible PCG over the structured operator
with the node grid cut into z slabs, one slab a device, driven from one
process.

Counterpart of ``fea_tpu/parallel/halo.py`` (``ZShardedSolver``,
``build_zsharded_solver``). The reference drives its shards from one
controller too (``shard_map`` over a ``Mesh``); here the mesh is a list of
torch devices, and the list may repeat a device: four shards on one card
run every line of the decomposition, and the same code puts one shard on
each card of a host, with peer copies for the halos.

  * Every vector of the solve is a :class:`Shards`, a list of per-shard
    tensors (Zl, Y, X, 3) with shard-by-shard arithmetic: shard i holds
    global planes [i Zl, (i + 1) Zl) of the grid zero-padded to Zp = n Zl
    planes, and the padded planes are fixed (free 0, inv_diag 1).
    :func:`shard_geometry` gives Zl as the reference does: local even
    planes stay global-even, so the per-shard restriction needs only the
    +-1 plane halo. The single-device solver code runs on it unchanged:
    ``solve/fpcg.py::solve_operator_fpcg`` (the FCG recurrence of
    ``solvers/cg.py::fpcg`` and the certification of
    ``solve/certify.py``) and ``ops/multigrid.py::chebyshev_smooth``.
  * Each apply exchanges one plane with each neighbour
    (:func:`_halo_exchange`) and runs the slab kernel on the halo-extended
    slab: K3 (f64) for the FCG apply, the certification and the
    reactions; K1's halo form (f32) for the V-cycle's fine level and
    level 1 (K3 where a level is f64). A masked apply hands the kernel
    the raw slab and the halo-extended free mask, built once at build
    time, and the kernel masks inside its one launch. The slab kernel
    knows the global z boundary, so the reference's table-row gating, thin-slab z-max
    correction and phantom subtraction have no counterpart here.
  * The V-cycle (:class:`ShardedMultigrid`, which the curvilinear
    decomposition of :mod:`.curv` runs too) runs its fine level, and
    level 1 when the hierarchy has three levels or more, on the shards.
    The defect of the first replicated level is gathered onto the first
    shard's device, where the remaining levels and the coarse inverse run
    as in the unsharded preconditioner, and each shard takes back its
    planes of the correction. Transfer operators, smoother, level dtypes
    and the order of every operation are those of
    ``ops/multigrid.py::MultigridPreconditioner``, so a shard's planes
    hold what the unsharded V-cycle computes there.
  * Dots are per-shard f64 partials summed in shard order (the
    reference's ``psum``); each FCG iteration synchronises the host once,
    as ``fpcg`` does.
  * No tensor of the fine grid exists whole on any device inside the
    solve: the shards are gathered, and the padding stripped, only to
    return the :class:`~fea_tpu_torch.solve.Solution`.

The reference's double-f32 pair protocol and its recurrence floor exist
only because the TPU has no f64: the FCG here runs in native f64, and the
certification reports the true residual, as on every route of the port.

The pieces every z-slab decomposition of :mod:`fea_tpu_torch.parallel`
shares live here: :class:`Shards`, :class:`SlabVectors` (the scatter and
gather of a slab-sharded operator's vectors), the halo exchange, the z
restriction (over any in-plane axes) and prolongation, :func:`to_device`,
:func:`shard_geometry`, the sharded V-cycle :class:`ShardedMultigrid`, and
:class:`ShardedStructuredOperator`, the voxel operator on z slabs that
``sharding.shard_structured_operator`` builds and this solver runs.
"""
from __future__ import annotations

import dataclasses
import operator
from typing import Optional, Sequence

import torch

from ..dtypes import precise_dot
from ..ops.cuda_stencil import StencilWeights, check_free_mask, stencil_apply_slab
from ..ops.multigrid import MultigridPreconditioner, _Level, _prolong, _restrict
from ..ops.structured import StructuredOperator, stencil_diag_np
from ..solve._types import Solution
from ..solve.fpcg import solve_operator_fpcg

# multigrid levels a decomposition runs on its shards: the fine level and
# level 1; the levels below are small enough to run on the first device
SHARDED_LEVELS = 2

__all__ = ["ShardedMultigrid", "ShardedStructuredOperator", "Shards", "SlabVectors", "ZShardedSolver",
           "build_zsharded_solver", "shard_geometry", "to_device"]


class Shards(list):
    """A vector of the sharded solve: one tensor a shard, in shard order.

    ``+``, ``-``, ``*``, ``/`` and ``>`` act shard by shard, with another
    Shards or with a scalar (a 0-d tensor is copied to each shard's
    device); ``.add_`` adds another Shards in place; ``.to`` converts
    every shard; ``torch.zeros_like``,
    ``torch.ones_like``, ``torch.where`` of Shards and
    ``torch.linalg.vector_norm`` accept it; ``dtypes.precise_dot`` of two
    Shards is :meth:`dot`. That is all the single-device solver code asks
    of a vector.
    """

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        if kwargs:
            return NotImplemented
        if func is torch.linalg.vector_norm and len(args) == 1:
            return torch.sqrt(args[0].dot(args[0]))
        if func in (torch.zeros_like, torch.ones_like, torch.where) and all(isinstance(a, list) for a in args):
            return cls(func(*parts) for parts in zip(*args))
        return NotImplemented  # a tensor's operator then defers to ours

    def _map(self, other, op) -> "Shards":
        if isinstance(other, list):
            return Shards(op(x, y) for x, y in zip(self, other))
        if isinstance(other, torch.Tensor):
            return Shards(op(x, other.to(x.device, non_blocking=True)) for x in self)
        return Shards(op(x, other) for x in self)

    def __add__(self, other):
        return self._map(other, operator.add)

    def __sub__(self, other):
        return self._map(other, operator.sub)

    def __rsub__(self, other):
        return self._map(other, lambda x, y: y - x)

    def __mul__(self, other):
        return self._map(other, operator.mul)

    def __truediv__(self, other):
        return self._map(other, operator.truediv)

    def __rtruediv__(self, other):
        return self._map(other, lambda x, y: y / x)

    def __gt__(self, other):
        return self._map(other, operator.gt)

    __radd__ = __iadd__ = __add__
    __rmul__ = __imul__ = __mul__

    def add_(self, other: "Shards") -> "Shards":
        for x, y in zip(self, other):
            x.add_(y)
        return self

    @property
    def dtype(self) -> torch.dtype:
        return self[0].dtype

    def to(self, *args, **kwargs) -> "Shards":
        return Shards(x.to(*args, **kwargs) for x in self)

    def dot(self, other: "Shards", dtype: torch.dtype = torch.float64) -> torch.Tensor:
        """<self, other>: the shards' ``dtype`` partials summed in shard
        order, a 0-d tensor on the first shard's device."""
        total = precise_dot(self[0], other[0], dtype)
        for x, y in zip(self[1:], other[1:]):
            total = total + precise_dot(x, y, dtype).to(total.device)
        return total


def shard_geometry(Z: int, n: int, axes: Sequence[tuple[int, ...]]) -> list[int]:
    """Planes a shard at each sharded level and at the first level below
    them, for Z node planes (an extruded mesh's node layers) over n shards,
    ``axes`` the grid axes coarsened below each sharded level, z being 0:
    ceil(Z / n) rounded up so that each z coarsening below a sharded level
    halves an even count (to even for a voxel fine level alone, to a
    multiple of 4 with its level 1). The grid is padded to n times the
    first entry."""
    zl = -(-Z // n)
    zl += (-zl) % (1 << sum(1 for a in axes if 0 in a))
    out = [zl]
    for a in axes:
        out.append(out[-1] // 2 if 0 in a else out[-1])
    return out


def _halo_exchange(xs: Shards) -> Shards:
    """Each shard's slab between its neighbours' edge planes:
    (Zl, Y, X, 3) -> (Zl + 2, Y, X, 3), zero planes past the global ends.
    A neighbour's plane is a slice when it lies on the same device and a
    copy when it does not."""
    out = Shards()
    for i, x in enumerate(xs):
        below = xs[i - 1][-1:].to(x.device, non_blocking=True) if i > 0 else torch.zeros_like(x[:1])
        above = xs[i + 1][:1].to(x.device, non_blocking=True) if i + 1 < len(xs) else torch.zeros_like(x[:1])
        out.append(torch.cat([below, x, above]))
    return out


def _restrict_z_shard(d: Shards, axes: tuple[int, ...] = (1, 2)) -> Shards:
    """Full-weighting restriction, shard by shard: the in-plane ``axes``
    locally, z through the +-1 plane halo (coarse plane j, at fine plane
    2j, reads fine planes 2j - 1 .. 2j + 1). (Zl, Y, X, 3) ->
    (Zl / 2, Yc, Xc, 3) a shard (any trailing shape: ``axes=()`` restricts
    z alone), the same operations as ``_restrict`` with z among its axes."""
    out = Shards()
    for e in _halo_exchange(d):
        half = (e.shape[0] - 2) // 2
        eyx = _restrict(e, axes=axes)
        out.append(eyx[1::2][:half] + 0.5 * (eyx[0::2][:half] + eyx[2::2][:half]))
    return out


def _prolong_z_interleave(c: torch.Tensor) -> torch.Tensor:
    """Linear interpolation along z of a shard's coarse planes and the
    plane above them: (Zl / 2 + 1, ...) -> (Zl, ...), fine plane 2j =
    c[j] and 2j + 1 = (c[j] + c[j + 1]) / 2, the z step of ``_prolong``."""
    ev = c[:-1]
    od = 0.5 * (c[:-1] + c[1:])
    return torch.stack([ev, od], dim=1).reshape((2 * ev.shape[0],) + tuple(c.shape[1:]))


def _scatter(grid: torch.Tensor, devices: Sequence[torch.device], zl: int, pad: float = 0.0) -> Shards:
    """A level's grid (Z, Y, X, 3) -> its shards of ``zl`` planes, each on
    its device, planes past Z filled with ``pad``."""
    Z = grid.shape[0]
    out = Shards()
    for i, dev in enumerate(devices):
        s, e = min(i * zl, Z), min((i + 1) * zl, Z)
        slab = torch.full((zl,) + tuple(grid.shape[1:]), pad, dtype=grid.dtype, device=dev)
        slab[: e - s] = grid[s:e]
        out.append(slab)
    return out


def _gather(xs: Shards, planes: int) -> torch.Tensor:
    """The first ``planes`` planes of the shards, on the first shard's device."""
    return torch.cat([x.to(xs[0].device) for x in xs])[:planes]


def _device(d) -> torch.device:
    d = torch.device(d)
    return torch.device("cuda", torch.cuda.current_device()) if d.type == "cuda" and d.index is None else d


def to_device(obj, device):
    """A frozen dataclass (an operator, a level, a coarse space) with
    every tensor in it, in nested dataclasses too, on ``device``: a copy
    for each device of what a decomposition replicates. A nested
    dataclass with a ``to`` of its own moves by it (``StencilWeights``
    keeps its host table on the host)."""
    changes = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            changes[f.name] = v.to(device)
        elif dataclasses.is_dataclass(v):
            changes[f.name] = v.to(device) if hasattr(v, "to") else to_device(v, device)
    return dataclasses.replace(obj, **changes)


class SlabVectors:
    """The vectors of an operator sharded by z slabs: ``free`` is a
    :class:`Shards` of ``z_local`` planes a shard, over ``z_real`` real
    planes (a voxel or curvilinear grid's (Y, X, 3) planes, an extruded
    mesh's (n2, 3) node layers). :meth:`scatter` and :meth:`gather` move
    the scene's (N, 3) vectors onto the shards and back."""

    @property
    def devices(self) -> list[torch.device]:
        return [f.device for f in self.free]

    @property
    def dtype(self) -> torch.dtype:
        return self.free.dtype

    @property
    def n_dof(self) -> int:
        return self.z_real * self.free[0][0].numel()

    def scatter(self, flat: torch.Tensor) -> Shards:
        """(N, 3) node values -> shards in the same dtype, zero past the
        real planes."""
        return _scatter(flat.reshape((self.z_real,) + tuple(self.free[0].shape[1:])), self.devices, self.z_local)

    def gather(self, xs: Shards) -> torch.Tensor:
        """Shards -> (N, 3) node values on the first shard's device."""
        return _gather(xs, self.z_real).reshape(-1, self.free[0].shape[-1])

    rhs = StructuredOperator.rhs


@dataclasses.dataclass(frozen=True)
class ShardedStructuredOperator(SlabVectors):
    """A structured operator over z shards of ``z_local`` planes: the
    masked ``apply`` and ``rhs`` of ``StructuredOperator`` on Shards,
    one slab launch a shard (K3 in f64, K1's halo form in f32)."""

    weights: list[StencilWeights]  # Ke on each shard's device
    free: Shards
    free_ext: Shards  # the mask between its neighbours' edge planes, built once: the mask is static
    z_real: int  # real node planes
    z_local: int

    def apply_raw(self, xs: Shards) -> Shards:
        """K @ u over all DOFs, one slab launch a shard."""
        return Shards(
            stencil_apply_slab(w, e, i * self.z_local, self.z_real)
            for i, (w, e) in enumerate(zip(self.weights, _halo_exchange(xs)))
        )

    def apply(self, xs: Shards) -> Shards:
        """The masked operator F K(F x) + (1 - F) x, one slab launch a
        shard: the halos of ``xs`` are exchanged raw and the kernel masks
        them by ``free_ext``."""
        return Shards(
            stencil_apply_slab(w, e, i * self.z_local, self.z_real, f)
            for i, (w, e, f) in enumerate(zip(self.weights, _halo_exchange(xs), self.free_ext))
        )

    def diag_raw(self) -> Shards:
        """The assembled diagonal of K on the shards (Jacobi), filled by
        region on the host and scattered."""
        Y, X = self.free[0].shape[1:3]
        ke = self.weights[0].ke.cpu().double().numpy()
        d = stencil_diag_np(ke, (X - 1, Y - 1, self.z_real - 1))
        return self.scatter(torch.as_tensor(d).to(self.dtype))

    def diag_masked(self) -> Shards:
        return self.free * self.diag_raw() + (1.0 - self.free)


@dataclasses.dataclass(frozen=True)
class _ShardLevel(ShardedStructuredOperator):
    """One multigrid level over z shards."""

    inv_diag: Shards
    lam_max: float


@dataclasses.dataclass(frozen=True)
class ShardedMultigrid:
    """The V-cycle of a :class:`~fea_tpu_torch.ops.multigrid.MultigridPreconditioner`
    with its first ``len(levels)`` levels on z shards and the rest
    (``rest``, the same hierarchy from the first unsharded level down to
    the dense coarse inverse) on the first device. A sharded level is a
    slab operator with ``inv_diag`` and ``lam_max`` (the voxel
    :class:`_ShardLevel` or ``curv._ShardLevel``). Restriction and
    prolongation along z go through the +-1 plane halo, those along y and
    x are local (semi-coarsening leaves z alone where its element count is
    odd, and then the shards keep their planes). Callable on residual
    Shards of the fine level, in the fine level's dtype."""

    levels: tuple
    coarsen_axes: tuple[tuple[int, ...], ...]  # axes coarsened below each sharded level
    rest: MultigridPreconditioner
    top: SlabVectors  # the fine geometry, for a hierarchy with no sharded level

    @classmethod
    def build(cls, mg: MultigridPreconditioner, top: SlabVectors, levels) -> "ShardedMultigrid":
        """``mg``'s V-cycle with its first levels replaced by ``levels``,
        their shards, and the rest of it moved to the first shard's device."""
        n_sh, dev0 = len(levels), top.devices[0]
        rest = dataclasses.replace(mg, levels=tuple(to_device(lv, dev0) for lv in mg.levels[n_sh:]),
                                   coarse_inv=mg.coarse_inv.to(dev0), coarsen_axes=mg.coarsen_axes[n_sh:])
        return cls(levels=tuple(levels), coarsen_axes=mg.coarsen_axes[:n_sh], rest=rest, top=top)

    def _replicated(self, rc: Shards, z_coarsened: bool) -> Shards:
        """The levels past the sharded ones: gather the defect onto the
        first device, run their V-cycle, and hand each shard its planes of
        the masked correction (and the plane above, when z was coarsened)."""
        coarse = self.rest.levels[0]
        zl = rc[0].shape[0]
        full = coarse.free * _gather(rc, coarse.free.shape[0]).to(coarse.dtype)
        zc = coarse.free * self.rest._vcycle(0, full)
        extra = 1 if z_coarsened else 0
        zc = torch.cat([zc, zc.new_zeros((len(rc) * zl + extra - zc.shape[0],) + tuple(zc.shape[1:]))])
        return Shards(zc[i * zl : (i + 1) * zl + extra].to(x.device, non_blocking=True) for i, x in enumerate(rc))

    def _cycle(self, idx: int, r: Shards) -> Shards:
        """``MultigridPreconditioner._vcycle`` at sharded level ``idx``."""
        level = self.levels[idx]
        axes = self.coarsen_axes[idx]
        yx = tuple(a for a in axes if a)
        z = self.rest._smooth(level, torch.zeros_like(r), r)
        d = r - level.apply(z)
        rc = _restrict_z_shard(d, yx) if 0 in axes else Shards(_restrict(x, yx) for x in d)
        if idx + 1 < len(self.levels):
            coarse = self.levels[idx + 1]
            zc = self._cycle(idx + 1, coarse.free * rc.to(coarse.dtype))
            zc = coarse.free * zc
            # each shard's planes and the plane above them, from the next shard
            zc = Shards(e[1:] for e in _halo_exchange(zc)) if 0 in axes else zc
        else:
            zc = self._replicated(rc, 0 in axes)
        corr = Shards(_prolong(_prolong_z_interleave(c) if 0 in axes else c, yx).to(r.dtype) for c in zc)
        z = z + level.free.to(r.dtype) * corr
        return self.rest._smooth(level, z, r)

    def __call__(self, r: Shards) -> Shards:
        if self.levels:
            return self._cycle(0, r)
        # one level: the dense coarse inverse of the whole grid
        return self.top.scatter(self.rest(self.top.gather(r)))


class ZShardedSolver:
    """f64 flexible PCG with the multigrid V-cycle, z-sharded over
    ``devices``. Built by :func:`build_zsharded_solver`; :meth:`solve`
    takes the loads (and prescribed values) of the operator's scene."""

    def __init__(self, op_hi: StructuredOperator, mg: MultigridPreconditioner,
                 devices: Sequence, *, shard_levels: int = SHARDED_LEVELS):
        if len(mg.levels) < 2:
            raise ValueError(
                "z-sharded solve needs a >= 2-level hierarchy (the fine level shards, "
                f"levels 1+ replicate); got {len(mg.levels)} level(s): enlarge the scene "
                "or lower coarse_dof_limit"
            )
        if op_hi.free.dtype != torch.float64:
            raise TypeError(f"z-sharded solve needs the f64 operator, got {op_hi.free.dtype}")
        self.devices = [_device(d) for d in devices]
        Z, Y, X = op_hi.grid_shape
        self.grid_shape = (Z, Y, X)
        n_sh = min(max(shard_levels, 1), SHARDED_LEVELS, len(mg.levels) - 1)
        zls = shard_geometry(Z, len(self.devices), mg.coarsen_axes[:n_sh])
        self.z_local = zls[0]
        free = _scatter(check_free_mask(op_hi.free).reshape(Z, Y, X, 3), self.devices, self.z_local)
        self.op = ShardedStructuredOperator(
            weights=self._on_devices(op_hi.weights), free=free, free_ext=_halo_exchange(free),
            z_real=Z, z_local=self.z_local,
        )
        self.mg = ShardedMultigrid.build(mg, self.op, [self._shard(lv, zl) for lv, zl in zip(mg.levels[:n_sh], zls)])

    def _on_devices(self, w: StencilWeights) -> list[StencilWeights]:
        per = {d: w.to(d) for d in set(self.devices)}
        return [per[d] for d in self.devices]

    def _shard(self, lv: _Level, zl: int) -> _ShardLevel:
        free = _scatter(check_free_mask(lv.free), self.devices, zl)
        return _ShardLevel(
            weights=self._on_devices(lv.weights), free=free, free_ext=_halo_exchange(free),
            inv_diag=_scatter(lv.inv_diag, self.devices, zl, pad=1.0),
            lam_max=lv.lam_max, z_real=lv.free.shape[0], z_local=zl,
        )

    def precondition(self, r: Shards) -> Shards:
        """z = M^-1 r: the sharded V-cycle of residual shards in the fine
        level's dtype, as ``MultigridPreconditioner`` takes them."""
        return self.mg(r)

    # -- the solve --------------------------------------------------------------

    def scatter(self, flat: torch.Tensor) -> Shards:
        """(N, 3) node values -> f64 shards, zero past the grid."""
        Z, Y, X = self.grid_shape
        return _scatter(flat.to(torch.float64).reshape(Z, Y, X, 3), self.devices, self.z_local)

    def gather(self, xs: Shards) -> torch.Tensor:
        """Shards -> (N, 3) node values on the first shard's device."""
        return _gather(xs, self.grid_shape[0]).reshape(-1, 3)

    def solve(self, loads: torch.Tensor, prescribed: Optional[torch.Tensor] = None, *,
              tol: float = 1e-8, max_iters: int = 300, max_refine: int = 3) -> Solution:
        """Solve the masked system to a true relative residual of ``tol``:
        ``solve_operator_fpcg`` on the shards. ``loads`` and ``prescribed``
        are (N, 3) on any device; the solution lands on the first shard's
        device."""
        sol = solve_operator_fpcg(
            self.op, self.scatter(loads), self.scatter(torch.zeros_like(loads) if prescribed is None else prescribed),
            self.precondition, tol=tol, max_iters=max_iters, max_refine=max_refine,
        )
        return Solution(displacements=self.gather(sol.displacements), reactions=self.gather(sol.reactions),
                        stats=sol.stats)


def build_zsharded_solver(op_hi: StructuredOperator, mg: MultigridPreconditioner, devices: Sequence, *,
                          shard_levels: int = SHARDED_LEVELS) -> ZShardedSolver:
    """The z-sharded solver of ``op_hi`` (the f64 structured operator)
    with the V-cycle of ``mg`` (its multigrid hierarchy), one z shard on
    each entry of ``devices`` (torch devices or their names; entries may
    repeat). ``shard_levels=2`` (default) shards level 1 as well as the
    fine level when the hierarchy has three levels or more; 1 shards the
    fine level only."""
    return ZShardedSolver(op_hi, mg, devices, shard_levels=shard_levels)
