"""Z-slab decomposition of the curvilinear route: the variable-weight
27-offset block stencil and its Galerkin V-cycle over a list of devices.

Counterpart of ``fea_tpu/parallel/sharding.py::shard_curvilinear``. The
weight field is the dominant state (243 values a node), so it is split by
z slabs: shard i holds the node planes [i Zl, (i + 1) Zl) of every field
it applies, as its own contiguous (27, 3, 3, Zl, Y, X) tensor on its
device; padding planes past the grid carry zero weights and a zero free
mask, so they are fixed and no term reaches a real node from them. Each
apply exchanges one plane with each neighbour and runs the slab form of
K4/K5 (``var_apply_slab``; the masked operator ``var_apply_slab_masked``,
with the mask between the neighbours' edge planes built once) on the
halo-extended slab. The slabs are cut from symmetrized fields, so each
keeps the mirror relation the kernels read by (on its first plane the
kernel reads the slab's own lower blocks).

The V-cycle follows ``ops/curvilinear.py::CurvMultigrid._vcycle`` level by
level, with the same operations in the same order: the fine level and,
when the hierarchy has one more smoothing level, level 1 run on the
shards; restriction and prolongation along z go through the +-1 plane
halo, those along y and x are local (semi-coarsening leaves z alone where
its element count is odd, and then the shards keep their planes). Slab
boundaries stay global-even on every level whose z is coarsened below it,
so Zl is ceil(Z / n) rounded up to 2^c for c such levels. The defect of
the first level past the sharded ones is gathered onto the first device,
where the remaining levels and the dense coarse inverse run as in the
unsharded preconditioner (the reference's replicated levels), and each
shard takes back its planes of the correction.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch

from ..ops.cuda_varstencil import var_apply_slab, var_apply_slab_masked
from ..ops.curvilinear import CurvilinearOperator, CurvMultigrid
from ..ops.multigrid import _prolong, _restrict
from .halo import (SHARDED_LEVELS, Shards, SlabVectors, _device, _gather, _halo_exchange,
                   _prolong_z_interleave, _restrict_z_shard, _scatter)

__all__ = ["ShardedCurvMultigrid", "ShardedCurvilinearOperator", "shard_curvilinear"]

def _weight_slabs(w: torch.Tensor, devices, zl: int) -> list[torch.Tensor]:
    """A (27, 3, 3, Z, Y, X) field cut into ``zl``-plane slabs, zero past
    its end, each a contiguous tensor of its own on its device: the one
    copy of the field a shard keeps."""
    Z = w.shape[3]
    out = []
    for i, dev in enumerate(devices):
        s, e = min(i * zl, Z), min((i + 1) * zl, Z)
        slab = torch.zeros(tuple(w.shape[:3]) + (zl,) + tuple(w.shape[4:]), dtype=w.dtype, device=dev)
        slab[:, :, :, : e - s] = w[:, :, :, s:e]
        out.append(slab)
    return out


@dataclasses.dataclass(frozen=True)
class ShardedCurvilinearOperator(SlabVectors):
    """A curvilinear operator over z shards: ``apply``, ``apply_raw`` and
    ``rhs`` of :class:`~fea_tpu_torch.ops.curvilinear.CurvilinearOperator`
    on :class:`~fea_tpu_torch.parallel.halo.Shards` of (Zl, Y, X, 3), one
    slab launch a shard (K5-slab in f64, K4-slab in f32)."""

    w: list[torch.Tensor]  # each shard's (27, 3, 3, Zl, Y, X) weights, on its device
    free: Shards  # (Zl, Y, X, 3)
    free_ext: Shards  # the mask between its neighbours' edge planes, built once: the mask is static
    z_real: int
    z_local: int

    def apply_raw(self, xs: Shards) -> Shards:
        """K @ u over all DOFs, in the dtype of ``xs``."""
        return Shards(var_apply_slab(w if w.dtype == e.dtype else w.to(e.dtype), e)
                      for w, e in zip(self.w, _halo_exchange(xs)))

    def apply(self, xs: Shards) -> Shards:
        """The masked operator F K(F x) + (1 - F) x, in the dtype of ``xs``:
        one masked slab launch a shard."""
        return Shards(var_apply_slab_masked(w if w.dtype == e.dtype else w.to(e.dtype),
                                            f if f.dtype == e.dtype else f.to(e.dtype), e)
                      for w, f, e in zip(self.w, self.free_ext, _halo_exchange(xs)))


@dataclasses.dataclass(frozen=True)
class _ShardLevel(ShardedCurvilinearOperator):
    """One multigrid level over z shards, in its own dtype."""

    inv_diag: Shards
    lam_max: float


@dataclasses.dataclass(frozen=True)
class ShardedCurvMultigrid:
    """The V-cycle of a :class:`~fea_tpu_torch.ops.curvilinear.CurvMultigrid`
    with its first ``len(levels)`` levels on z shards and the rest
    (``rest``, the same hierarchy from the first unsharded level down to
    the dense coarse inverse) on the first device. Callable on residual
    Shards of the fine level, in the fine level's dtype."""

    levels: tuple[_ShardLevel, ...]
    coarsen_axes: tuple[tuple[int, ...], ...]  # axes coarsened below each sharded level
    rest: CurvMultigrid
    top: ShardedCurvilinearOperator  # the fine geometry, for a hierarchy with no sharded level
    degree: int
    lam_min_frac: float

    _smooth = CurvMultigrid._smooth

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
        """``CurvMultigrid._vcycle`` at sharded level ``idx``."""
        level = self.levels[idx]
        axes = self.coarsen_axes[idx]
        yx = tuple(a for a in axes if a)
        z = self._smooth(level, torch.zeros_like(r), r)
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
        return self._smooth(level, z, r)

    def __call__(self, r: Shards) -> Shards:
        if self.levels:
            return self._cycle(0, r)
        # one level: the dense coarse inverse of the whole grid
        return self.top.scatter(self.rest(self.top.gather(r)))


def _geometry(Z: int, n: int, axes: Sequence[tuple[int, ...]]) -> list[int]:
    """Planes a shard at each sharded level (and the first level below
    them): ceil(Z / n) rounded up so that each z coarsening below a sharded
    level halves an even count."""
    c = sum(1 for a in axes if 0 in a)
    zl = -(-Z // n)
    zl += (-zl) % (1 << c)
    out = [zl]
    for a in axes:
        out.append(out[-1] // 2 if 0 in a else out[-1])
    return out


def shard_curvilinear(op: CurvilinearOperator, mg: CurvMultigrid, devices: Sequence,
                      ) -> tuple[ShardedCurvilinearOperator, ShardedCurvMultigrid, Callable]:
    """Z-slab decomposition of the curvilinear pipeline over ``devices``
    (torch devices or their names; entries may repeat): ``(op_sharded,
    mg_sharded, constrain)``.

    Solve with ``solve_operator_fpcg(op_sharded, constrain(loads),
    constrain(prescribed), mg_sharded)``; its displacements and reactions
    are Shards, which ``op_sharded.gather`` brings back to (N, 3).

    The build holds, beside the caller's ``op`` and ``mg``, only what it
    keeps: each shard's slab of the f64 operator's field and of each
    sharded level's field, mask and inverse diagonal, copied from the
    whole field into a new tensor on its device (one slab at a time); the
    levels past the sharded ones and the coarse inverse are moved to the
    first device. No whole field is kept: drop ``op`` and ``mg`` after the
    build and each device holds its slabs alone."""
    devices = [_device(d) for d in devices]
    n = len(devices)
    Z, Y, X = op.grid_shape
    n_sh = min(SHARDED_LEVELS, len(mg.levels) - 1)
    axes = tuple(mg.coarsen_axes[:n_sh])
    zls = _geometry(Z, n, axes)

    free = _scatter(op.free.reshape(Z, Y, X, 3), devices, zls[0])
    op_s = ShardedCurvilinearOperator(
        w=_weight_slabs(op.w, devices, zls[0]), free=free, free_ext=_halo_exchange(free), z_real=Z, z_local=zls[0],
    )
    levels = []
    for lv, zl in zip(mg.levels[:n_sh], zls):
        free = _scatter(lv.free, devices, zl)
        levels.append(_ShardLevel(
            w=_weight_slabs(lv.w, devices, zl), free=free, free_ext=_halo_exchange(free), z_real=lv.free.shape[0],
            z_local=zl, inv_diag=_scatter(lv.inv_diag, devices, zl, pad=1.0), lam_max=lv.lam_max,
        ))
    dev0 = devices[0]
    rest = CurvMultigrid(
        levels=tuple(dataclasses.replace(lv, w=lv.w.to(dev0), free=lv.free.to(dev0), inv_diag=lv.inv_diag.to(dev0))
                     for lv in mg.levels[n_sh:]),
        coarse_inv=mg.coarse_inv.to(dev0), coarsen_axes=tuple(mg.coarsen_axes[n_sh:]),
        degree=mg.degree, lam_min_frac=mg.lam_min_frac,
    )
    mg_s = ShardedCurvMultigrid(levels=tuple(levels), coarsen_axes=axes, rest=rest, top=op_s,
                                degree=mg.degree, lam_min_frac=mg.lam_min_frac)
    return op_s, mg_s, op_s.scatter
