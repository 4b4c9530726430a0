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

The V-cycle is :class:`~fea_tpu_torch.parallel.halo.ShardedMultigrid`, the
voxel route's z-sharded cycle, over this module's levels: the fine level
and, when the hierarchy has one more smoothing level, level 1 run on the
shards, with the same operations in the same order as the unsharded
``MultigridPreconditioner``. Slab boundaries stay global-even on every
level whose z is coarsened below it, so Zl is ceil(Z / n) rounded up to
2^c for c such levels (``halo.shard_geometry``). The defect of the first
level past the sharded ones is gathered onto the first device, where the
remaining levels and the dense coarse inverse run as in the unsharded
preconditioner (the reference's replicated levels), and each shard takes
back its planes of the correction.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch

from ..ops.cuda_varstencil import var_apply_slab, var_apply_slab_masked
from ..ops.curvilinear import CurvilinearOperator
from ..ops.multigrid import MultigridPreconditioner
from .halo import (SHARDED_LEVELS, ShardedMultigrid, Shards, SlabVectors, _device, _halo_exchange, _scatter,
                   shard_geometry)

__all__ = ["ShardedCurvilinearOperator", "shard_curvilinear"]


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


def shard_curvilinear(op: CurvilinearOperator, mg: MultigridPreconditioner, devices: Sequence,
                      ) -> tuple[ShardedCurvilinearOperator, ShardedMultigrid, Callable]:
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
    zls = shard_geometry(Z, n, mg.coarsen_axes[:n_sh])

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
    return op_s, ShardedMultigrid.build(mg, op_s, levels), op_s.scatter
