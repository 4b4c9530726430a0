"""Layer-slab decomposition of the extruded route: the per-quad Ke
operator, the z-semicoarsened line-smoothed V-cycle and its section-RBM
composition over a list of devices.

Counterpart of ``fea_tpu/parallel/sharding.py::shard_extruded``. The node
order is layer-major, so a shard is a slab of node layers: shard i holds
layers [i Ll, (i + 1) Ll) of every field it applies, padding layers past
the mesh fixed (free 0, an identity block in the block-Jacobi). The small
per-layer data (the section Ke, the incidence, the layer-block inverses)
is copied to each device.

  * Apply: each shard exchanges one node layer with each neighbour and
    computes the element layers between its halo-extended layers that join
    two real node layers (an element layer that spans a shard boundary
    reads the neighbour's node layer through the halo; none joins the halo
    past the mesh's ends), with ``ExtrudedOperator``'s own product and
    fixed-order accumulate.
  * V-cycle: ``ops/extruded_mg.py::ExtrudedMultigrid._vcycle`` level by
    level. The fine level and level 1 run on the shards: the block-Jacobi
    Chebyshev smoothing (each shard its layers, the special layers of
    ``_ELevel.special_idx`` mapped to the shard's local indices), and the z
    restriction and prolongation through the +-1 layer halo, so Ll is
    ceil(L / n) rounded up to 2^s for s sharded levels. The defect of the
    first level past them is gathered onto the first device, where the
    remaining levels and the z-coarse Thomas solve run as in the unsharded
    preconditioner (sequential along z: the reference replicates it too).
  * Composition: the section-RBM coarse correction runs on the first
    device on the gathered residual; the residual between it and the
    V-cycle is taken on the shards with the f64 operator, as the unsharded
    ``ComposedExtrudedPrecond`` takes it.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import torch

from ..ops.extruded import ExtrudedOperator
from ..ops.extruded_mg import ComposedExtrudedPrecond, ExtrudedMultigrid, SectionCoarse, _ELevel
from .halo import (SHARDED_LEVELS, Shards, SlabVectors, _device, _gather, _halo_exchange,
                   _prolong_z_interleave, _restrict_z_shard, _scatter, shard_geometry, to_device)

__all__ = ["ShardedComposedPrecond", "ShardedExtrudedMultigrid", "ShardedExtrudedOperator", "shard_extruded"]

def _slab_apply_raw(op: ExtrudedOperator, e: torch.Tensor, z0: int, n_layers: int) -> torch.Tensor:
    """K @ u on the node layers z0 .. z0 + Ll - 1 of a mesh of
    ``n_layers`` node layers, from the halo-extended slab e (Ll + 2, n2, 3):
    the element layers k between e[k] and e[k + 1] that join two real node
    layers, accumulated in ``ExtrudedOperator``'s order."""
    Ll = e.shape[0] - 2
    lo, hi = max(0, 1 - z0), min(Ll + 1, n_layers - z0)
    out = e.new_zeros(e.shape)
    if hi > lo:
        out[lo : hi + 1] = op._accumulate(op._element_forces(e[lo : hi + 1]))
    return out[1:-1]


@dataclasses.dataclass(frozen=True)
class ShardedExtrudedOperator(SlabVectors):
    """An extruded operator over layer slabs: ``apply``, ``apply_raw`` and
    ``rhs`` of :class:`~fea_tpu_torch.ops.extruded.ExtrudedOperator` on
    :class:`~fea_tpu_torch.parallel.halo.Shards` of (Ll, n2, 3)."""

    ops: list[ExtrudedOperator]  # the section Ke and incidence on each shard's device
    free: Shards  # (Ll, n2, 3)
    z_real: int  # node layers
    z_local: int

    def apply_raw(self, xs: Shards) -> Shards:
        return Shards(_slab_apply_raw(o, e, i * self.z_local, self.z_real)
                      for i, (o, e) in enumerate(zip(self.ops, _halo_exchange(xs))))

    def apply(self, xs: Shards) -> Shards:
        """The masked operator F K(F x) + (1 - F) x, in the dtype of ``xs``."""
        F = self.free.to(xs.dtype)
        return F * self.apply_raw(F * xs) + (1.0 - F) * xs


def _shard_operator(op: ExtrudedOperator, devices: list[torch.device], ll: int) -> ShardedExtrudedOperator:
    free = _scatter(op.free.reshape(op.n_layers, op.n2, 3), devices, ll)
    payload = {d: to_device(dataclasses.replace(op, free=op.free[:0]), d) for d in set(devices)}
    ops = [dataclasses.replace(payload[d], free=f.reshape(-1, 3), n_layers=ll) for d, f in zip(devices, free)]
    return ShardedExtrudedOperator(ops=ops, free=free, z_real=op.n_layers, z_local=ll)


@dataclasses.dataclass(frozen=True)
class _ShardLevel:
    """One z-level of the extruded hierarchy over layer slabs."""

    op: ShardedExtrudedOperator  # the level operator (f32)
    minv_interior: list[torch.Tensor]  # (b, b) on each shard's device
    special: list[Optional[torch.Tensor]]  # each shard's special layers, local int64 indices
    minv_special: list[Optional[torch.Tensor]]  # (k, b, b) their inverses
    real: list[int]  # each shard's real layers: those past them are padding
    lam_max: float

    def apply(self, g: Shards) -> Shards:
        return self.op.apply(g)

    def block_jacobi(self, r: Shards) -> Shards:
        """``_ELevel.block_jacobi`` on each shard; a padding layer is an
        identity block."""
        out = Shards()
        for x, minv, sp, msp, real in zip(r, self.minv_interior, self.special, self.minv_special, self.real):
            Ll = x.shape[0]
            rf = x.reshape(Ll, -1)
            z = rf @ minv.to(x.dtype).T
            if sp is not None:
                z.index_copy_(0, sp, torch.bmm(msp.to(x.dtype), rf[sp].unsqueeze(-1)).squeeze(-1))
            if real < Ll:
                z[real:] = rf[real:]
            out.append(z.reshape(x.shape))
        return out


def _shard_level(lv: _ELevel, devices: list[torch.device], ll: int) -> _ShardLevel:
    op = _shard_operator(lv.op, devices, ll)
    L = lv.op.n_layers
    minv = {d: lv.minv_interior.to(d) for d in set(devices)}
    special, minv_special, real = [], [], []
    for i, dev in enumerate(devices):
        z0 = i * ll
        mine = [(k, s - z0) for k, s in enumerate(lv.special_idx) if z0 <= s < z0 + ll]
        if mine:
            special.append(torch.as_tensor([j for _, j in mine], dtype=torch.int64, device=dev))
            minv_special.append(lv.minv_special[[k for k, _ in mine]].to(dev))
        else:
            special.append(None)
            minv_special.append(None)
        real.append(min(max(L - z0, 0), ll))
    return _ShardLevel(op=op, minv_interior=[minv[d] for d in devices], special=special,
                       minv_special=minv_special, real=real, lam_max=lv.lam_max)


@dataclasses.dataclass(frozen=True)
class ShardedExtrudedMultigrid:
    """The V-cycle of an :class:`~fea_tpu_torch.ops.extruded_mg.ExtrudedMultigrid`
    with its first ``len(levels)`` levels on layer slabs and the rest
    (``rest``: the remaining levels and the Thomas solve) on the first
    device. Callable on residual Shards of the fine level (f32)."""

    levels: tuple[_ShardLevel, ...]
    rest: ExtrudedMultigrid
    top: ShardedExtrudedOperator  # the fine geometry
    free: Shards  # the fine level's free mask
    degree: int
    lam_min_frac: float

    _smooth = ExtrudedMultigrid._smooth

    def _replicated(self, rc: Shards) -> Shards:
        """The levels past the sharded ones on the first device: each shard
        takes back its layers of the masked correction and the layer above."""
        rest = self.rest
        Fc = rest.levels[0].op.free if rest.levels else rest.coarse_free
        Lc = rest.levels[0].op.n_layers if rest.levels else rest.coarse_free.shape[0]
        full = _gather(rc, Lc)
        Fc = Fc.to(full.dtype).reshape(full.shape)
        zc = Fc * rest._vcycle(0, Fc * full)
        ll = rc[0].shape[0]
        zc = torch.cat([zc, zc.new_zeros((len(rc) * ll + 1 - Lc,) + tuple(zc.shape[1:]))])
        return Shards(zc[i * ll : (i + 1) * ll + 1].to(x.device, non_blocking=True) for i, x in enumerate(rc))

    def _cycle(self, idx: int, r: Shards) -> Shards:
        """``ExtrudedMultigrid._vcycle`` at sharded level ``idx``."""
        level = self.levels[idx]
        z = self._smooth(level, torch.zeros_like(r), r)
        rc = _restrict_z_shard(r - level.apply(z), ())
        if idx + 1 < len(self.levels):
            Fc = self.levels[idx + 1].op.free.to(rc.dtype)
            zc = self._cycle(idx + 1, Fc * rc)
            zc = Shards(e[1:] for e in _halo_exchange(Fc * zc))
        else:
            zc = self._replicated(rc)
        Ff = level.op.free.to(r.dtype)
        z = z + Ff * Shards(_prolong_z_interleave(c) for c in zc)
        return self._smooth(level, z, r)

    def __call__(self, r: Shards) -> Shards:
        if self.levels:
            return self._cycle(0, r)
        # no level to shard: the mesh is at Thomas size
        return self.top.scatter(self.rest(self.top.gather(r)))


@dataclasses.dataclass(frozen=True)
class ShardedComposedPrecond:
    """:class:`~fea_tpu_torch.ops.extruded_mg.ComposedExtrudedPrecond` on
    layer slabs: the section-RBM correction on the first device (on the
    gathered residual), the residual update with ``op`` on the shards, then
    the sharded V-cycle; masked by the free mask."""

    mg: ShardedExtrudedMultigrid
    sc: SectionCoarse  # on the first device
    op: ShardedExtrudedOperator  # the operator of the residual update

    def __call__(self, r: Shards) -> Shards:
        z = self.op.scatter(self.sc(self.op.gather(r)))
        F = self.mg.free.to(r.dtype)
        dt = self.op.dtype
        rm = (r.to(dt) - self.op.apply(z.to(dt))).to(r.dtype)
        return F * (z + self.mg(rm))


def shard_extruded(op: ExtrudedOperator, mg, devices: Sequence) -> tuple[ShardedExtrudedOperator, object, Callable]:
    """Layer-slab decomposition of the extruded pipeline over ``devices``
    (torch devices or their names; entries may repeat): ``(op_sharded,
    mg_sharded, constrain)`` for ``op`` (the f64 operator) and ``mg`` (an
    :class:`~fea_tpu_torch.ops.extruded_mg.ExtrudedMultigrid`, or the
    :class:`~fea_tpu_torch.ops.extruded_mg.ComposedExtrudedPrecond` around
    one, as ``build_extruded`` gives them).

    Solve with ``solve_extruded(scene, detected, prebuilt=(op_sharded,
    mg_sharded))``, which runs the Python FCG loop on the shards and
    returns (N, 3) results, or with ``solve_operator_fpcg(op_sharded,
    constrain(loads), constrain(prescribed), mg_sharded)`` on Shards.

    Each shard keeps its layers of the masks; the per-layer data (section
    Ke, incidence, layer-block inverses) is copied to each device; the
    levels past the sharded ones, the Thomas factors and the section
    coarse space are moved to the first device."""
    devices = [_device(d) for d in devices]
    inner = mg.mg if isinstance(mg, ComposedExtrudedPrecond) else mg
    n_sh = min(SHARDED_LEVELS, len(inner.levels))
    lls = shard_geometry(op.n_layers, len(devices), [(0,)] * n_sh)  # every level halves the layers
    ll = lls[0]
    op_s = _shard_operator(op, devices, ll)
    dev0 = devices[0]
    rest = dataclasses.replace(
        inner, levels=tuple(to_device(lv, dev0) for lv in inner.levels[n_sh:]), thomas_uinv=inner.thomas_uinv.to(dev0),
        thomas_g=inner.thomas_g.to(dev0), coarse_free=inner.coarse_free.to(dev0),
    )
    mg_s = ShardedExtrudedMultigrid(
        levels=tuple(_shard_level(lv, devices, zl) for lv, zl in zip(inner.levels[:n_sh], lls)),
        rest=rest, top=op_s, free=op_s.scatter(inner.free.reshape(-1, 3)), degree=inner.degree,
        lam_min_frac=inner.lam_min_frac,
    )
    if isinstance(mg, ComposedExtrudedPrecond):
        op_c = op_s if mg.op is op else _shard_operator(mg.op, devices, ll)
        mg_s = ShardedComposedPrecond(mg=mg_s, sc=to_device(mg.sc, dev0), op=op_c)
    return op_s, mg_s, op_s.scatter
