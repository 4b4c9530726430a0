"""Element decomposition, sharded sweeps and the z-slab structured
operator over a list of devices.

Counterpart of ``fea_tpu/parallel/sharding.py``. The reference's device
mesh is here a list of torch devices, which may repeat a device (four
shards on one card run every line of a decomposition); there is no GSPMD:
every gather, halo and partial sum is issued from one process, in shard
order.

  * :func:`shard_operator`: the element batch cut into contiguous blocks,
    one a device, padded to a multiple of the shard count with inert
    elements; nodal vectors stay whole on the first device (the reference
    replicates them), each shard's partial K u is computed on its device
    (K7 for ``uniform``, K6 for ``stored``, the plain apply for
    ``hex8_matfree``) and the partials are summed on the first device in
    shard order, the reference's ``psum``. The scatter of a shard is
    ``index_add_``, whose order on the card is not fixed: applies agree
    with the unsharded operator to rounding, not bit for bit.
  * :func:`sharded_sweep`: independent cases cut into blocks along their
    batch axis, each block solved case by case on its device.
  * :func:`shard_structured_operator`: the voxel operator on z slabs
    (``halo.ShardedStructuredOperator``, K3 / K1's halo form), with
    :func:`replicated_precond` to run a preconditioner of the whole grid
    beside it (gather, apply, scatter).

The curvilinear and extruded decompositions are :mod:`.curv` and
:mod:`.extruded`.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Optional, Sequence

import torch

from ..operator import StiffnessOperator
from ..ops.cuda_stencil import check_free_mask
from ..ops.structured import StructuredOperator
from .halo import ShardedStructuredOperator, Shards, _device, _halo_exchange, _scatter

__all__ = [
    "ShardedOperator",
    "make_device_mesh",
    "replicated_precond",
    "shard_operator",
    "shard_structured_operator",
    "sharded_sweep",
]


def make_device_mesh(n_devices: Optional[int] = None, device=None) -> list[torch.device]:
    """``n_devices`` torch devices (default: every visible card), one a
    shard: round-robin over the visible cards from ``device``'s index, so
    one card repeats. ``device="cpu"`` gives ``n_devices`` CPU entries
    (default 1). Without a card, and unless the CPU is asked for, this
    raises: no shard goes to the CPU unasked."""
    if device is not None and torch.device(device).type != "cuda":
        return [torch.device(device)] * (n_devices or 1)
    n_cards = torch.cuda.device_count()
    if n_cards == 0:
        raise RuntimeError("make_device_mesh: no CUDA card is visible; pass device='cpu' for CPU shards")
    first = (torch.device(device).index or 0) if device is not None else 0
    n = n_devices or n_cards
    return [torch.device("cuda", (first + i) % n_cards) for i in range(n)]


# -- element decomposition ---------------------------------------------------


def _block(x: torch.Tensor, s: int, e: int, pad: int, fill: str, device) -> torch.Tensor:
    """Rows [s, e) of x and ``pad`` filler rows (copies of row 0, or
    zeros), on ``device``."""
    rows = x[s:e]
    if pad:
        shape = (pad,) + tuple(x.shape[1:])
        rows = torch.cat([rows, x[:1].expand(shape) if fill == "copy" else x.new_zeros(shape)])
    return rows.to(device).contiguous()


@dataclasses.dataclass(frozen=True)
class ShardedOperator:
    """A :class:`~fea_tpu_torch.operator.StiffnessOperator` partitioned
    element-wise over a list of devices: each shard is the operator of its
    block of elements, with no incidence plan, on its device. Nodal vectors
    are whole, on the first device.

    Drop-in for StiffnessOperator in ``solve_operator``: ``apply``,
    ``apply_raw``, ``rhs``, ``diag_raw`` and ``diag_masked``, with the
    shards' partials summed in shard order."""

    shards: tuple[StiffnessOperator, ...]
    free: torch.Tensor  # (N, dpn), on the first device

    @property
    def kind(self) -> str:
        return self.shards[0].kind

    @property
    def geom(self):
        """The first shard's geometry, whose ``min_detj`` is the whole
        mesh's (``solve``'s Jacobian check reads it)."""
        return self.shards[0].geom

    @property
    def n_dof(self) -> int:
        return self.free.numel()

    @property
    def dtype(self) -> torch.dtype:
        return self.free.dtype

    def _sum(self, parts) -> torch.Tensor:
        """The shards' partials summed in shard order on the first device."""
        total = parts[0].to(self.free.device)
        for p in parts[1:]:
            total = total + p.to(total.device)
        return total

    def apply_raw(self, u: torch.Tensor) -> torch.Tensor:
        """K @ u over all DOFs: each shard's partial on its device (u is
        copied once to each device), summed on the first."""
        on = {}
        return self._sum([
            s.apply_raw(on.setdefault(s.free.device, u.to(s.free.device))) for s in self.shards
        ])

    def diag_raw(self) -> torch.Tensor:
        return self._sum([s.diag_raw() for s in self.shards])

    apply = StiffnessOperator.apply
    rhs = StiffnessOperator.rhs
    diag_masked = StiffnessOperator.diag_masked


def shard_operator(op: StiffnessOperator, devices: Sequence) -> ShardedOperator:
    """``op``'s elements cut into ``len(devices)`` contiguous blocks of
    equal size, each placed on its device; the batch is padded at its end
    with inert elements, as the reference's ``_pad_operator``: copies of
    element 0 whose force is 0 (``valid`` 0 for ``uniform``, zero Ke rows
    for ``stored``, zero quadrature weights for ``hex8_matfree``). The
    incidence plan is dropped: each shard scatters directly."""
    devices = [_device(d) for d in devices]
    n = len(devices)
    E = op.elements.shape[0]
    per = -(-E // n)
    frees = {d: op.free.to(d) for d in devices}
    kes = {d: op.ke.to(d) for d in devices} if op.kind == "uniform" else None
    shards = []
    for i, dev in enumerate(devices):
        s, e = min(i * per, E), min((i + 1) * per, E)
        pad = per - (e - s)
        kw = dict(elements=_block(op.elements, s, e, pad, "copy", dev), free=frees[dev], plan=None, valid=None)
        if op.kind == "hex8_matfree":
            kw["geom"] = dataclasses.replace(
                op.geom, grads=_block(op.geom.grads, s, e, pad, "copy", dev),
                wdetj=_block(op.geom.wdetj, s, e, pad, "zero", dev), min_detj=op.geom.min_detj.to(dev),
            )
        elif op.kind == "stored":
            kw["ke"] = _block(op.ke, s, e, pad, "zero", dev)
        else:
            kw["ke"] = kes[dev]
            if pad:
                kw["valid"] = torch.cat([op.free.new_ones(e - s), op.free.new_zeros(pad)]).to(dev)
        shards.append(dataclasses.replace(op, **kw))
    return ShardedOperator(shards=tuple(shards), free=frees[devices[0]])


# -- sweeps ----------------------------------------------------------------------


def _map(fn, tree):
    """``fn`` on every tensor of a tensor, tuple, list or dict of them."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, v) for v in tree)
    raise TypeError(f"sharded_sweep: expected tensors (or tuples, lists, dicts of them), got {type(tree).__name__}")


def _stack(outs: list, device: torch.device):
    """Per-case results (tensors, or equal tuples, lists, dicts of them)
    stacked along a new leading axis on ``device``."""
    first = outs[0]
    if isinstance(first, torch.Tensor):
        return torch.stack([o.to(device) for o in outs])
    if isinstance(first, dict):
        return {k: _stack([o[k] for o in outs], device) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_stack([o[j] for o in outs], device) for j in range(len(first)))
    raise TypeError(f"sharded_sweep: solve_fn returned {type(first).__name__}, not tensors")


def sharded_sweep(solve_fn: Callable, batch_args, devices: Sequence):
    """Data-parallel sweep, the FEA analog of data parallelism: the cases
    of ``batch_args`` (a tensor, or a tuple, list or dict of tensors, with
    a leading batch axis that the number of devices must divide) cut into
    one block a device, each case solved by ``solve_fn`` on its block's
    device (its arguments moved there, that device current), and the
    results stacked on the first device in case order.

    A solve is a data-dependent loop, so a block runs case by case (there
    is no ``vmap`` across it). ``solve_fn`` must take its case's arguments
    on its block's device: what it closes over must be usable from there
    (one card, or the CPU)."""
    devices = [_device(d) for d in devices]
    n = len(devices)
    leaves = []
    _map(leaves.append, batch_args)
    B = leaves[0].shape[0]
    if any(x.shape[0] != B for x in leaves) or B % n:
        raise ValueError(
            f"sharded_sweep: every argument needs the same leading batch size, divisible by the "
            f"{n} devices; got {[tuple(x.shape) for x in leaves]}"
        )
    per = B // n
    outs = []
    for i, dev in enumerate(devices):
        with torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext():
            for j in range(i * per, (i + 1) * per):
                outs.append(solve_fn(_map(lambda x: x[j].to(dev), batch_args)))
    return _stack(outs, devices[0])


# -- the z-slab structured operator ----------------------------------------------


def shard_structured_operator(op: StructuredOperator, devices: Sequence):
    """Z-slab decomposition of the voxel stencil operator: ``(op_sharded,
    constrain)``.

    ``op_sharded`` is a :class:`~fea_tpu_torch.parallel.halo.ShardedStructuredOperator`:
    shard i holds node planes [i Zl, (i + 1) Zl) with Zl = ceil(Z / n)
    (padding planes past the grid are fixed), its Ke on its device, and
    each apply exchanges one plane with each neighbour and runs the slab
    kernel (K3 in f64, K1's halo form in f32). Its vectors are
    :class:`~fea_tpu_torch.parallel.halo.Shards`; ``constrain`` maps the
    scene's (N, 3) vectors onto them (``op_sharded.scatter``), and
    ``op_sharded.gather`` maps shards back. ``solve_operator`` and
    ``solve_operator_fpcg`` run on it; a preconditioner of the whole grid
    (the V-cycle of ``build_multigrid``) goes through
    :func:`replicated_precond`."""
    devices = [_device(d) for d in devices]
    Z, Y, X = op.grid_shape
    zl = -(-Z // len(devices))
    free = _scatter(check_free_mask(op.free).reshape(Z, Y, X, 3), devices, zl)
    per = {d: op.weights.to(d) for d in set(devices)}
    op_s = ShardedStructuredOperator(
        weights=[per[d] for d in devices], free=free, free_ext=_halo_exchange(free), z_real=Z, z_local=zl,
    )
    return op_s, op_s.scatter


def replicated_precond(op_sharded, precond: Callable[[torch.Tensor], torch.Tensor]) -> Callable[[Shards], Shards]:
    """``precond``, a preconditioner of the whole grid's (N, 3) residuals
    on the first shard's device (an unsharded V-cycle), as one of
    ``op_sharded``'s shards: gather the residual, apply, scatter the
    correction. The reference's GSPMD replicates such a preconditioner
    beside a sharded operator; here the gather and scatter are explicit."""

    def apply(rs: Shards) -> Shards:
        return op_sharded.scatter(precond(op_sharded.gather(rs)))

    return apply
