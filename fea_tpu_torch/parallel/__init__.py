"""Decompositions of a solve over a list of devices, which may repeat a
device: counterpart of ``fea_tpu/parallel/``.

  * domain decomposition by elements (``shard_operator``): element blocks
    a device, the shards' partial K u summed in shard order (the
    reference's ``psum``);
  * domain decomposition by z slabs, with a +-1 plane halo: the voxel
    operator (``shard_structured_operator``), the z-sharded voxel solve
    (``build_zsharded_solver``, :mod:`.halo`), the curvilinear pipeline
    (``shard_curvilinear``, :mod:`.curv`) and the extruded one
    (``shard_extruded``, :mod:`.extruded`);
  * batch parallelism (``sharded_sweep``): independent load cases cut
    into one block a device.

``make_device_mesh`` gives the device list.
"""
from .curv import shard_curvilinear
from .extruded import shard_extruded
from .halo import Shards, ZShardedSolver, build_zsharded_solver, shard_geometry
from .sharding import (
    ShardedOperator,
    make_device_mesh,
    replicated_precond,
    shard_operator,
    shard_structured_operator,
    sharded_sweep,
)

__all__ = [
    "ShardedOperator",
    "Shards",
    "ZShardedSolver",
    "build_zsharded_solver",
    "make_device_mesh",
    "replicated_precond",
    "shard_curvilinear",
    "shard_extruded",
    "shard_geometry",
    "shard_operator",
    "shard_structured_operator",
    "sharded_sweep",
]
