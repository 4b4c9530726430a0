"""Decompositions of a solve over several devices: the z-sharded voxel
solve (:mod:`fea_tpu_torch.parallel.halo`). Counterpart of
``fea_tpu/parallel/``."""
from .halo import ZShardedSolver, build_zsharded_solver, shard_geometry

__all__ = ["ZShardedSolver", "build_zsharded_solver", "shard_geometry"]
