"""Dtype helpers.

The card has native IEEE FP64, so the port has no dtype policy: the
Krylov recurrence and the operator of the voxel route are f64, the
multigrid preconditioner f32 (f64 on its small levels). Counterpart of
``fea_tpu/dtypes.py``.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["torch_dtype", "precise_dot"]

_BY_NAME = {"float32": torch.float32, "float64": torch.float64}


def torch_dtype(dtype) -> torch.dtype:
    """A torch float dtype from a torch, NumPy or JAX dtype (or its name)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = np.dtype(dtype).name
    if name not in _BY_NAME:
        raise TypeError(f"unsupported dtype {dtype!r} (float32 or float64)")
    return _BY_NAME[name]


def precise_dot(a, b, dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """<a, b> accumulated in ``dtype``, as a 0-d tensor on a's device. Two
    z-sharded vectors (``parallel.halo.Shards``) give their ``dot``: the
    per-shard partials summed in shard order."""
    if not isinstance(a, torch.Tensor):
        return a.dot(b, dtype)
    return torch.dot(a.reshape(-1).to(dtype), b.reshape(-1).to(dtype))
