"""Dtype helpers and the dtype policy.

The card has native IEEE FP64, so no route needs a policy: the Krylov
recurrence and the operator of the voxel route are f64, the multigrid
preconditioner f32 (f64 on its small levels), and every dot accumulates
in f64. :class:`Policy` is kept for the callers that name one, as the
reference's ``pcg(policy=...)`` does (mixed-precision refinement: f32
compute, f64 accumulation). Counterpart of ``fea_tpu/dtypes.py``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["Policy", "default_policy", "precise_dot", "torch_dtype"]

_BY_NAME = {"float32": torch.float32, "float64": torch.float64}


def torch_dtype(dtype) -> torch.dtype:
    """A torch float dtype from a torch, NumPy or JAX dtype (or its name)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = np.dtype(dtype).name
    if name not in _BY_NAME:
        raise TypeError(f"unsupported dtype {dtype!r} (float32 or float64)")
    return _BY_NAME[name]


@dataclasses.dataclass(frozen=True)
class Policy:
    """Dtypes threaded through a solver.

    Attributes:
      compute: dtype of the vectors and the operator apply.
      accum:   dtype of inner products and scalar recurrences.
      index:   dtype of connectivity and gather plans.
    """

    compute: torch.dtype = torch.float32
    accum: torch.dtype = torch.float32
    index: torch.dtype = torch.int32


def default_policy() -> Policy:
    """f32 compute, f64 accumulation. The reference falls back to f32
    accumulation when JAX's x64 is off; a torch process always has f64,
    so there is no ``x64_enabled`` here."""
    return Policy(compute=torch.float32, accum=torch.float64)


def precise_dot(a, b, dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """<a, b> accumulated in ``dtype``, as a 0-d tensor on a's device. Two
    z-sharded vectors (``parallel.halo.Shards``) give their ``dot``: the
    per-shard partials summed in shard order."""
    if not isinstance(a, torch.Tensor):
        return a.dot(b, dtype)
    return torch.dot(a.reshape(-1).to(dtype), b.reshape(-1).to(dtype))
