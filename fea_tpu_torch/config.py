"""Solver configuration: the same fields and defaults as
``fea_tpu/config.py``. Entry points accept ``config=``; explicit keyword
arguments win over the config, which wins over these defaults."""
from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["SolverConfig", "DEFAULT_CONFIG"]


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Tolerances and budgets for the linear solvers.

    Attributes:
      tol:         target relative residual (the true f64 residual).
      max_iters:   iteration cap; None -> the route's default.
      method:      'auto' | 'cg' | 'dense' (solve()).
      precondition: Jacobi preconditioning for plain CG.
      inner_tol:   inner f32 solve tolerance per refinement outer step.
      inner_iters: inner CG iteration cap per outer step.
      max_outer:   refinement outer-step cap.
      mg_degree:   Chebyshev smoother degree for multigrid.
      on_nonconverged: 'warn' | 'raise' | 'ignore' (host-facing solves).
      debug_nans:  run the solve under the NaN sanitizer
                   (fea_tpu_torch/sanitize.py): the first operation that
                   makes a NaN raises FloatingPointError (debugging only;
                   it syncs with the device after every operation).
      sharded:     the z-sharded solve of a voxel box over the visible
                   devices (fea_tpu_torch/parallel/halo.py). None or
                   False -> one device; True -> sharded when more than
                   one device is visible, the box has >= 16 z node planes
                   and a >= 2-level hierarchy, else one device.
    """

    tol: float = 1e-8
    max_iters: Optional[int] = None
    method: str = "auto"
    precondition: bool = True
    inner_tol: float = 1e-3
    inner_iters: int = 2000
    max_outer: int = 25
    mg_degree: int = 4
    on_nonconverged: str = "warn"
    debug_nans: bool = False
    sharded: Optional[bool] = None


DEFAULT_CONFIG = SolverConfig()
