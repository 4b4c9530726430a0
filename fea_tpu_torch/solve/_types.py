"""Solution record."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..solvers.cg import SolveStats

__all__ = ["Solution"]


@dataclasses.dataclass(frozen=True)
class Solution:
    """Solve result.

    ``reactions`` is K @ u over ALL DOFs: applied loads at free DOFs,
    support reactions at fixed ones. ``stats`` reports the true residual
    of the returned displacements. ``route`` is the route ``solve()``
    took (the method name its non-convergence message gives: e.g.
    ``"fpcg-multigrid"``, ``"cg-block"``, ``"cg"``, ``"dense"``); None
    from the lower-level solvers.
    """

    displacements: torch.Tensor  # (N, dpn)
    reactions: torch.Tensor  # (N, dpn)
    stats: SolveStats
    route: Optional[str] = None
