"""Krylov solvers: PCG (Jacobi, any SPD preconditioner, or none), flexible
PCG, the dense fallback, Newton-Krylov and mixed-precision refinement.
Counterpart of ``fea_tpu/solvers/``."""
from .cg import SolveStats, fpcg, pcg  # noqa: F401
from .dense import dense_solve  # noqa: F401
from .newton import newton_krylov  # noqa: F401
from .refine import pcg_refined  # noqa: F401

__all__ = ["pcg", "fpcg", "SolveStats", "dense_solve", "newton_krylov", "pcg_refined"]
