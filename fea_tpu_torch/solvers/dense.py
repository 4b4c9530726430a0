"""Dense masked solve: small systems, oracles and the CG cross-check.

The dense matrix of the masked operator A = diag(F) K diag(F) + diag(1-F)
is solved directly: the reduced system's solution on the free DOFs, the
prescribed values on the fixed ones. Counterpart of
``fea_tpu/solvers/dense.py``.
"""
from __future__ import annotations

import torch

from ..dtypes import precise_dot
from .cg import SolveStats

__all__ = ["dense_solve", "masked_dense_matrix"]


def masked_dense_matrix(K: torch.Tensor, free_flat: torch.Tensor) -> torch.Tensor:
    """A = diag(F) K diag(F) + diag(1-F) for a flat 0/1 free mask."""
    F = free_flat.to(K.dtype)
    return K * F[:, None] * F[None, :] + torch.diag(1.0 - F)


def dense_solve(K: torch.Tensor, b_flat: torch.Tensor, free_flat: torch.Tensor) -> tuple[torch.Tensor, SolveStats]:
    """Solve the masked dense system; returns (x_flat, SolveStats).

    The stats carry the true residual ||b - A x|| of the masked system
    (f64 dots). A direct solve has no tolerance, so ``converged`` is
    True, as in the reference.
    """
    A = masked_dense_matrix(K, free_flat)
    x = torch.linalg.solve(A, b_flat)
    r = b_flat - A @ x
    rnorm = float(torch.sqrt(precise_dot(r, r)))
    bnorm = float(torch.sqrt(precise_dot(b_flat, b_flat)))
    return x, SolveStats(
        iterations=1,
        residual_norm=rnorm,
        relative_residual=rnorm / (bnorm if bnorm > 0 else 1.0),
        converged=True,
    )
