"""Flexible preconditioned conjugate gradients with an f64 recurrence.

Counterpart of ``fea_tpu/solvers/cg.py::fpcg``: the loop runs in Python
on the tensors' device, with one host sync per iteration for the
convergence test.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from ..dtypes import precise_dot

__all__ = ["SolveStats", "fpcg"]


@dataclasses.dataclass(frozen=True)
class SolveStats:
    """Per-solve record."""

    iterations: int
    residual_norm: float  # ||b - A x||
    relative_residual: float  # ||b - A x|| / ||b||
    converged: bool


def fpcg(
    apply: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    *,
    precond: Callable[[torch.Tensor], torch.Tensor],
    tol: float = 1e-8,
    max_iters: int = 10_000,
) -> tuple[torch.Tensor, SolveStats]:
    """Flexible preconditioned CG: f64 Krylov recurrence, low-precision M.

    The Krylov iteration runs in the dtype of ``b`` (f64), and only the
    preconditioner drops to low precision (the f32 multigrid V-cycle).
    An f32-evaluated M is a variable preconditioner, so the update uses
    the Polak-Ribiere (flexible) beta ``<r_new - r_old, z_new> / <r_old,
    z_old>``. The reported residual is the recurrence's; callers that
    report a true residual recompute it (``solve.certify``).
    """
    dtype = b.dtype
    x = torch.zeros_like(b) if x0 is None else x0.to(dtype)

    b_norm = float(torch.sqrt(precise_dot(b, b, dtype)))
    safe_b_norm = b_norm if b_norm > 0 else 1.0

    r = b - apply(x)
    z = precond(r).to(dtype)
    p = z
    rz = precise_dot(r, z, dtype)
    rr = float(precise_dot(r, r, dtype))
    # a residual 1e12x above its start (or NaN) can only get worse
    blowup = 1e12 * max(rr, safe_b_norm * safe_b_norm)

    k = 0
    while rr**0.5 > tol * safe_b_norm and k < max_iters and rr < blowup:
        Ap = apply(p)
        pAp = precise_dot(p, Ap, dtype)
        alpha = rz / torch.where(pAp > 0, pAp, torch.ones_like(pAp))
        x = x + alpha * p
        r_old = r
        r = r - alpha * Ap
        z = precond(r).to(dtype)
        rz_new = precise_dot(r, z, dtype)
        # Polak-Ribiere / flexible beta
        beta = (rz_new - precise_dot(r_old, z, dtype)) / torch.where(
            rz != 0, rz, torch.ones_like(rz)
        )
        p = z + beta * p
        rz = rz_new
        rr = float(precise_dot(r, r, dtype))
        k += 1

    res = rr**0.5
    stats = SolveStats(
        iterations=k,
        residual_norm=res,
        relative_residual=res / safe_b_norm,
        converged=res <= tol * safe_b_norm,
    )
    return x, stats
