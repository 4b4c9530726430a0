"""Newton-Krylov solver for geometrically nonlinear problems.

Newton's linear system J(u) d = -R(u) is solved by CG whose matvec is a
forward-mode derivative of the residual (``torch.func.jvp``): the
tangent operator is never assembled. Counterpart of
``fea_tpu/solvers/newton.py``, with the outer loop in Python.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..dtypes import precise_dot
from .cg import pcg

__all__ = ["NewtonStats", "newton_krylov"]


@dataclasses.dataclass(frozen=True)
class NewtonStats:
    iterations: int  # Newton steps taken
    residual_norm: float  # ||R(u)||
    converged: bool


def newton_krylov(
    residual: Callable[[torch.Tensor], torch.Tensor],
    u0: torch.Tensor,
    *,
    tol: float = 1e-10,
    max_newton_iters: int = 50,
    max_cg_iters: int = 500,
    cg_tol: float = 1e-6,
) -> tuple[torch.Tensor, NewtonStats]:
    """Solve residual(u) = 0 by Newton's method with a matrix-free inner CG.

    ``residual`` must have a symmetric positive(-semi)definite Jacobian on
    the subspace that matters (an elastic internal-force residual near a
    stable equilibrium, with masked fixed DOFs as identity rows).
    Convergence is relative to the first residual: ||R(u)|| <= tol *
    ||R(u0)|| (a zero first residual converges at once).
    """

    def rnorm(u: torch.Tensor) -> float:
        R = residual(u)
        return float(torch.sqrt(precise_dot(R, R)))

    r0 = rnorm(u0)
    scale = r0 if r0 > 0 else 1.0
    u, k, rn = u0, 0, r0
    while rn > tol * scale and k < max_newton_iters:
        R = residual(u)
        u_k = u

        def jv(v: torch.Tensor) -> torch.Tensor:
            return torch.func.jvp(residual, (u_k,), (v,))[1]

        delta, _ = pcg(jv, -R, tol=cg_tol, max_iters=max_cg_iters)
        u = u + delta
        k += 1
        rn = rnorm(u)
    return u, NewtonStats(iterations=k, residual_norm=rn, converged=rn <= tol * scale)
