"""Preconditioned conjugate gradients: ``pcg`` (Jacobi, any SPD
preconditioner, or none) and ``fpcg`` (flexible, an f64 recurrence around
a low-precision preconditioner).

Counterpart of ``fea_tpu/solvers/cg.py::pcg`` and ``::fpcg``: each loop
runs in Python on the tensors' device, with one host sync per iteration
for the convergence test. Dots accumulate in f64 (``pcg``: in the
accumulation dtype of its ``policy``, when one is given).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from ..dtypes import Policy, precise_dot

__all__ = ["SolveStats", "fpcg", "pcg"]


@dataclasses.dataclass(frozen=True)
class SolveStats:
    """Per-solve record."""

    iterations: int
    residual_norm: float  # ||b - A x||
    relative_residual: float  # ||b - A x|| / ||b||
    converged: bool


def pcg(
    apply: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    *,
    precond_diag: Optional[torch.Tensor] = None,
    precond: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    tol: float = 1e-8,
    max_iters: int = 10_000,
    policy: Optional[Policy] = None,
) -> tuple[torch.Tensor, SolveStats]:
    """Solve A x = b by preconditioned CG.

    ``apply`` must be SPD on the subspace it acts on (the masked stiffness
    operator is). Preconditioning: ``precond``, an SPD callable z = M^-1 r
    (it wins), else ``precond_diag``, the diagonal of A (Jacobi), else
    none. ``policy``: the vectors in ``policy.compute``, the dots and the
    scalar recurrence in ``policy.accum``; None computes in the dtype of
    ``b`` and accumulates in f64. The reported residual is the
    recurrence's; ``solve_operator`` recomputes the true one.
    """
    dtype, acc = (b.dtype, torch.float64) if policy is None else (policy.compute, policy.accum)
    b = b.to(dtype)
    x = torch.zeros_like(b) if x0 is None else x0.to(dtype)
    if precond is None and precond_diag is not None:
        # a free DOF attached to no element has a zero assembled diagonal:
        # the identity there instead of an inf
        d = precond_diag.to(dtype)
        pos = d > 0
        inv_diag = torch.where(pos, 1.0 / torch.where(pos, d, torch.ones_like(d)), torch.ones_like(d))
        precond = lambda r: inv_diag * r  # noqa: E731
    elif precond is None:
        precond = lambda r: r  # noqa: E731

    b_norm = float(torch.sqrt(precise_dot(b, b, acc)))
    safe_b_norm = b_norm if b_norm > 0 else 1.0

    r = b - apply(x)
    z = precond(r)
    p = z
    rz = precise_dot(r, z, acc)
    rr = float(precise_dot(r, r, acc))
    # a residual 1e12x above its start (or NaN) can only get worse
    blowup = 1e12 * max(rr, safe_b_norm * safe_b_norm)

    k = 0
    while rr**0.5 > tol * safe_b_norm and k < max_iters and rr < blowup:
        Ap = apply(p)
        pAp = precise_dot(p, Ap, acc)
        alpha = (rz / torch.where(pAp > 0, pAp, torch.ones_like(pAp))).to(dtype)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_new = precise_dot(r, z, acc)
        beta = (rz_new / torch.where(rz != 0, rz, torch.ones_like(rz))).to(dtype)
        p = z + beta * p
        rz = rz_new
        rr = float(precise_dot(r, r, acc))
        k += 1

    res = rr**0.5
    stats = SolveStats(
        iterations=k,
        residual_norm=res,
        relative_residual=res / safe_b_norm,
        converged=res <= tol * safe_b_norm,
    )
    return x, stats


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
