"""Mixed-precision iterative refinement around the f32 PCG.

Counterpart of ``fea_tpu/solvers/refine.py``. On a slender, finely meshed
cantilever the attainable true residual of an all-f32 CG is ~eps_f32 *
kappa; refinement wraps the f32 solve in an f64 correction loop:

    repeat (outer, f64):   r  = b - A_hi x          # true residual
           (inner, f32):   d ~= A_lo^-1 r           # Jacobi PCG, loose tol
           (outer, f64):   x += alpha d             # line-searched step

Each outer step costs one f64 apply, w = A_hi d, which gives both the
step length alpha = <r, w> / <w, w> and the residual update r -= alpha w.
The line search is the guard against a broken inner solve:
||r - alpha w||^2 = ||r||^2 - <r, w>^2 / <w, w> <= ||r||^2, so the outer
residual never grows, an inner solve that returns garbage gives alpha ~ 0,
and the stall test (||r_new|| >= 0.99 ||r||) ends the loop with
converged False. Non-finite entries of d are set to 0 before the apply,
and alpha is 0 unless <w, w> is finite and positive.

It converges to f64 residuals only while kappa(A) eps_f32 < 1: the
reference measured a true-residual reduction of ~0.18 an outer step at
140k DOF and a stall near 1e-5 at 1M DOF. The large grid routes of
``solve()`` take flexible PCG with an f32 V-cycle instead
(``solvers/cg.py::fpcg``); refinement is the cheap path at small and mid
sizes.

The outer loop runs on the host (one readback of ||r|| an outer step),
the inner solve is :func:`~fea_tpu_torch.solvers.cg.pcg` under
``Policy(compute=lo, accum=hi)``: its vectors in f32, its dots in f64.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from ..dtypes import Policy, precise_dot
from .cg import SolveStats, pcg

__all__ = ["pcg_refined", "pcg_refined_host"]


def pcg_refined(
    apply_hi: Callable[[torch.Tensor], torch.Tensor],
    apply_lo: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    *,
    precond_diag_lo: Optional[torch.Tensor] = None,
    precond_lo: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    tol: float = 1e-8,
    max_outer: int = 25,
    inner_tol: float = 1e-3,
    inner_iters: int = 4000,
    lo_dtype: torch.dtype = torch.float32,
    hi_dtype: torch.dtype = torch.float64,
) -> tuple[torch.Tensor, SolveStats]:
    """Solve A x = b to ``tol`` relative residual measured in ``hi_dtype``.

    ``apply_hi`` and ``apply_lo`` are the same SPD operator in high and low
    precision; ``precond_lo`` (it wins) or ``precond_diag_lo`` (Jacobi)
    preconditions the inner solve. Returns (x in ``hi_dtype``,
    SolveStats): ``iterations`` is the sum of the inner iterations,
    ``relative_residual`` the outer residual in ``hi_dtype``.
    """
    hi, lo = hi_dtype, lo_dtype
    policy = Policy(compute=lo, accum=hi)
    b = b.to(hi)
    x = torch.zeros_like(b) if x0 is None else x0.to(hi)
    b_norm = math.sqrt(float(precise_dot(b, b, hi)))
    safe_b = b_norm if b_norm > 0 else 1.0

    r = b - apply_hi(x)
    rnorm = math.sqrt(float(precise_dot(r, r, hi)))
    inner_total = 0
    for _ in range(max_outer):
        if rnorm <= tol * safe_b:
            break
        d, stats = pcg(apply_lo, r.to(lo), precond_diag=precond_diag_lo, precond=precond_lo, tol=inner_tol,
                       max_iters=inner_iters, policy=policy)
        inner_total += stats.iterations
        # a broken inner solve may hand back NaN or inf entries
        d = d.to(hi)
        d = torch.where(torch.isfinite(d), d, torch.zeros_like(d))
        w = apply_hi(d)
        rw = precise_dot(r, w, hi)
        ww = precise_dot(w, w, hi)
        good = torch.isfinite(ww) & (ww > 0)
        alpha = torch.where(good, rw / torch.where(good, ww, torch.ones_like(ww)), torch.zeros_like(ww))
        x = x + alpha * d
        r = r - alpha * w
        rnorm_prev, rnorm = rnorm, math.sqrt(float(precise_dot(r, r, hi)))
        # a healthy outer step shrinks ||r|| by ~inner_tol; anything over
        # 0.99x is a stall (the inner solve broken, or the f64 floor reached)
        if rnorm >= 0.99 * rnorm_prev:
            break

    stats = SolveStats(
        iterations=inner_total,
        residual_norm=rnorm,
        relative_residual=rnorm / safe_b,
        converged=rnorm <= tol * safe_b,
    )
    return x, stats


def pcg_refined_host(*args, **kwargs) -> tuple[torch.Tensor, SolveStats]:
    """:func:`pcg_refined` under the reference's second name. The JAX
    package splits its outer loop onto the host to keep each XLA program
    small (``fea_tpu/solvers/refine.py::pcg_refined_host``); torch runs
    eagerly, so the two are one function."""
    return pcg_refined(*args, **kwargs)
