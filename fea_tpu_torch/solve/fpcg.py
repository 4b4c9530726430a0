"""Operator-level solvers: f64 flexible PCG with an f32 multigrid
preconditioner (the voxel route's solver, with the true-residual
certification of ``certify`` after the solve), and mixed-precision
refinement around an f32 PCG. Counterpart of ``fea_tpu/solve/fpcg.py``."""
from __future__ import annotations

from typing import Optional

import torch

from ..config import DEFAULT_CONFIG
from ..solvers.cg import fpcg
from ..solvers.refine import pcg_refined
from ._types import Solution
from .certify import refine_true

__all__ = ["solve_operator_fpcg", "solve_operator_refined", "solve_operator_refined_host"]


def solve_operator_refined(
    op_hi,
    op_lo,
    loads: torch.Tensor,
    prescribed: torch.Tensor,
    precond_lo=None,
    *,
    config=None,
    tol: Optional[float] = None,
    max_outer: Optional[int] = None,
    inner_tol: Optional[float] = None,
    inner_iters: Optional[int] = None,
) -> Solution:
    """Mixed-precision solve: f64 true-residual refinement around the f32
    PCG (``solvers/refine.py``). ``op_hi`` is built in f64 and ``op_lo`` is
    its cast (``op_hi.astype(torch.float32)``); the inner solve is
    preconditioned by ``precond_lo`` when given, else by the Jacobi
    diagonal of ``op_lo``. ``config`` (``DEFAULT_CONFIG`` when None)
    supplies ``tol``, ``max_outer``, ``inner_tol`` and ``inner_iters``;
    explicit keywords win.

    On a structured operator the outer apply is K2 (f64) and the inner
    one K1 (f32); on a uniform element operator K7 f64 and f32, on a
    stored one K6. The stats report the outer f64 residual, which is the
    true residual of ``op_hi``, and the inner iterations in all; the
    reactions are ``op_hi.apply_raw(u)``.
    """
    cfg = config if config is not None else DEFAULT_CONFIG
    tol = cfg.tol if tol is None else tol
    max_outer = cfg.max_outer if max_outer is None else max_outer
    inner_tol = cfg.inner_tol if inner_tol is None else inner_tol
    inner_iters = cfg.inner_iters if inner_iters is None else inner_iters
    hi = op_hi.free.dtype
    loads = loads.to(hi)
    prescribed = prescribed.to(hi)
    b = op_hi.rhs(loads, prescribed)
    x0 = (1.0 - op_hi.free) * prescribed
    diag_lo = None if precond_lo is not None else op_lo.diag_masked()
    u, stats = pcg_refined(
        op_hi.apply, op_lo.apply, b, x0, precond_diag_lo=diag_lo, precond_lo=precond_lo, tol=tol,
        max_outer=max_outer, inner_tol=inner_tol, inner_iters=inner_iters, lo_dtype=op_lo.free.dtype, hi_dtype=hi,
    )
    return Solution(displacements=u, reactions=op_hi.apply_raw(u), stats=stats)


def solve_operator_refined_host(*args, **kwargs) -> Solution:
    """:func:`solve_operator_refined` under the reference's second name
    (its outer loop is on the host already; see
    ``solvers/refine.py::pcg_refined_host``)."""
    return solve_operator_refined(*args, **kwargs)


def solve_operator_fpcg(
    op_hi,
    loads: torch.Tensor,
    prescribed: torch.Tensor,
    precond_lo,
    *,
    tol: float = 1e-8,
    max_iters: int = 300,
    max_refine: int = 3,
) -> Solution:
    """Solve the masked system of ``op_hi`` (built at f64) to a TRUE
    relative residual of ``tol``.

    ``precond_lo`` maps f32 (N, 3) -> (N, 3) (the V-cycle). Each FCG
    iteration is one f64 apply (K2 on the card) and one V-cycle; the
    reactions are K @ u through K2.
    """
    hi = torch.float64
    loads = loads.to(hi)
    prescribed = prescribed.to(hi)
    b = op_hi.rhs(loads, prescribed)
    x0 = (1.0 - op_hi.free) * prescribed

    def M(r):
        return precond_lo(r.to(torch.float32)).to(hi)

    u, stats = fpcg(op_hi.apply, b, x0, precond=M, tol=tol, max_iters=max_iters)

    def correct(r, tol_pass):
        return fpcg(op_hi.apply, r, None, precond=M, tol=tol_pass, max_iters=max_iters)

    return refine_true(
        op_hi, loads, float(torch.linalg.vector_norm(b)), u, stats, correct,
        tol=tol, max_refine=max_refine,
    )
