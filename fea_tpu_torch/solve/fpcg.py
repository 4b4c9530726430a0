"""f64 flexible PCG with an f32 multigrid preconditioner on the structured
operator: the voxel route's solver. Counterpart of
``fea_tpu/solve/fpcg.py::solve_operator_fpcg``, with the true-residual
certification of ``certify`` after the solve."""
from __future__ import annotations

import torch

from ..solvers.cg import fpcg
from ._types import Solution
from .certify import refine_true

__all__ = ["solve_operator_fpcg"]


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
