"""True-residual certification with iterative refinement.

The f64 recurrence of FCG drifts from the true residual by about
eps * kappa, so a solve is judged by the residual recomputed from its
displacements, never by the recurrence. Counterpart of the contract of
``fea_tpu/solve/certify.py::_refine_true``: recompute ``F * (loads - K u)``
in f64 (through K2 on the card), report it, and while it misses ``tol``
run up to ``max_refine`` correction solves ``u += solve(A d = r)``.
A certification is one ``fea.certify`` span, each correction pass a
``fea.certify.pass`` span inside it and one count of ``certify.passes``.
A converged pass that leaves the true residual no lower counts
``certify.stalled``, and a case handed back above ``tol`` counts
``certify.uncertified``.
"""
from __future__ import annotations

import math
from typing import Callable

import torch

from ..solvers.cg import SolveStats
from ..utils.profiling import count, span
from ._types import Solution

__all__ = ["true_residual", "refine_true"]


def true_residual(op_hi, loads: torch.Tensor, u: torch.Tensor):
    """(K u over all DOFs, masked residual F * (loads - K u), its norm)."""
    Au = op_hi.apply_raw(u)
    r = op_hi.free * (loads - Au)
    return Au, r, float(torch.linalg.vector_norm(r))


@span("fea.certify")
def refine_true(
    op_hi,
    loads: torch.Tensor,
    b_norm: float,
    u: torch.Tensor,
    stats: SolveStats,
    correct: Callable[[torch.Tensor, float], tuple[torch.Tensor, SolveStats]],
    *,
    tol: float,
    max_refine: int = 3,
) -> Solution:
    """Certify ``u`` (an FCG result whose fixed rows hold the prescribed
    values) against the true f64 residual, correcting while it misses
    ``tol``. ``u`` is the certification's own: each pass adds its
    correction into it in place.

    ``correct(r, tol_pass)`` solves A d = r to the relative tolerance
    ``tol_pass``. A correction that does not converge ends the
    refinement; so does a first solve that did not converge (refinement
    addresses the accuracy floor, not non-convergence). The returned
    stats count every iteration and report the true residual.
    """
    safe_b_norm = b_norm if b_norm > 0 else 1.0
    iters = stats.iterations
    Au, r, rn = true_residual(op_hi, loads, u)
    ok = stats.converged
    passes = 0
    while ok and rn > tol * safe_b_norm and passes < max_refine and math.isfinite(rn):
        # the correction only needs ||r - A d|| <= tol * ||b||, a relative
        # reduction of tol * ||b|| / ||r|| on its own rhs: asked for with a
        # margin of 0.3, and of at least a tenth, as the reference's
        # curvilinear certification clips it (``fea_tpu/solve/curv.py``)
        tol_pass = min(0.1, max(0.3 * tol * safe_b_norm / rn, tol))
        count("certify.passes")
        with span("fea.certify.pass"):
            d, st = correct(r, tol_pass)
            iters += st.iterations
            if not st.converged:
                break
            # in place, and the last residual and reactions gone before the
            # next come: a pass holds no more device memory than the first
            # check did, so a window's peak does not hang on its passes
            del Au, r
            u.add_(d)
            del d
            before = rn
            Au, r, rn = true_residual(op_hi, loads, u)
            if not rn < before:
                count("certify.stalled")
        passes += 1
    converged = bool(rn <= tol * safe_b_norm)
    if not converged:
        count("certify.uncertified")
    return Solution(
        displacements=u,
        reactions=Au,
        stats=SolveStats(
            iterations=iters,
            residual_norm=rn,
            relative_residual=rn / safe_b_norm,
            converged=converged,
        ),
    )
