"""Many load cases on one mesh: ``solve_many``.

Counterpart of ``fea_tpu/solve/many.py::solve_many``. Operator and
hierarchy are built once; the cases advance together through the staged
FCG loop (``solve/staged.py``), one captured step per case on the card,
each case freezing on its own and the host replaying only the cases it has
not seen halt, with one readback of the whole batch's status a round.
Each case is certified against its true f64 residual on its own
(``certify.refine_true``), with its own correction tolerance. Routing
follows the reference: a voxel box, then extruded (not ported, item 12),
then curvilinear, then a box subset (not ported, item 11), else arbitrary
topology (not ported, item 13); the first three are ``solve()``'s own
detectors and builds, and a curvilinear mesh shares ``solve()``'s build
cache.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from ..scene import Scene
from ..solvers.cg import SolveStats
from ._types import Solution
from .curv import _cached_curvilinear
from .staged import _solve_cases

__all__ = ["solve_many"]


def _batch(name: str, value, scene: Scene) -> torch.Tensor:
    t = torch.as_tensor(value, dtype=torch.float64, device=scene.device)
    if t.ndim != 3 or tuple(t.shape[1:]) != (scene.n_nodes, 3):
        raise ValueError(f"{name} must be (k, {scene.n_nodes}, 3), got {tuple(t.shape)}")
    return t


def _build(scene: Scene):
    """(f64 operator, f32 V-cycle) of ``scene``'s route, built as
    ``solve()`` builds it (the curvilinear build from the same cache), or
    NotImplementedError naming the route's ROADMAP item."""
    from . import _grid_route, _not_ported, _voxel_build
    from ..ops.canonical import infer_subgrid_embedding
    from ..ops.curvilinear import curv_coarsenable

    route, dims = _grid_route(scene)
    if route == "voxel":
        return _voxel_build(scene, dims)
    if route == "curvilinear":
        return _cached_curvilinear(scene, dims)
    det = infer_subgrid_embedding(scene)
    if det is not None and not det[2].all() and curv_coarsenable(det[0]):
        raise _not_ported("solve_many embedded (box-subset)", "11")
    raise _not_ported("solve_many arbitrary-topology", "13")


def solve_many(
    scene: Scene,
    loads_batch,
    *,
    tol: float = 1e-8,
    max_iters: int = 300,
    prescribed_batch=None,
    on_nonconverged: str = "warn",
) -> Solution:
    """Solve k load cases on the mesh of ``scene``, on its device.

    ``loads_batch`` and ``prescribed_batch`` (None: zero) are (k, N, 3).
    Returns a Solution whose displacements and reactions have a leading k
    axis and whose stats fields are per-case arrays of length k.
    ``on_nonconverged`` ('warn', 'raise' or 'ignore'): a case that ends
    above ``tol`` is never silent, and the message names every such case
    and the worst residual.
    """
    if on_nonconverged not in ("warn", "raise", "ignore"):
        raise ValueError("on_nonconverged must be 'warn', 'raise', or 'ignore'")
    loads_batch = _batch("loads_batch", loads_batch, scene)
    if prescribed_batch is None:
        prescribed_batch = torch.zeros_like(loads_batch)
    else:
        prescribed_batch = _batch("prescribed_batch", prescribed_batch, scene)
        if prescribed_batch.shape != loads_batch.shape:
            raise ValueError(f"prescribed_batch must have loads_batch's shape {tuple(loads_batch.shape)}, "
                             f"got {tuple(prescribed_batch.shape)}")

    op_hi, mg = _build(scene)
    sols = _solve_cases(
        op_hi, mg, loads_batch, prescribed_batch, tol=tol, max_iters=max_iters, refine=True, max_refine=3,
        say=lambda s: None,
    )
    rel = np.array([s.stats.relative_residual for s in sols])
    conv = np.array([s.stats.converged for s in sols])
    sol = Solution(
        displacements=torch.stack([s.displacements for s in sols]),
        reactions=torch.stack([s.reactions for s in sols]),
        stats=SolveStats(
            iterations=np.array([s.stats.iterations for s in sols]),
            residual_norm=np.array([s.stats.residual_norm for s in sols]),
            relative_residual=rel,
            converged=conv,
        ),
    )
    if on_nonconverged != "ignore" and not conv.all():
        bad = np.nonzero(~conv)[0].tolist()
        msg = (
            f"solve_many: {len(bad)}/{conv.size} case(s) did not converge (indices {bad}, worst relative "
            f"residual {float(np.nanmax(rel[~conv])):.3e}, target {tol:g})"
        )
        if on_nonconverged == "raise":
            raise RuntimeError(msg)
        warnings.warn(msg, RuntimeWarning, stacklevel=2)
    return sol
