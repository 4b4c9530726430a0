"""Many load cases on one mesh: ``solve_many``.

Counterpart of ``fea_tpu/solve/many.py::solve_many``. Operator and
preconditioner are built once; the cases advance together through the
staged FCG loop (``solve/staged.py``), one captured step per case on the
card, each case freezing on its own and the host replaying only the cases
it has not seen halt, with one readback of the whole batch's status a
round. Each case is certified against its true f64 residual on its own
(``certify.refine_true``), with its own correction tolerance. Routing
follows the reference: a voxel box, then extruded, then curvilinear, then
a box subset (embedded: the batch scattered into the lattice and gathered
back), else arbitrary topology (the two-level preconditioner over the
element-by-element f64 operator). Every build comes from the cache
``solve()`` uses.
"""
from __future__ import annotations

import os
import warnings

import numpy as np
import torch

from ..scene import Scene
from ..solvers.cg import SolveStats
from ..utils.profiling import span
from ._types import Solution
from .cache import _cached_build
from .curv import _cached_curvilinear
from .embed import _cached_embedding, _to_lattice
from .extruded import _cached_extruded
from .staged import _solve_cases

__all__ = ["solve_many"]


def _batch(name: str, value, scene: Scene) -> torch.Tensor:
    t = torch.as_tensor(value, dtype=torch.float64, device=scene.device)
    if t.ndim != 3 or tuple(t.shape[1:]) != (scene.n_nodes, 3):
        raise ValueError(f"{name} must be (k, {scene.n_nodes}, 3), got {tuple(t.shape)}")
    return t


def _build(scene: Scene):
    """``((f64 operator, preconditioner), lat)`` of ``scene``'s route,
    built as ``solve()`` builds it (from the same cache where ``solve()``
    caches); ``lat`` is the lattice map of the embedded route, else None."""
    from . import _grid_route, _operator_f64, _two_level, _voxel_build

    route, dims = _cached_build("route", scene, lambda: _grid_route(scene))
    if route == "voxel":
        return _cached_build("voxel", scene, lambda: _voxel_build(scene, dims)), None
    if route == "extruded":
        return _cached_extruded(scene, dims), None
    if route == "curvilinear":
        return _cached_curvilinear(scene, dims), None
    if not os.environ.get("FEA_TPU_NO_EMBED"):
        built = _cached_embedding(scene)
        if built is not None:
            _, op, mg, lat = built
            return (op, mg), torch.as_tensor(lat, device=scene.device)
    op64 = _operator_f64(scene, True)
    return (op64, _two_level(scene, op64)), None


@span("fea.solve_many")
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

    (op_hi, mg), lat = _build(scene)
    if lat is not None:  # into the lattice of the embedded route, and back below
        loads_batch = _to_lattice(loads_batch, lat, op_hi.n_nodes)
        prescribed_batch = _to_lattice(prescribed_batch, lat, op_hi.n_nodes)
    sols = _solve_cases(
        op_hi, mg, loads_batch, prescribed_batch, tol=tol, max_iters=max_iters, refine=True, max_refine=3,
    )
    if lat is not None:
        sols = [Solution(displacements=s.displacements[lat], reactions=s.reactions[lat], stats=s.stats)
                for s in sols]
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
