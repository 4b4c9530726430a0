"""Extruded route: layer-major uniform extrusions of a section (the tube
and every ``mesh.extrude_quads`` mesh), through the semi-structured
operator and the z-semicoarsened V-cycle with the section-RBM coarse
space (``ops/extruded.py``, ``ops/extruded_mg.py``).

f64 flexible PCG whose apply is the f64 extruded operator, with the f32
composed preconditioner, held on the card by ``solve/staged.py`` and
certified against the true f64 residual (``solve/certify.py``); a
layer-slab decomposition of the pair (``parallel/extruded.py``) takes the
Python loop of ``solve/fpcg.py`` instead. The build is cached on the scene's mesh (``solve/cache.py``), so ``solve()``
and ``solve_many`` on one mesh build once. Counterpart of
``fea_tpu/solve/extruded.py`` without its double-f32 pair recurrence
(``krylov="dd"``, for a chip without f64): the loop is native f64, the
reference's ``krylov="f64"``.
"""
from __future__ import annotations

import torch

from ..ops.extruded import build_extruded_operator, infer_extruded
from ..scene import Scene
from . import staged
from ._types import Solution
from .cache import _cached_build
from .fpcg import solve_operator_fpcg

__all__ = ["build_extruded", "solve_extruded"]


def build_extruded(scene: Scene, detected=None, *, degree: int = 3, section_coarse: bool = True,
                   section_aggregates: int = 64):
    """One-time set-up for :func:`solve_extruded`: ``(op, mg)``, the f64
    operator and the f32 preconditioner, on the scene's device. Callers
    solving many load cases on one mesh build once and pass the pair as
    ``prebuilt``.

    ``section_coarse`` (default) composes the z-resolved section-RBM
    coarse space of ``section_aggregates`` section aggregates
    multiplicatively with the V-cycle, the residual between them taken
    with the f64 operator; False leaves the V-cycle alone.
    Raises ValueError if the scene is not a uniform layer-major extrusion
    or its layer count does not coarsen to a block-tridiagonal direct
    solve (pick an element-layer count k * 2^m with k <= 16)."""
    from ..ops.extruded_mg import ComposedExtrudedPrecond, build_extruded_multigrid, build_section_coarse

    detected = detected if detected is not None else infer_extruded(scene)
    if detected is None:
        raise ValueError(
            "scene is not a layer-major uniform extrusion; build it with "
            "fea_tpu_torch.mesh.extrude_quads (reference stack_faces_2d ordering)"
        )
    op = build_extruded_operator(scene, detected, dtype=torch.float64)
    mg = build_extruded_multigrid(scene, detected, degree=degree)
    if section_coarse:
        sc = build_section_coarse(scene, detected, target_section_aggregates=section_aggregates)
        mg = ComposedExtrudedPrecond(mg=mg, sc=sc, op=op)
    return op, mg


def _cached_extruded(scene: Scene, detected=None, *, degree: int = 3):
    """:func:`build_extruded`'s ``(op, mg)`` for ``scene``'s mesh through
    the build cache: ``solve()`` and ``solve_many`` on one mesh build once."""
    return _cached_build(("extruded", degree), scene, lambda: build_extruded(scene, detected, degree=degree))


def solve_extruded(
    scene: Scene,
    detected=None,
    *,
    tol: float = 1e-8,
    max_iters: int = 300,
    degree: int = 3,
    prebuilt=None,
) -> Solution:
    """Solve an extruded scene to a true relative residual of ``tol``.

    ``detected`` is ``infer_extruded(scene)`` (detected again when None).
    ``prebuilt``: an ``(op, mg)`` pair from :func:`build_extruded`, or its
    layer-slab decomposition from ``parallel.shard_extruded`` (solved by
    the Python FCG loop on the shards, the results gathered to (N, 3) on
    the first shard's device); without it the build is cached on the
    scene's mesh. Fixed DOFs hold the prescribed values exactly."""
    from ..parallel.extruded import ShardedExtrudedOperator

    op, mg = prebuilt if prebuilt is not None else _cached_extruded(scene, detected, degree=degree)
    presc = scene.prescribed_or_zero(torch.float64)
    if isinstance(op, ShardedExtrudedOperator):
        sol = solve_operator_fpcg(op, op.scatter(scene.loads), op.scatter(presc), mg, tol=tol, max_iters=max_iters)
        return Solution(displacements=op.gather(sol.displacements), reactions=op.gather(sol.reactions),
                        stats=sol.stats)
    return staged.solve_operator_fpcg_staged(op, scene.loads, presc, mg, tol=tol, max_iters=max_iters)
