"""Curvilinear route: meshes whose connectivity is the box grid and whose
node positions are free, through the variable-weight block stencil and
its Galerkin-RAP multigrid (``ops/curvilinear.py``).

f64 flexible PCG whose apply is the f64 operator (K5 on the card), with
the V-cycle as preconditioner (K4 on its f32 levels, K5 on its f64
ones), held on the card by ``solve/staged.py`` and certified against the
true f64 residual (``solve/certify.py``). Operator and hierarchy are
built once per mesh (``solve/cache.py``), as in the reference.
K5 is IEEE f64, so the device residual is a true residual and no host
certification tier is needed. Counterpart of ``fea_tpu/solve/curv.py``
without its TPU pipeline.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.curvilinear import build_curv_multigrid, build_curv_operator, infer_topo_dims
from ..scene import Scene
from . import staged
from ._types import Solution
from .cache import _cached_build

__all__ = ["build_curvilinear", "solve_curvilinear"]


def build_curvilinear(scene: Scene, detected=None, *, degree: int = 2, check_jacobians: bool = True):
    """One-time set-up for :func:`solve_curvilinear`: ``(op, mg)``, the
    f64 operator (weights assembled on the scene's device) and the
    V-cycle over it. Callers solving many load cases on one mesh build
    once and pass the pair as ``prebuilt``."""
    detected = detected if detected is not None else infer_topo_dims(scene)
    if detected is None:
        raise ValueError(
            "scene connectivity is not a topological box grid; build it "
            "with fea_tpu_torch.mesh.box_hex_mesh ordering (arbitrary node "
            "positions are fine: only the connectivity must be the grid)"
        )
    op = build_curv_operator(scene, detected, dtype=torch.float64, check_jacobians=check_jacobians)
    free_np = 1.0 - scene.fixed.cpu().numpy().astype(np.float64)
    mg = build_curv_multigrid(op.w, detected, free_np, degree=degree)
    return op, mg


def _cached_curvilinear(scene: Scene, detected=None, *, degree: int = 2, check_jacobians: bool = True):
    """:func:`build_curvilinear`'s ``(op, mg)`` for ``scene``'s mesh through
    the build cache: ``solve()`` and ``solve_many`` on one mesh build once."""
    return _cached_build(
        # check_jacobians is part of the key: a build that skipped the
        # check must not serve a caller who asked for it
        ("curvilinear", degree, bool(check_jacobians)), scene,
        lambda: build_curvilinear(scene, detected, degree=degree, check_jacobians=check_jacobians),
    )


def solve_curvilinear(
    scene: Scene,
    detected=None,
    *,
    tol: float = 1e-8,
    max_iters: int = 300,
    degree: int = 2,
    prebuilt=None,
    check_jacobians: bool = True,
) -> Solution:
    """Solve a topologically structured scene (grid connectivity, any
    node positions) to a true relative residual of ``tol``. Without
    ``prebuilt`` the build is cached on the scene's mesh."""
    op, mg = (
        prebuilt if prebuilt is not None
        else _cached_curvilinear(scene, detected, degree=degree, check_jacobians=check_jacobians)
    )
    return staged.solve_operator_fpcg_staged(
        op, scene.loads, scene.prescribed_or_zero(torch.float64), mg, tol=tol, max_iters=max_iters
    )
