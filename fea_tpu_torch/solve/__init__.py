"""Top-level solve API.

    solution = fea_tpu_torch.solve(scene)
    solution.displacements   # (N, 3), prescribed values on fixed DOFs
    solution.reactions       # (N, 3) = K @ u over ALL DOFs
    solution.stats           # iterations / true residual / convergence

Counterpart of ``fea_tpu/solve/__init__.py::solve``. A hex8 scene of
``_STRUCTURED_MIN_DOF`` DOFs or more is routed in the reference's order:

  1. a regular voxel box: the structured stencil operator (K1/K2);
  2. an extruded mesh: not ported yet, raises (item 12);
  3. box-grid connectivity with free node positions: the curvilinear
     route (``solve/curv.py``, K4/K5);
  4. a box grid under node renumbering: canonicalized, solved through
     this function, and permuted back;
  5. anything else raises (items 11 and 13).

Each route runs f64 flexible PCG with a multigrid V-cycle, certified
against the true f64 residual. Every route not ported raises
``NotImplementedError`` naming the route and the ROADMAP item that ports
it; no scene silently takes another path.
"""
from __future__ import annotations

import warnings
from typing import Optional

import numpy as np
import torch

from ..config import DEFAULT_CONFIG, SolverConfig
from ..scene import Scene
from ._types import Solution
from .curv import build_curvilinear, solve_curvilinear
from .fpcg import solve_operator_fpcg

__all__ = ["Solution", "build_curvilinear", "solve", "solve_curvilinear", "solve_operator_fpcg"]

# auto-routing takes the voxel route from this size (tests lower it)
_STRUCTURED_MIN_DOF = 50_000


def _not_ported(route: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"fea_tpu_torch.solve: this scene takes the {route} route, which is "
        f"not ported yet (ROADMAP.md queue 1 item {item}); no other route "
        "is taken in its place"
    )


def solve(
    scene: Scene,
    *,
    config: Optional[SolverConfig] = None,
    method: Optional[str] = None,
    tol: Optional[float] = None,
    max_iters: Optional[int] = None,
    dtype=None,
    check_jacobians: bool = True,
    operator=None,
    on_nonconverged: Optional[str] = None,
    debug_nans: Optional[bool] = None,
    device=None,
) -> Solution:
    """Solve a linear static scene end-to-end, on ``device`` (the scene's
    device when None: the card unless the scene was built on the CPU).

    Every route builds its operator in f64 whatever ``dtype`` and the
    scene's dtype are. ``check_jacobians`` raises ValueError on a
    non-positive detJ on the curvilinear route (voxel detJ > 0).
    ``on_nonconverged`` is 'warn' (default), 'raise', or 'ignore': a
    solve that exits without reaching ``tol`` is never silent. Defaults
    come from ``config`` (itself defaulting to ``DEFAULT_CONFIG``);
    explicit keywords win.
    """
    cfg = config if config is not None else DEFAULT_CONFIG
    debug_nans = cfg.debug_nans if debug_nans is None else debug_nans
    method = cfg.method if method is None else method
    tol = cfg.tol if tol is None else tol
    max_iters = cfg.max_iters if max_iters is None else max_iters
    on_nonconverged = cfg.on_nonconverged if on_nonconverged is None else on_nonconverged
    if on_nonconverged not in ("warn", "raise", "ignore"):
        raise ValueError("on_nonconverged must be 'warn', 'raise', or 'ignore'")
    if device is not None:
        scene = scene.to(torch.device(device))

    def check(sol: Solution, method_name: str) -> Solution:
        if on_nonconverged != "ignore" and not sol.stats.converged:
            msg = (
                f"solve did not converge: {sol.stats.iterations} iterations, "
                f"relative residual {sol.stats.relative_residual:.3e} "
                f"(target {tol:g}, method {method_name!r}, {scene.n_dof} DOF)"
            )
            if on_nonconverged == "raise":
                raise RuntimeError(msg)
            warnings.warn(msg, RuntimeWarning, stacklevel=3)
        return sol

    if debug_nans:
        raise _not_ported("debug_nans sanitizer", "15")
    if method != "auto":
        raise _not_ported(f"explicit method={method!r}", "8")
    if operator is not None:
        raise _not_ported("prebuilt-operator", "8")
    if cfg.sharded:
        raise _not_ported("sharded multi-device", "14")
    if scene.n_dof < _STRUCTURED_MIN_DOF:
        if scene.n_dof < 2000:
            raise _not_ported("'dense'", "8")
        raise _not_ported("'cg' (Jacobi / block-Jacobi PCG)", "8")

    if scene.family != "hex8":
        raise _not_ported("'cg' (Jacobi / block-Jacobi PCG)", "8")

    from ..ops.multigrid import build_multigrid
    from ..ops.structured import build_structured_operator, infer_box_dims

    dims = infer_box_dims(scene)
    if dims is not None:
        op_hi = build_structured_operator(scene, dims, dtype=torch.float64)
        free_np = 1.0 - scene.fixed.cpu().numpy().astype(np.float64)
        mg = build_multigrid(op_hi.astype(torch.float32), dtype=torch.float32, free_np=free_np)
        sol = solve_operator_fpcg(
            op_hi,
            scene.loads,
            scene.prescribed_or_zero(torch.float64),
            mg,
            tol=tol,
            max_iters=max_iters if max_iters is not None else 300,
        )
        return check(sol, "fpcg-multigrid")

    from ..ops.extruded import extruded_mg_coarsenable, infer_extruded

    # a box-connectivity mesh extruded along z is also curvilinear; the
    # reference sends it to the extruded route, so it is tested first
    ext = infer_extruded(scene)
    if ext is not None and extruded_mg_coarsenable(ext[2] - 1):
        raise _not_ported("extruded", "12")

    from ..ops.curvilinear import curv_coarsenable, infer_topo_dims

    tdims = infer_topo_dims(scene)
    if tdims is not None and curv_coarsenable(tdims):
        sol = solve_curvilinear(
            scene, tdims, tol=tol,
            max_iters=max_iters if max_iters is not None else 300,
            check_jacobians=check_jacobians,
        )
        return check(sol, "fpcg-curvilinear-multigrid")
    if tdims is None:
        from ..ops.canonical import canonicalize_scene, infer_renumbered_grid

        det = infer_renumbered_grid(scene)
        if det is not None and curv_coarsenable(det[0]):
            cdims, perm = det
            # the current call's loads and prescribed values are permuted
            # in with the mesh, and the solution is permuted back
            sol_c = solve(
                canonicalize_scene(scene, cdims, perm), config=config, method=method, tol=tol,
                max_iters=max_iters, dtype=dtype, check_jacobians=check_jacobians,
                on_nonconverged="ignore",
            )
            back = torch.as_tensor(perm, device=scene.device)
            sol = Solution(
                displacements=sol_c.displacements[back],
                reactions=sol_c.reactions[back],
                stats=sol_c.stats,
            )
            return check(sol, "fpcg-canonicalized-grid")
    raise _not_ported("embedded (box-subset) or arbitrary-topology", "11 (embedded) or 13 (arbitrary)")
