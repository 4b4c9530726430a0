"""Top-level solve API.

    solution = fea_tpu_torch.solve(scene)
    solution.displacements   # (N, dpn), prescribed values on fixed DOFs
    solution.reactions       # (N, dpn) = K @ u over ALL DOFs
    solution.stats           # iterations / true residual / convergence

Counterpart of ``fea_tpu/solve/__init__.py::solve``. Routes, in the
reference's order:

  1. an explicit ``method="cg"`` or ``"dense"``, or a prebuilt
     ``operator=``: the element-by-element operator (``operator.py``,
     K6/K7) through :func:`solve_operator`, whatever the size;
  2. a hex8 scene of ``_STRUCTURED_MIN_DOF`` DOFs or more (or any hex8
     scene under ``SolverConfig(sharded=True)``), auto-routed (the
     verdict kept per mesh in ``solve/cache.py``):
     a. a regular voxel box: the structured stencil operator (K1/K2) on
        one device, built once per mesh, or, when ``sharded=True`` asks
        for it and more than one device is visible, its z-sharded solve
        over them (``parallel/halo.py``, K1's halo form and K3), built
        anew every call;
     b. an extruded mesh (a section extruded along z with uniform
        spacing): the semi-structured operator and the z-semicoarsened
        line-smoothed V-cycle with the section-RBM coarse space
        (``solve/extruded.py``), on one device also under
        ``sharded=True``;
     c. box-grid connectivity with free node positions: the curvilinear
        route (``solve/curv.py``, K4/K5);
     d. a box grid under node renumbering: canonicalized, solved through
        this function, and permuted back;
     e. anything else goes on to 3;
  3. any other hex8 scene of 2,000 DOF and ``_BLOCK_PRECOND_MIN_DOF`` or
     more (8 nodes an element), auto-routed, in this order:
     a. its cells a proper subset of a box grid's (an L, a step, a hole):
        embedded in the box, void cells at zero weight and void DOFs
        fixed, and solved by the curvilinear route (``solve/embed.py``,
        K4/K5); ``FEA_TPU_NO_EMBED`` set opts out;
     b. the stiffness assembled into block-CSR with a smoothed-aggregation
        V-cycle (``ops/amg.py``, ``solve/unstructured.py``);
        ``FEA_TPU_NO_AMG`` set opts out, and a failed build warns and
        goes on to c;
     c. the element-by-element f64 operator with the Chebyshev two-level
        preconditioner (``ops/twolevel.py``); a failed build warns and
        takes block-Jacobi CG;
  4. any other scene, auto-routed: ``dense`` below 2,000 DOF, Jacobi PCG
     over the element-by-element operator above (beams and bars at any
     size).

The large routes run f64 flexible PCG with a multigrid or two-level
preconditioner, its loop held on the card as replays of a captured
iteration (``solve/staged.py``; the z-sharded solve keeps the Python loop
of ``solve_operator_fpcg``); every route reports the true residual of the
displacements it returns. ``debug_nans`` runs the whole solve under the
NaN sanitizer (``fea_tpu_torch/sanitize.py``): the first operation or
kernel that makes a NaN raises ``FloatingPointError``. No scene silently
takes another path.
"""
from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Optional

import numpy as np
import torch

from .. import sanitize
from ..config import DEFAULT_CONFIG, SolverConfig
from ..dtypes import precise_dot, torch_dtype
from ..operator import StiffnessOperator, build_operator
from ..scene import Scene
from ..solvers.cg import SolveStats, pcg
from ..solvers.dense import dense_solve
from ..utils.profiling import span
from . import staged
from ._types import Solution
from .cache import _cached_build, clear_build_cache
from .curv import build_curvilinear, solve_curvilinear
from .embed import _cached_embedding, solve_subgrid_embedded
from .extruded import build_extruded, solve_extruded
from .fpcg import solve_operator_fpcg, solve_operator_refined, solve_operator_refined_host
from .many import solve_many
from .staged import solve_operator_fpcg_staged
from .unstructured import _solve_unstructured_amg, _solve_unstructured_two_level, build_amg_setup

__all__ = [
    "Solution",
    "build_curvilinear",
    "build_extruded",
    "clear_build_cache",
    "solve",
    "solve_curvilinear",
    "solve_displacements",
    "solve_extruded",
    "solve_many",
    "solve_nonlinear",
    "solve_operator",
    "solve_operator_fpcg",
    "solve_operator_fpcg_staged",
    "solve_operator_refined",
    "solve_operator_refined_host",
]

# auto-routing takes the large-grid routes from this size (tests lower it)
_STRUCTURED_MIN_DOF = 50_000
# ... and the embedded, AMG and two-level routes from this one (tests lower it)
_BLOCK_PRECOND_MIN_DOF = 50_000


def _true_relative_residual(op: StiffnessOperator, b: torch.Tensor, u: torch.Tensor, safe_b_norm: float) -> float:
    """||b - A u|| / ||b|| through the operator's own apply, f64 dots."""
    r = b - op.apply(u)
    return float(torch.sqrt(precise_dot(r, r))) / safe_b_norm


def solve_operator(
    op: StiffnessOperator,
    loads: torch.Tensor,
    prescribed: torch.Tensor,
    *,
    method: str = "cg",
    tol: float = 1e-8,
    max_iters: int = 20_000,
    precondition: bool | str = True,
    precond=None,
) -> Solution:
    """Solve with a prebuilt operator, in the operator's dtype.

    ``method``: ``"cg"`` or ``"dense"``. ``precondition``: True (scalar
    Jacobi), False, or ``"block"`` (nodal dpn x dpn block-Jacobi);
    ``precond``, an SPD callable, wins over it.

    The stats report the true residual: after CG it is recomputed as
    ||b - A u|| with one more apply (the operator's own, f64 dots), and
    ``relative_residual`` and ``converged`` come from it. When the
    operator is f64 and the recurrence met ``tol`` but the true residual
    did not, CG restarts from u on the true residual, within the same
    ``max_iters``. An f32 operator gets no restart: it reports its own
    true residual, at the floor of the f32 apply.
    """
    dtype = op.dtype
    loads = loads.to(dtype)
    prescribed = prescribed.to(dtype)
    b = op.rhs(loads, prescribed)

    if method == "cg":
        x0 = (1.0 - op.free) * prescribed  # fixed rows exact from the start
        if precond is None and precondition == "block":
            Binv = op.block_diag_inv_masked()
            precond = lambda r: torch.einsum("nij,nj->ni", Binv, r)  # noqa: E731
        diag = op.diag_masked() if precond is None and precondition else None

        def run(x, budget):
            return pcg(op.apply, b, x, precond_diag=diag, precond=precond, tol=tol, max_iters=budget)

        u, st = run(x0, max_iters)
        iters = st.iterations
        b_norm = float(torch.sqrt(precise_dot(b, b)))
        safe_b_norm = b_norm if b_norm > 0 else 1.0
        rel = _true_relative_residual(op, b, u, safe_b_norm)
        while dtype == torch.float64 and st.converged and rel > tol and iters < max_iters:
            u_new, st = run(u, max_iters - iters)
            iters += st.iterations
            rel_new = _true_relative_residual(op, b, u_new, safe_b_norm)
            if st.iterations == 0 or not rel_new < rel:
                break
            u, rel = u_new, rel_new
        stats = SolveStats(
            iterations=iters, residual_norm=rel * safe_b_norm, relative_residual=rel, converged=rel <= tol
        )
    elif method == "dense":
        x_flat, stats = dense_solve(op.dense(), b.reshape(-1), op.free.reshape(-1))
        u = x_flat.reshape(loads.shape)
    else:
        raise ValueError(f"unknown method {method!r} (expected 'cg' or 'dense')")
    return Solution(displacements=u, reactions=op.apply_raw(u), stats=stats)


def solve_displacements(op: StiffnessOperator, loads, prescribed, *, tol: float = 1e-8, max_iters: int = 20_000):
    """Displacements only, by Jacobi PCG over a prebuilt operator."""
    return solve_operator(op, loads, prescribed, method="cg", tol=tol, max_iters=max_iters).displacements


@span("fea.solve")
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

    The large-grid routes build their operator in f64 whatever ``dtype``
    is; the element-by-element route builds it in ``dtype`` (the scene's
    when None) and takes ``operator`` as given, on the scene's device.
    ``check_jacobians`` raises ValueError on a non-positive detJ.
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
    if method not in ("auto", "cg", "dense"):
        raise ValueError(f"unknown method {method!r} (expected 'auto', 'cg' or 'dense')")
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
        return dataclasses.replace(sol, route=method_name)

    if debug_nans:
        # the first operation that makes a NaN raises FloatingPointError there,
        # instead of the NaN surfacing iterations later as a blow-up bail-out
        with sanitize.debug_nans():
            return solve(
                scene, config=config, method=method, tol=tol, max_iters=max_iters, dtype=dtype,
                check_jacobians=check_jacobians, operator=operator, on_nonconverged=on_nonconverged,
                debug_nans=False,
            )
    if method == "auto" and operator is None and (scene.n_dof >= _STRUCTURED_MIN_DOF or cfg.sharded):
        if scene.family == "hex8":
            found = _solve_large_hex8(scene, cfg, tol, max_iters, dtype, check_jacobians)
            if found is not None:
                return check(*found)
    auto = method == "auto"
    if auto:
        method = "dense" if scene.n_dof < 2000 else "cg"
    if max_iters is None:
        max_iters = min(max(1000, 10 * scene.n_dof), 100_000) if method == "cg" else 1
    if (auto and method == "cg" and operator is None and scene.n_dof >= _BLOCK_PRECOND_MIN_DOF
            and scene.family == "hex8" and scene.elements.shape[1] == 8):
        return check(*_solve_unstructured_hex8(scene, tol, max_iters, check_jacobians))

    if operator is None:
        operator = build_operator(scene, dtype=scene.nodes.dtype if dtype is None else torch_dtype(dtype))
    op = operator
    if check_jacobians and op.geom is not None:
        min_detj = float(op.geom.min_detj)
        if min_detj <= 0.0:
            raise ValueError(
                f"Non-positive Jacobian determinant (min detJ = {min_detj:g}); "
                "check element shapes / node ordering."
            )
    sol = solve_operator(
        op, scene.loads, scene.prescribed_or_zero(op.dtype), method=method, tol=tol, max_iters=max_iters
    )
    return check(sol, method)


def _device_count(device: torch.device) -> int:
    """Devices a sharded solve of a scene on ``device`` may use: the
    visible cards for a scene on the card, 1 for a CPU scene."""
    return torch.cuda.device_count() if device.type == "cuda" else 1


@span("fea.route")
def _grid_route(scene: Scene):
    """The grid route of a hex8 scene, the detectors run in the
    reference's order: ``("voxel", box dims)``, ``("extruded",
    infer_extruded's (quads, n2, n_layers))``, ``("curvilinear", grid
    dims)``, ``("grid", dims)`` for box-grid connectivity too small to
    coarsen, or ``(None, None)``."""
    from ..ops.curvilinear import curv_coarsenable, infer_topo_dims
    from ..ops.extruded import extruded_mg_coarsenable, infer_extruded
    from ..ops.structured import infer_box_dims

    dims = infer_box_dims(scene)
    if dims is not None:
        return "voxel", dims
    # a box-connectivity mesh extruded along z is also curvilinear; the
    # reference sends it to the extruded route, so it is tested first
    ext = infer_extruded(scene)
    if ext is not None and extruded_mg_coarsenable(ext[2] - 1):
        return "extruded", ext
    tdims = infer_topo_dims(scene)
    if tdims is None:
        return None, None
    return ("curvilinear" if curv_coarsenable(tdims) else "grid"), tdims


def _voxel_build(scene: Scene, dims, coarse_dof_limit: int = 3000):
    """The voxel route's f64 stencil operator and f32 V-cycle over it."""
    from ..ops.multigrid import build_multigrid
    from ..ops.structured import build_structured_operator

    op_hi = build_structured_operator(scene, dims, dtype=torch.float64)
    free_np = 1.0 - scene.fixed.cpu().numpy().astype(np.float64)
    mg = build_multigrid(op_hi.astype(torch.float32), dtype=torch.float32, free_np=free_np,
                         coarse_dof_limit=coarse_dof_limit)
    return op_hi, mg


def _solve_large_hex8(
    scene: Scene, cfg: SolverConfig, tol, max_iters, dtype, check_jacobians
) -> Optional[tuple[Solution, str]]:
    """The grid routes of a large hex8 scene, in the reference's order:
    (solution, route name), or None for a scene no grid route takes: it
    goes on to the routes of :func:`solve`'s tail (embedded, AMG,
    two-level, or dense/CG for a scene under ``_BLOCK_PRECOND_MIN_DOF``),
    as in the reference."""
    route, dims = _cached_build("route", scene, lambda: _grid_route(scene))
    if route == "voxel":
        # the z-sharded solve only when asked for (``sharded=True``) and more
        # than one device is visible; a scene it does not take falls through
        # to the one-device route. On one device the build is kept for the
        # mesh's repeat solves; the sharded branch builds every call and
        # lets the whole-grid levels go
        n_dev = _device_count(scene.device)
        sharded = bool(cfg.sharded) and n_dev > 1
        shard = sharded and dims[2] + 1 >= 16
        # a small sharded scene still needs a >= 2-level hierarchy; where
        # this limit leaves one level, the default one leaves the same
        limit = min(3000, max(300, scene.n_dof // 8)) if shard else 3000
        if sharded:
            op_hi, mg = _voxel_build(scene, dims, limit)
        else:
            op_hi, mg = _cached_build("voxel", scene, lambda: _voxel_build(scene, dims))
        if shard and len(mg.levels) >= 2:
            from ..parallel.halo import build_zsharded_solver

            # the first shard, where the solution lands, is the scene's device
            if scene.device.type == "cuda":
                devices = [torch.device("cuda", (scene.device.index + i) % n_dev) for i in range(n_dev)]
            else:
                devices = [scene.device] * n_dev
            solver = build_zsharded_solver(op_hi, mg, devices)
            del op_hi, mg  # the solver holds its shards; the whole-grid levels go
            sol = solver.solve(
                scene.loads, scene.prescribed_or_zero(torch.float64), tol=tol,
                max_iters=max_iters if max_iters is not None else 300,
            )
            return sol, "fpcg-multigrid-zsharded"
        sol = staged.solve_operator_fpcg_staged(
            op_hi,
            scene.loads,
            scene.prescribed_or_zero(torch.float64),
            mg,
            tol=tol,
            max_iters=max_iters if max_iters is not None else 300,
        )
        return sol, "fpcg-multigrid"
    if route == "extruded":
        # one device whatever ``sharded`` says, as in the reference
        sol = solve_extruded(scene, dims, tol=tol, max_iters=max_iters if max_iters is not None else 300)
        return sol, "fpcg-extruded-multigrid"
    if route == "curvilinear":
        sol = solve_curvilinear(
            scene, dims, tol=tol,
            max_iters=max_iters if max_iters is not None else 300,
            check_jacobians=check_jacobians,
        )
        return sol, "fpcg-curvilinear-multigrid"
    if route is None:
        from ..ops.canonical import canonicalize_scene, infer_renumbered_grid
        from ..ops.curvilinear import curv_coarsenable

        with span("fea.route"):
            det = infer_renumbered_grid(scene)
        if det is not None and curv_coarsenable(det[0]):
            cdims, perm = det
            # the canonical scene is cached on this scene's mesh, so that
            # repeat solves hit the curvilinear build cache too; the current
            # call's loads and prescribed values are permuted in fresh
            base = _cached_build("canonical-scene", scene, lambda: canonicalize_scene(scene, cdims, perm))
            inv = np.empty_like(perm)
            inv[perm] = np.arange(perm.size)
            inv = torch.as_tensor(inv, device=scene.device)
            canon = dataclasses.replace(
                base, loads=scene.loads[inv].to(base.loads.dtype),
                prescribed=None if scene.prescribed is None else scene.prescribed[inv].to(base.loads.dtype),
            )
            sol_c = solve(
                canon, config=cfg, method="auto", tol=tol, max_iters=max_iters, dtype=dtype,
                check_jacobians=check_jacobians, on_nonconverged="ignore",
            )
            back = torch.as_tensor(perm, device=scene.device)
            sol = Solution(
                displacements=sol_c.displacements[back],
                reactions=sol_c.reactions[back],
                stats=sol_c.stats,
            )
            return sol, "fpcg-canonicalized-grid"
    return None


def _operator_f64(scene: Scene, check_jacobians: bool) -> StiffnessOperator:
    """The two-level route's f64 element-by-element operator, through the
    build cache (``solve()`` and ``solve_many`` share it); a non-positive
    detJ raises ValueError."""
    op64 = _cached_build("operator-f64", scene, lambda: build_operator(scene, dtype=torch.float64))
    if check_jacobians and op64.geom is not None:
        min_detj = float(op64.geom.min_detj)
        if min_detj <= 0.0:
            raise ValueError(
                f"Non-positive Jacobian determinant (min detJ = {min_detj:g}); "
                "check element shapes / node ordering."
            )
    return op64


def _two_level(scene: Scene, op64: StiffnessOperator):
    """The Chebyshev two-level preconditioner over ``op64``, through the
    build cache."""
    from ..ops.twolevel import build_two_level_cheb

    return _cached_build("twolevel", scene, lambda: build_two_level_cheb(op64, scene.host_nodes))


def _solve_unstructured_hex8(scene: Scene, tol, max_iters, check_jacobians) -> tuple[Solution, str]:
    """The routes of a hex8 scene that no grid route took, in the
    reference's order: embedded, AMG, two-level, block-Jacobi (the module's
    note, route 3). Each build is cached on the scene's mesh."""
    if not os.environ.get("FEA_TPU_NO_EMBED"):
        built = _cached_embedding(scene, check_jacobians)
        if built is not None:
            return solve_subgrid_embedded(scene, built, tol=tol, max_iters=max_iters), "fpcg-subgrid-embedded"
    if not os.environ.get("FEA_TPU_NO_AMG"):
        try:
            setup = _cached_build(("amg", bool(check_jacobians)), scene,
                                  lambda: build_amg_setup(scene, check_jacobians=check_jacobians))
        except Exception as exc:  # noqa: BLE001 - any build failure takes the next route, with a warning
            warnings.warn(f"AMG setup failed ({exc}); falling back to the two-level route", RuntimeWarning,
                          stacklevel=3)
        else:
            return _solve_unstructured_amg(scene, setup, tol=tol, max_iters=max_iters), "fpcg-amg-bcsr"
    op64 = _operator_f64(scene, check_jacobians)
    try:
        tl = _two_level(scene, op64)
    except Exception as exc:  # noqa: BLE001 - geometry and aggregation corner cases
        warnings.warn(f"two-level preconditioner build failed ({exc}); falling back to block-Jacobi",
                      RuntimeWarning, stacklevel=3)
        sol = solve_operator(op64, scene.loads, scene.prescribed_or_zero(torch.float64), method="cg", tol=tol,
                             max_iters=max_iters, precondition="block")
        return sol, "cg-block"
    return _solve_unstructured_two_level(scene, op64, tl, tol=tol, max_iters=max_iters), "fpcg-two-level-cheb"


def solve_nonlinear(scene: Scene, *, tol: float = 1e-10, max_newton_iters: int = 50):
    """Geometrically nonlinear equilibrium of a bar (truss) scene.

    Finds u with loads + f_int(u) = 0 at the free DOFs by Newton-Krylov,
    the internal force taken on the displaced geometry
    (``elements/truss.py::internal_forces``), in the scene's dtype on its
    device. Returns (u, NewtonStats).
    """
    from ..elements import truss as truss_el
    from ..solvers.newton import newton_krylov

    if scene.family not in ("bar2d", "bar3d"):
        raise ValueError("solve_nonlinear currently supports bar scenes")
    if scene.section is None:
        raise ValueError("bar scenes require section = axial stiffness per element")
    dtype = scene.nodes.dtype
    F = scene.free_mask(dtype)
    xp = scene.prescribed_or_zero(dtype)

    def residual(u):
        u_c = F * u + (1.0 - F) * xp
        f_int = truss_el.internal_forces(scene.nodes, scene.elements, u_c, scene.section)
        return F * -(scene.loads + f_int) + (1.0 - F) * (u - xp)

    return newton_krylov(residual, (1.0 - F) * xp, tol=tol, max_newton_iters=max_newton_iters)
