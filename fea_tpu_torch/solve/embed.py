"""Embedded route: hex8 meshes whose cells are a subset of a box grid's
cells (L-domains, steps, holes), solved through the curvilinear route on
their bounding box.

Real nodes keep their positions, void lattice sites get synthetic ones,
void cells assemble exactly zero weights
(``assemble_curv_weights(valid=)``), and every void DOF is fixed at
zero. Restricted to the real DOFs, the embedded operator is the mesh's
stiffness, so the curvilinear machinery serves the mesh unchanged: the
weights on the scene's device, the Galerkin-RAP V-cycle, the staged FCG
loop (K5 for the f64 apply, K4/K5 on the V-cycle levels) and the
true-residual certification. An L-domain is 3/4 of its box, so the
stencil runs on 4/3 of the nodes it needs, in place of the BCSR route's
index gathers.

Counterpart of ``fea_tpu/solve/embed.py``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..scene import Scene, make_scene
from ..utils.profiling import span
from ._types import Solution
from .cache import _cached_build

__all__ = ["build_subgrid_embedded", "solve_subgrid_embedded"]


def build_subgrid_embedded(scene: Scene, det, *, degree: int = 2, check_jacobians: bool = True):
    """One-time set-up: ``(carrier, op, mg, lat)``. ``det = (dims, lat,
    valid)`` from ``ops.canonical.infer_subgrid_embedding``; the carrier is
    a scene on the lattice with zero loads, which :func:`solve_subgrid_embedded`
    fills afresh on every call. The weights are assembled on the scene's
    device."""
    from ..ops.curvilinear import CurvilinearOperator, assemble_curv_weights, build_curv_multigrid

    dims, lat, valid = det
    nx, ny, nz = dims
    X, Y, Z = nx + 1, ny + 1, nz + 1
    M = X * Y * Z
    nodes = scene.host_nodes.astype(np.float64)
    fixed = scene.fixed.cpu().numpy().astype(np.float64)

    # void lattice sites sit on the regular lattice at the mesh's mean
    # spacing an axis: they only have to give finite geometry, since a void
    # cell's Ke is selected away and its detJ not checked
    lo = nodes.min(axis=0)
    h = (nodes.max(axis=0) - lo) / np.maximum(np.asarray([nx, ny, nz], np.float64), 1.0)
    iz, rem = np.divmod(np.arange(M), X * Y)
    iy, ix = np.divmod(rem, X)
    emb_nodes = lo + np.stack([ix, iy, iz], axis=1).astype(np.float64) * h
    emb_nodes[lat] = nodes
    emb_fixed = np.ones((M, 3))  # void DOFs held at zero
    emb_fixed[lat] = fixed

    dev = scene.device
    free_np = 1.0 - emb_fixed
    with span("fea.build.operator"):
        w, min_detj = assemble_curv_weights(torch.as_tensor(emb_nodes, device=dev), dims, scene.material,
                                            valid=valid)
        if check_jacobians:
            mdj = float(min_detj)
            if mdj <= 0.0:
                raise ValueError(
                    f"Non-positive Jacobian determinant (min detJ = {mdj:g}); "
                    "check element shapes / node ordering."
                )
        op = CurvilinearOperator(w=w, free=torch.as_tensor(free_np, device=dev), dims=dims)
    mg = build_curv_multigrid(w, dims, free_np, degree=degree)
    carrier = make_scene(emb_nodes, lat[scene.host_elements], emb_fixed, np.zeros((M, 3)), scene.material,
                         dtype=torch.float64, device=dev)
    return carrier, op, mg, lat


def solve_subgrid_embedded(scene: Scene, built, *, tol: float = 1e-8, max_iters: int = 300) -> Solution:
    """Solve ``scene`` through its box embedding ``built`` (from
    :func:`build_subgrid_embedded`). The loads and prescribed values of
    this call are scattered into the lattice; displacements and reactions
    come back in the scene's node order, gathered through the lattice map
    (the reactions of the real rows: void cells carry no weight, so no
    void DOF adds to them)."""
    from .curv import solve_curvilinear

    carrier, op, mg, lat = built
    idx = torch.as_tensor(lat, device=carrier.device)
    emb = dataclasses.replace(
        carrier, loads=_to_lattice(scene.loads, idx, carrier.n_nodes),
        prescribed=None if scene.prescribed is None else _to_lattice(scene.prescribed, idx, carrier.n_nodes),
    )
    sol = solve_curvilinear(emb, op.dims, tol=tol, max_iters=max_iters, prebuilt=(op, mg))
    return Solution(displacements=sol.displacements[idx], reactions=sol.reactions[idx], stats=sol.stats)


def _to_lattice(values: torch.Tensor, idx: torch.Tensor, n_lattice: int) -> torch.Tensor:
    """(..., N, 3) values of the real nodes as (..., n_lattice, 3) f64 on
    the lattice, zero at the void sites."""
    out = torch.zeros(values.shape[:-2] + (n_lattice, 3), dtype=torch.float64, device=values.device)
    out[..., idx, :] = values.to(torch.float64)
    return out


def _cached_embedding(scene: Scene, check_jacobians: bool = True):
    """The embedded build of ``scene`` through the build cache (``solve()``
    and ``solve_many`` share it), or None when its cells are no proper
    subset of a box grid's or the box cannot coarsen to a dense-invertible
    level. A full grid (every cell present) never embeds: the grid routes
    ahead of this one saw it and passed it on by their own size gates."""
    from ..ops.canonical import infer_subgrid_embedding
    from ..ops.curvilinear import curv_coarsenable

    def build():
        det = infer_subgrid_embedding(scene)
        if det is None or bool(det[2].all()) or not curv_coarsenable(det[0]):
            return None
        return build_subgrid_embedded(scene, det, check_jacobians=check_jacobians)

    # check_jacobians is part of the key: a build that skipped the check
    # must not serve a caller who asked for it
    return _cached_build(("subgrid-embed", bool(check_jacobians)), scene, build)
