"""The curvilinear family: tools/curv_bench.py's distorted cantilever,
solved to tol by the curvilinear route (the variable-weight block stencil
K4/K5 and its Galerkin multigrid, FCG on the card).

    python -m fea_tpu_torch.bench.curv [--nx 24 --ny 24 --nz 96] [--repeats 2] [--device cpu]

Prints one JSON line, the tool's keys: ``t_solve`` is the best solve wall
of max(repeats, 2) solves on one prebuilt operator and hierarchy (the
first captures the step's graph), ``dof_per_s`` is ``n_dof / t_solve``,
``relative_residual`` (and ``host_certified_relative_residual``, the
tool's name for it) the true residual of that solution recomputed on the
host in NumPy f64 (``host_ku``).
"""
from __future__ import annotations

import argparse

import numpy as np

from ..ops.curvilinear import build_curv_multigrid, build_curv_operator, infer_topo_dims
from ..scene import resolve_device
from ..solve import solve_curvilinear
from . import scenes
from ._family import Stages, add_common_args, add_solve_args, best_of, cli, host_check


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--nx", type=int, default=24)
    p.add_argument("--ny", type=int, default=24)
    p.add_argument("--nz", type=int, default=96)
    p.add_argument("--degree", type=int, default=2, help="Chebyshev smoother degree")
    add_common_args(p)
    add_solve_args(p)
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse(argv)
    device = resolve_device(args.device)
    st = Stages("curv", device, deadline_s=args.deadline_s)
    return st.run(lambda: run(args, st))


def run(args, st: Stages) -> dict:
    dims = (args.nx, args.ny, args.nz)
    with st.stage("scene"):
        scene, h = scenes.distorted(dims, device=st.device)
    st.extra.update(n_dof=scene.n_dof, n_elements=scene.n_elements, tol=args.tol)
    st.say(f"scene {scene.n_dof} DOF on {st.device}")
    found = infer_topo_dims(scene)
    if found != dims:
        raise ValueError(f"topology detected as {found}, expected {dims}")

    with st.stage("operator_build"):
        op = build_curv_operator(scene, dims)  # f64
    with st.stage("mg_build"):
        free_np = 1.0 - h["fixed"].astype(np.float64)
        mg = build_curv_multigrid(op.w, dims, free_np, degree=args.degree)
    st.say(f"multigrid levels {[lv.dims for lv in mg.levels]}")

    t_solve, sol, walls = best_of(
        st, args.repeats, lambda: solve_curvilinear(scene, dims, tol=args.tol, max_iters=200, prebuilt=(op, mg)))
    with st.stage("host_check"):
        _, rel = host_check(h["nodes"], h["elements"], h["mat"], h["fixed"], h["loads"],
                            sol.displacements.cpu().numpy())
    st.say(f"host f64 true relative residual {rel:.3e}")
    return dict(
        dof_per_s=scene.n_dof / t_solve,
        t_operator_build=st.stage_s["operator_build"],
        t_mg_build=st.stage_s["mg_build"],
        t_solve=t_solve,
        host_certified_relative_residual=rel,
        iterations=sol.stats.iterations,
        relative_residual=rel,
        solver_relative_residual=sol.stats.relative_residual,
        converged=sol.stats.converged,
        walls_s=walls,
    )


if __name__ == "__main__":
    cli(main)
