"""The extruded (tube) family: tools/tube_bench.py's tube, solved to tol
by ``solve_extruded`` (the semi-structured operator and the z-semicoarsened
V-cycle with the section coarse space; no hand kernel on this route).

    python -m fea_tpu_torch.bench.tube [--segments 256] [--layers 384] [--repeats 2] [--device cpu]

Prints one JSON line, the tool's keys: ``value`` is the best solve wall
(s) of ``--repeats`` solves after a warm-up, ``relative_residual`` the
true residual of the reported solution recomputed on the host in NumPy
f64 (``host_ku``), ``tip_uy_m`` the mean tip-face y displacement.

The same tube, with its loads spread evenly over the tip face, is the
benchmark's ``tube_591k`` configuration: its cell ``tube_591k.loadcases``
(``BENCHMARK.json``) runs this route through ``fea_tpu_torch.solve()``.
"""
from __future__ import annotations

import argparse
import time

from ..scene import resolve_device
from ..solve import build_extruded, solve_extruded
from . import scenes
from ._family import Stages, add_common_args, add_solve_args, cli, host_check, sync


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--segments", type=int, default=256)
    p.add_argument("--layers", type=int, default=384, help="element layers; k*2^m, k<=16")
    p.add_argument("--degree", type=int, default=3, help="Chebyshev smoother degree")
    p.add_argument("--no-section-coarse", action="store_true")
    p.add_argument("--section-aggregates", type=int, default=64)
    add_common_args(p)
    add_solve_args(p)
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse(argv)
    device = resolve_device(args.device)
    st = Stages("tube", device, deadline_s=args.deadline_s)
    return st.run(lambda: run(args, st))


def run(args, st: Stages) -> dict:
    with st.stage("scene"):
        scene, detected, h = scenes.tube(args.segments, args.layers, device=st.device)
    st.extra.update(n_dof=scene.n_dof, n_elements=scene.n_elements, tol=args.tol)
    st.say(f"scene: {scene.n_dof} DOF, {scene.n_elements} elements on {st.device}")

    # one-time set-up (operator, z-semicoarsened hierarchy, section coarse
    # space), then repeated solves: many load cases on one mesh
    with st.stage("hierarchy_setup"):
        prebuilt = build_extruded(scene, detected, degree=args.degree, section_coarse=not args.no_section_coarse,
                                  section_aggregates=args.section_aggregates)

    def solve():
        t0 = time.perf_counter()
        sol = solve_extruded(scene, detected, tol=args.tol, degree=args.degree, prebuilt=prebuilt)
        sync(st.device)
        return sol, time.perf_counter() - t0

    with st.stage("warmup"):
        sol, warm_s = solve()
    st.say(f"warmup (graph capture included): {warm_s:.3f} s, {sol.stats.iterations} iterations")
    times = []
    for rep in range(args.repeats):
        with st.stage(f"solve_{rep}"):
            sol, t = solve()
        times.append(t)
    best = min(times) if times else warm_s

    with st.stage("host_check"):
        u = sol.displacements.cpu().numpy()
        _, rel = host_check(h["nodes"], h["elements"], h["mat"], h["fixed"], h["loads"], u)
    st.say(f"host f64 true relative residual {rel:.3e}")
    return {
        "metric": "tube_extruded_solve_s",
        "value": best,
        "unit": "s",
        "dof_per_s": scene.n_dof / best,
        "iterations": sol.stats.iterations,
        "relative_residual": rel,
        "solver_relative_residual": sol.stats.relative_residual,
        "converged": sol.stats.converged,
        "tip_uy_m": float(u[h["tip"], 1].mean()),
        "hierarchy_setup_s": st.stage_s["hierarchy_setup"],
        "first_s": warm_s,
        "walls_s": times,
    }


if __name__ == "__main__":
    cli(main)
