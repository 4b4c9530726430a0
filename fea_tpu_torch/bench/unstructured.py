"""The unstructured route: tools/unstructured_bench.py's distorted box
(a 24x24x96 mesh, 181,875 DOF, interior nodes moved by 0.25 h U(-1, 1)
from ``default_rng(7)``, z = 0 fixed, a +y tip load of 1 / tip nodes),
solved by the element-by-element f64 operator (``hex8_matfree``: the
mesh is not congruent) with the Chebyshev two-level preconditioner in
the staged FCG loop: the fallback a mesh takes when no grid route and no
box embedding does.

    python -m fea_tpu_torch.bench.unstructured [--nx 24 --ny 24 --nz 96] [--aggregates 512] [--device cpu]

The operator is ``build_operator(scene, dtype=float64)``, the
preconditioner ``ops/twolevel.py::build_two_level_cheb`` and the solve
``solve/unstructured.py::_solve_unstructured_two_level``, the port's
counterpart of the tool's ``_solve_unstructured_ddq``. No TPU kernel
runs on this route, in either package.

Prints one JSON line, the tool's keys: ``backend`` (the device's label),
``operator_build_s`` (the scene and the operator, as the tool times
them), ``twolevel_build_s``, ``solve_s_with_compile`` (the first solve,
which captures the step's graph), ``solve_s_best`` (the best of
``--repeats`` later solves), ``dof_per_s`` (``n_dof / solve_s_best``), and
``relative_residual``, the true residual of the solution recomputed on
the host in NumPy f64 (``host_ku``), not the solver's figure
(``solver_relative_residual``).

The tool's ``--legacy-f64`` has no counterpart: it measures the JAX
package's emulated-f64 pair loop, a workaround for a chip without f64.
"""
from __future__ import annotations

import argparse
import time

import torch

from ..operator import build_operator
from ..ops.twolevel import build_two_level_cheb
from ..scene import resolve_device
from ..solve import _solve_unstructured_two_level
from . import scenes
from ._family import Stages, add_common_args, add_solve_args, cli, device_label, host_check, sync

__all__ = ["main"]


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--nx", type=int, default=24)
    p.add_argument("--ny", type=int, default=24)
    p.add_argument("--nz", type=int, default=96)
    p.add_argument("--aggregates", type=int, default=512)
    p.add_argument("--degree", type=int, default=2, help="Chebyshev smoother degree")
    add_common_args(p)
    add_solve_args(p)
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse(argv)
    device = resolve_device(args.device)
    st = Stages("unstructured", device, deadline_s=args.deadline_s)
    return st.run(lambda: run(args, st))


def run(args, st: Stages) -> dict:
    with st.stage("scene"):
        scene, h = scenes.distorted((args.nx, args.ny, args.nz), device=st.device)
    st.extra.update(backend=device_label(st.device), n_dof=scene.n_dof, n_elements=scene.n_elements, tol=args.tol)
    st.say(f"distorted scene {scene.n_dof} DOF, {scene.n_elements} elements on {st.device}")
    with st.stage("operator_build"):
        op = build_operator(scene, dtype=torch.float64)
    st.say(f"operator kind {op.kind}")
    with st.stage("twolevel_build"):
        tl = build_two_level_cheb(op, scene.host_nodes, target_aggregates=args.aggregates, degree=args.degree)
    st.say(f"{tl.n_aggs} aggregates, lam_max {tl.lam_max:.3f}")

    def solve():
        t0 = time.perf_counter()
        sol = _solve_unstructured_two_level(scene, op, tl, tol=args.tol, max_iters=20_000)
        sync(st.device)
        return sol, time.perf_counter() - t0

    with st.stage("solve_first"):
        sol, t_first = solve()
    st.say(f"first solve {t_first:.3f} s, {sol.stats.iterations} iterations")
    walls = []
    for rep in range(args.repeats):
        with st.stage(f"solve_{rep}"):
            sol, t = solve()
        walls.append(t)
        st.say(f"repeat {rep}: {t:.3f} s, {sol.stats.iterations} iterations, "
               f"reported {sol.stats.relative_residual:.2e}")
    best = min(walls) if walls else t_first
    with st.stage("host_check"):
        _, rel = host_check(h["nodes"], h["elements"], h["mat"], h["fixed"], h["loads"],
                            sol.displacements.cpu().numpy())
    st.say(f"host f64 true relative residual {rel:.3e}")
    return dict(
        n_aggregates=tl.n_aggs,
        iterations=sol.stats.iterations,
        relative_residual=rel,
        solver_relative_residual=sol.stats.relative_residual,
        converged=sol.stats.converged,
        operator_build_s=st.stage_s["scene"] + st.stage_s["operator_build"],
        twolevel_build_s=st.stage_s["twolevel_build"],
        solve_s_best=best,
        solve_s_with_compile=t_first,
        dof_per_s=scene.n_dof / best,
        walls_s=walls,
        operator_kind=op.kind,
    )


if __name__ == "__main__":
    cli(main)
