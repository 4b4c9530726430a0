"""The arbitrary-topology family: tools/arbitrary_bench.py's L-domain,
whose connectivity no grid detector and no renumbering recovers, solved
by ``fea_tpu_torch.solve``: from 50,000 DOF it embeds the mesh in its
bounding box (the curvilinear route, K4/K5, void cells at zero weight),
or with ``FEA_TPU_NO_EMBED`` set takes block-CSR smoothed-aggregation
AMG.

    python -m fea_tpu_torch.bench.arbitrary [--nx 20 --ny 20 --nz 72] [--repeats 2] [--device cpu]

Prints one JSON line, the tool's keys: ``t_solve`` the best ``solve()``
wall of max(repeats, 2) (the first builds), ``route`` as the tool names
it, ``relative_residual`` the true residual of that solution recomputed
on the host in NumPy f64 (``host_ku``).
"""
from __future__ import annotations

import argparse
import os

from ..ops.canonical import infer_renumbered_grid
from ..scene import resolve_device
from ..solve import solve
from . import scenes
from ._family import Stages, add_common_args, add_solve_args, best_of, cli, host_check


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--nx", type=int, default=20)
    p.add_argument("--ny", type=int, default=20)
    p.add_argument("--nz", type=int, default=72)
    add_common_args(p)
    add_solve_args(p)
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse(argv)
    device = resolve_device(args.device)
    st = Stages("arb", device, deadline_s=args.deadline_s)
    return st.run(lambda: run(args, st))


def run(args, st: Stages) -> dict:
    with st.stage("scene"):
        scene, h = scenes.l_domain((args.nx, args.ny, args.nz), device=st.device)
    if infer_renumbered_grid(scene) is not None:
        raise ValueError("the L-domain must defeat canonicalization")
    st.extra.update(n_dof=scene.n_dof, n_elements=scene.n_elements, tol=args.tol)
    st.say(f"L-domain scene {scene.n_dof} DOF, {scene.n_elements} elements (non-grid topology)")

    t_solve, sol, walls = best_of(st, args.repeats, lambda: solve(scene, tol=args.tol))
    with st.stage("host_check"):
        _, rel = host_check(h["nodes"], h["elements"], h["mat"], h["fixed"], h["loads"],
                            sol.displacements.cpu().numpy())
    st.say(f"host f64 true relative residual {rel:.3e}")
    return dict(
        dof_per_s=scene.n_dof / t_solve,
        t_solve=t_solve,
        route="arbitrary-amg-bcsr" if os.environ.get("FEA_TPU_NO_EMBED") else "subgrid-embedded-stencil",
        iterations=sol.stats.iterations,
        relative_residual=rel,
        solver_relative_residual=sol.stats.relative_residual,
        converged=sol.stats.converged,
        walls_s=walls,
    )


if __name__ == "__main__":
    cli(main)
