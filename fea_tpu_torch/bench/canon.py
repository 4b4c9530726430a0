"""The canonicalized family: tools/canon_bench.py's scene, the
curvilinear family's distorted cantilever with its nodes renumbered and
its elements shuffled, solved by ``fea_tpu_torch.solve``, which recovers
the grid, solves by the curvilinear route and permutes the solution back.

    python -m fea_tpu_torch.bench.canon [--nx 24 --ny 24 --nz 96] [--repeats 2] [--device cpu]

Prints one JSON line, the tool's keys: ``t_detect`` the detector's host
time, ``t_solve`` the best ``solve()`` wall of max(repeats, 2) (the first
builds, the later ones take the build from the cache), ``relative_residual``
(and ``host_certified_relative_residual``) the true residual of that
solution in the caller's numbering recomputed on the host in NumPy f64
(``host_ku``), and ``reaction_balance`` the y-sum of the reactions over
the y load, which the tool prints.
"""
from __future__ import annotations

import argparse

from ..ops.canonical import infer_renumbered_grid
from ..ops.curvilinear import infer_topo_dims
from ..scene import resolve_device
from ..solve import solve
from . import scenes
from ._family import Stages, add_common_args, add_solve_args, best_of, cli, host_check


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--nx", type=int, default=24)
    p.add_argument("--ny", type=int, default=24)
    p.add_argument("--nz", type=int, default=96)
    add_common_args(p)
    add_solve_args(p)
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse(argv)
    device = resolve_device(args.device)
    st = Stages("canon", device, deadline_s=args.deadline_s)
    return st.run(lambda: run(args, st))


def run(args, st: Stages) -> dict:
    dims = (args.nx, args.ny, args.nz)
    with st.stage("scene"):
        scene, h = scenes.renumbered(dims, device=st.device)
    st.extra.update(n_dof=scene.n_dof, n_elements=scene.n_elements, tol=args.tol)
    if infer_topo_dims(scene) is not None:
        raise ValueError("the scene must not be a grid as given")
    with st.stage("detect"):
        det = infer_renumbered_grid(scene)
    if det is None or det[0] != dims:
        raise ValueError(f"the renumbered grid was detected as {det and det[0]}, expected {dims}")
    st.say(f"scene {scene.n_dof} DOF (renumbered); detector {st.stage_s['detect']:.3f} s")

    t_solve, sol, walls = best_of(st, args.repeats, lambda: solve(scene, tol=args.tol))
    with st.stage("host_check"):
        _, rel = host_check(h["nodes"], h["elements"], h["mat"], h["fixed"], h["loads"],
                            sol.displacements.cpu().numpy())
    react = sol.reactions.cpu().numpy()
    balance = abs(react[:, 1].sum()) / max(abs(h["loads"][:, 1]).sum(), 1e-30)
    st.say(f"host f64 true relative residual {rel:.3e}; reaction balance {balance:.2e}")
    return dict(
        dof_per_s=scene.n_dof / t_solve,
        t_detect=st.stage_s["detect"],
        t_solve=t_solve,
        host_certified_relative_residual=rel,
        route="canonicalized-grid -> curvilinear pipeline",
        iterations=sol.stats.iterations,
        relative_residual=rel,
        solver_relative_residual=sol.stats.relative_residual,
        converged=sol.stats.converged,
        reaction_balance=balance,
        walls_s=walls,
    )


if __name__ == "__main__":
    cli(main)
