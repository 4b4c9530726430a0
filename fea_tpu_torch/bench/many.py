"""Many load cases on the flagship: tools/many_bench.py's k tip loads on
the 1,048,707-DOF voxel cantilever through the batched staged FCG
(``fea_tpu_torch.solve_many``), against a warm single solve of case 0 in
the same process.

    python -m fea_tpu_torch.bench.many [--nx 32 --ny 32 --nz 320] [--cases 8] [--device cpu]

The single path is what ``solve_many`` batches: the voxel route's builds
(``solve._voxel_build``: the f64 stencil operator and the f32 V-cycle)
and the staged FCG (``solve_operator_fpcg_staged``), timed together as
the tool times ``build_structured_operator``, ``build_multigrid_t`` and
``solve_operator_fpcg_t_staged``. It is not a ``solve()`` call: the route
detection (``_grid_route``) is outside it, as it is outside the tool's.
Each call builds afresh, so each captures its step's graph anew.
``t_single_warm`` is the second of two such calls, builds included.
``t_batch_warm`` is the second of two ``solve_many`` calls, with the
build cache cleared before it, so that it builds the same way (and routes)
and captures a graph a case.

Prints one JSON line, the tool's keys: ``per_case_s`` is
``t_batch_warm / cases`` and ``amortized_ratio`` that over
``t_single_warm``. ``worst_relative_residual`` is the largest true
relative residual of the cases, each recomputed on the host in NumPy
f64 by the exact stencil (``native.stencil_apply_host``), not the
solver's figure; ``case0_vs_single_rel`` is max |u_0 - u_single| over
max |u_single|. Added: ``iterations`` (a case), ``relative_residuals``
(host, a case), ``dof_per_s`` (``cases * n_dof / t_batch_warm``),
``batch_launches`` (K1/K2 over the timed batch), and the harness's
``device``, ``peak_mem_gb`` and ``launches``.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from ..scene import resolve_device
from . import scenes
from ._family import Stages, add_common_args, add_solve_args, cli, host_stencil_residual, sync

__all__ = ["main", "tip_loads"]


def tip_loads(nodes: np.ndarray, tip: np.ndarray, cases: int, seed: int = 17) -> np.ndarray:
    """tools/many_bench.py's load cases, (cases, N, 3): on the tip nodes a
    +y load of U(0.5, 2) x 100 / tip nodes and an x load of U(-1, 1) x 100 /
    tip nodes, drawn case by case from ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    batch = np.zeros((cases,) + nodes.shape)
    for i in range(cases):
        batch[i, tip, 1] = rng.uniform(0.5, 2.0) * 100.0 / tip.sum()
        batch[i, tip, 0] = rng.uniform(-1.0, 1.0) * 100.0 / tip.sum()
    return batch


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--nx", type=int, default=32)
    p.add_argument("--ny", type=int, default=32)
    p.add_argument("--nz", type=int, default=320)
    p.add_argument("--cases", type=int, default=8)
    add_common_args(p)
    add_solve_args(p, repeats=False)
    return p.parse_args(argv)


def failed(rec: dict) -> bool:
    """A record whose cases did not all converge with a host true residual
    at most ``tol``."""
    res = rec.get("worst_relative_residual")
    return bool(rec.get("partial")) or not rec.get("converged") or res is None or not res <= rec["tol"]


def main(argv=None) -> dict:
    args = parse(argv)
    device = resolve_device(args.device)
    st = Stages("many", device, deadline_s=args.deadline_s)
    return st.run(lambda: run(args, st))


def run(args, st: Stages) -> dict:
    from ..ops import cuda_stencil
    from ..solve import _voxel_build, clear_build_cache, solve_many, solve_operator_fpcg_staged

    dims = (args.nx, args.ny, args.nz)
    with st.stage("scene"):
        base, h = scenes.cantilever(dims, device=st.device)
        batch = tip_loads(h["nodes"], h["tip"], args.cases)
        scene = dataclasses.replace(base, loads=torch.as_tensor(batch[0], device=st.device))
    st.extra.update(n_dof=scene.n_dof, cases=args.cases, tol=args.tol)
    st.say(f"scene {scene.n_dof} DOF, {args.cases} cases on {st.device}")
    presc = scene.prescribed_or_zero(torch.float64)

    def single():
        t0 = time.perf_counter()
        op_hi, mg = _voxel_build(scene, dims)
        sol = solve_operator_fpcg_staged(op_hi, scene.loads, presc, mg, tol=args.tol, max_iters=300)
        sync(st.device)
        return time.perf_counter() - t0, sol, op_hi

    with st.stage("single_first"):
        t, _, _ = single()
    st.say(f"single first: {t:.3f} s")
    with st.stage("single_warm"):
        t_single, sol1, op_hi = single()
    st.say(f"single warm: {t_single:.3f} s, {sol1.stats.iterations} iterations, "
           f"reported {sol1.stats.relative_residual:.2e}")

    with st.stage("batch_first"):
        solve_many(scene, batch, tol=args.tol, max_iters=300)
    clear_build_cache()  # the batch builds, as the single does
    before = {k: cuda_stencil.LAUNCHES[k] for k in ("f32", "f64")}
    with st.stage("batch_warm"):
        t0 = time.perf_counter()
        solm = solve_many(scene, batch, tol=args.tol, max_iters=300)
        sync(st.device)
        t_batch = time.perf_counter() - t0
    launches = {k: cuda_stencil.LAUNCHES[k] - n for k, n in before.items()}
    per_case = t_batch / args.cases
    st.say(f"batch warm: {t_batch:.3f} s = {per_case:.3f} s a case ({per_case / t_single:.3f}x the warm single); "
           f"iterations {solm.stats.iterations.tolist()}")

    with st.stage("host_check"):
        ke = op_hi.ke.cpu().numpy()
        rels = [host_stencil_residual(ke, dims, h["fixed"], batch[i], solm.displacements[i].cpu().numpy())
                for i in range(args.cases)]
    u0 = sol1.displacements
    du = float((solm.displacements[0] - u0).abs().max() / u0.abs().max())
    st.say(f"host f64 true relative residuals {', '.join(f'{r:.2e}' for r in rels)}; case 0 vs single {du:.2e}")
    return dict(
        t_single_warm=t_single,
        t_batch_warm=t_batch,
        per_case_s=per_case,
        amortized_ratio=per_case / t_single,
        converged=bool(np.all(solm.stats.converged)),
        worst_relative_residual=max(rels),
        case0_vs_single_rel=du,
        iterations=[int(i) for i in solm.stats.iterations],
        relative_residuals=rels,
        single_iterations=sol1.stats.iterations,
        dof_per_s=args.cases * scene.n_dof / t_batch,
        batch_launches=launches,
    )


if __name__ == "__main__":
    cli(main, failed)
