"""Stage profile of the voxel route's solve at the flagship:
tools/t_profile.py (the 32x32x320 voxel cantilever, 1,048,707 DOF, by
default), each piece timed alone so that the benchmark's wall can be
attributed.

    python -m fea_tpu_torch.bench.profile [--nx 32 --ny 32 --nz 320] [--reps 10] [--device cpu]

Pieces, over the operator and hierarchy ``solve()`` builds
(``solve._voxel_build``): ``dd_masked_apply_ms`` (the FCG's f64 apply,
K2 with the free mask fused), ``f32_level_apply_ms`` (level 0's masked K1
apply), ``vcycle_ms`` (one f32 V-cycle), ``fcg_vector_algebra_ms`` (the
tool's f64 algebra of one FCG iteration: 3 axpys and 3 dots), and the
staged solve ``bench_torch.py`` times (``solve_operator_fpcg_staged`` to
tol 1e-8, one warm-up, the best of 3): ``fpcg_iterations``,
``fpcg_solve_ms``, ``fpcg_per_iter_ms``, and ``fpcg_relative_residual``,
the true residual recomputed on the host in NumPy f64 by the exact
stencil.

Each piece is the tool's host wall (one call and a synchronize, the best
of ``--reps``) and, on the card, ``<piece>_graph_ms``: the median
CUDA-graph replay time of one call (``graph_ms``), the card's own time.
A whole solve has no graph figure: its iterations are graph replays
already. The solve runs bench.py's tip load: the tool builds its scene
with ``structured_scene``'s default loads, which are zero, so its
``fpcg_*`` figures time a zero right-hand side.

Dropped, as the port has no such step: ``transpose_f64_ms`` and
``transpose_f32_ms`` (the (3, Y, X, Z) layout of the TPU's lanes) and
``split_to_pair_ms`` (the f64 -> f32 pair split of its emulated f64).
Prints one JSON line.
"""
from __future__ import annotations

import argparse
import math
import time

import numpy as np
import torch

from ..dtypes import precise_dot
from ..scene import resolve_device
from . import scenes
from ._family import Stages, add_common_args, cli, device_label, graph_ms, host_stencil_residual, sync

__all__ = ["PIECES", "main"]

PIECES = ("dd_masked_apply", "f32_level_apply", "vcycle", "fcg_vector_algebra")


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--nx", type=int, default=32)
    p.add_argument("--ny", type=int, default=32)
    p.add_argument("--nz", type=int, default=320)
    p.add_argument("--reps", type=int, default=10)
    add_common_args(p)
    return p.parse_args(argv)


def failed(rec: dict) -> bool:
    keys = [f"{p}_ms" for p in PIECES] + ["fpcg_solve_ms", "fpcg_per_iter_ms"]
    return (bool(rec.get("partial")) or not rec.get("fpcg_converged") or not rec["fpcg_relative_residual"] <= 1e-8
            or not all(math.isfinite(rec.get(k, math.nan)) for k in keys))


def main(argv=None) -> dict:
    args = parse(argv)
    device = resolve_device(args.device)
    st = Stages("profile", device, deadline_s=args.deadline_s)
    return st.run(lambda: run(args, st))


def best_ms(fn, device: torch.device, reps: int) -> float:
    """The tool's ``timeit``: one call, then the best of ``reps`` host walls
    of one call ending in a synchronize, ms."""
    fn()
    sync(device)
    best = math.inf
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync(device)
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


def fcg_vector_algebra(x, p, r, z):
    """The tool's f64 algebra of one FCG iteration, every scalar kept on
    the device: 3 dots and 3 axpys."""
    pAp = precise_dot(p, r)
    alpha = 0.5 / pAp
    x2 = x + alpha * p
    r2 = r - alpha * p
    rz = precise_dot(r2, z)
    beta = rz / precise_dot(r2, r2)
    p2 = z + beta * p
    return x2, r2, p2, rz


def run(args, st: Stages) -> dict:
    from ..solve import _voxel_build, solve_operator_fpcg_staged

    dev = st.device
    dims = (args.nx, args.ny, args.nz)
    with st.stage("build"):
        scene, h = scenes.cantilever(dims, device=dev)
        op_hi, mg = _voxel_build(scene, dims)
    Z, Y, X = op_hi.grid_shape
    st.extra.update(backend=device_label(dev), n_dof=scene.n_dof, reps=args.reps)
    rng = np.random.default_rng(0)
    x64 = torch.as_tensor(rng.normal(size=(Z * Y * X, 3)), device=dev)
    x32 = x64.float()
    g32 = x32.reshape(Z, Y, X, 3)
    level0 = mg.levels[0]
    pieces = {
        "dd_masked_apply": lambda: op_hi.apply(x64),
        "f32_level_apply": lambda: level0.apply(g32),
        "vcycle": lambda: mg(x32),
        "fcg_vector_algebra": lambda: fcg_vector_algebra(x64, x64, x64, x64),
    }
    rec = {}
    for name, fn in pieces.items():
        with st.stage(name):
            rec[f"{name}_ms"] = best_ms(fn, dev, args.reps)
            if dev.type == "cuda":
                rec[f"{name}_graph_ms"] = graph_ms(fn)
        st.say(f"{name}: {rec[f'{name}_ms']:.4f} ms" + (f", graph {rec[f'{name}_graph_ms']:.4f} ms"
                                                          if dev.type == "cuda" else ""))

    zero = scene.prescribed_or_zero(torch.float64)

    def full():
        sol = solve_operator_fpcg_staged(op_hi, scene.loads, zero, mg, tol=1e-8, max_iters=300)
        sync(dev)
        return sol

    with st.stage("fpcg"):
        sol = full()
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            sol = full()
            walls.append(time.perf_counter() - t0)
    best = min(walls) * 1e3
    rel = host_stencil_residual(op_hi.ke.cpu().numpy(), dims, h["fixed"], h["loads"],
                                sol.displacements.cpu().numpy())
    rec.update(fpcg_iterations=sol.stats.iterations, fpcg_solve_ms=best,
               fpcg_per_iter_ms=best / max(sol.stats.iterations, 1), fpcg_converged=sol.stats.converged,
               fpcg_relative_residual=rel, fpcg_solver_relative_residual=sol.stats.relative_residual,
               fpcg_walls_ms=[w * 1e3 for w in walls])
    st.say(f"fpcg: {sol.stats.iterations} iterations, best {best:.3f} ms, host f64 true residual {rel:.3e}")
    return rec


if __name__ == "__main__":
    cli(main, failed)
