"""SciPy's sparse direct solve against fea_tpu_torch on one scene:
tools/scipy_compare.py's voxel cantilever (bench.py's geometry, load and
supports; 16x16x160 voxels, 139,587 DOF, by default).

    python -m fea_tpu_torch.bench.scipy_compare [--nx 16 --ny 16 --nz 160] [--device cpu]

The SciPy path, as the tool defines it: the element matrices
(``op.element_matrices()`` of ``build_operator(scene, float64)``) summed
into a CSR matrix, reduced to the free DOFs, and SuperLU's ``spsolve`` on
the host; ``scipy_assembly_s`` and ``scipy_spsolve_s`` time the two.
The port's path: ``fea_tpu_torch.solve(scene, tol=1e-10)``, one warm-up
call and then one timed call ending in a synchronize
(``fea_tpu_total_s``), the build cache cleared before it so that it builds
as the tool's solve does; from 50,000 DOF that is the voxel route, K1/K2
on the card.

Prints one JSON line, the tool's keys (``n_dof``, ``scipy_assembly_s``,
``scipy_spsolve_s``, ``scipy_total_s``, ``fea_tpu_total_s``,
``speedup_vs_scipy``, ``displacement_rel_diff`` = max |u - u_scipy| over
max |u_scipy|, ``backend``), unrounded, and ``device`` (the card's name
and power limit), ``route`` (the route the timed ``solve()`` took, as its
``Solution`` names it), ``iterations``, ``converged``,
``launches`` (the K1/K2 launches of the timed call), and the true
relative residuals of both solutions recomputed on the host in NumPy f64
by the exact stencil (``relative_residual``, ``scipy_relative_residual``).
A slender bar's f64 floor lies near tol 1e-10 (SuperLU's own solution of
the 8x8x320 bar has 4.0e-10), so ``converged`` may be false there; the
run exits 1 only when the displacements disagree by more than
``AGREE_TOL``. SuperLU's fill grows fast with the section: the default
size took 1,342 s of ``spsolve`` on the JAX repo's host.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from ..operator import build_operator
from ..scene import resolve_device
from . import scenes
from ._family import device_label, host_stencil_residual, sync

__all__ = ["main"]

AGREE_TOL = 1e-8  # displacement_rel_diff of a passing run


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--nx", type=int, default=16)
    p.add_argument("--ny", type=int, default=16)
    p.add_argument("--nz", type=int, default=160)
    p.add_argument("--device", default=None, help="torch device (default: the CUDA card; 'cpu' to run on the CPU)")
    return p.parse_args(argv)


def say(msg: str) -> None:
    print(f"[scipy_compare] {msg}", file=sys.stderr, flush=True)


def main(argv=None) -> dict:
    from ..ops import cuda_stencil
    from ..solve import clear_build_cache, solve

    args = parse(argv)
    device = resolve_device(args.device)
    scene, h = scenes.cantilever((args.nx, args.ny, args.nz), device=device)
    say(f"scene {scene.n_dof} DOF on {device}")

    t0 = time.perf_counter()
    op = build_operator(scene, dtype=torch.float64)
    ke = op.element_matrices().cpu().numpy()  # (E, 24, 24)
    ke1 = op.ke.cpu().numpy()  # the voxel mesh's one Ke, for the host residuals
    elements = h["elements"]
    dof = (3 * elements[:, :, None] + np.arange(3)).reshape(len(elements), 24)
    rows = np.repeat(dof, 24, axis=1).ravel()
    cols = np.tile(dof, (1, 24)).ravel()
    K = sp.coo_matrix((ke.ravel(), (rows, cols)), shape=(scene.n_dof, scene.n_dof)).tocsr()
    free = ~h["fixed"].reshape(-1).astype(bool)
    Kff = K[free][:, free]
    f = h["loads"].reshape(-1)[free]
    t_asm = time.perf_counter() - t0
    del op, ke, K
    say(f"SciPy CSR assembly {t_asm:.3f} s, {Kff.nnz} nonzeros in the free block")
    t0 = time.perf_counter()
    u_free = spla.spsolve(Kff.tocsc(), f)
    t_solve = time.perf_counter() - t0
    say(f"SuperLU spsolve {t_solve:.3f} s")
    u_sp = np.zeros(scene.n_dof)
    u_sp[free] = u_free
    scipy_s = t_asm + t_solve

    solve(scene, tol=1e-10)  # warm-up: builds the kernels, captures
    clear_build_cache()
    cuda_stencil.LAUNCHES.update(dict.fromkeys(cuda_stencil.LAUNCHES, 0))
    t0 = time.perf_counter()
    sol = solve(scene, tol=1e-10)
    sync(device)
    ours_s = time.perf_counter() - t0
    launches = {k: cuda_stencil.LAUNCHES[k] for k in ("f32", "f64")}
    say(f"fea_tpu_torch.solve {ours_s:.4f} s ({sol.route}, {sol.stats.iterations} iterations)")

    u = sol.displacements.cpu().numpy().reshape(-1)
    agree = float(np.max(np.abs(u - u_sp)) / np.max(np.abs(u_sp)))
    dims = (args.nx, args.ny, args.nz)
    rel, rel_sp = (host_stencil_residual(ke1, dims, h["fixed"], h["loads"], v.reshape(-1, 3)) for v in (u, u_sp))
    say(f"displacements agree to {agree:.3e}; host f64 true residuals {rel:.3e} (ours), {rel_sp:.3e} (SuperLU)")
    return {
        "n_dof": scene.n_dof,
        "scipy_assembly_s": t_asm,
        "scipy_spsolve_s": t_solve,
        "scipy_total_s": scipy_s,
        "fea_tpu_total_s": ours_s,
        "speedup_vs_scipy": scipy_s / ours_s,
        "displacement_rel_diff": agree,
        "backend": device.type,
        "device": device_label(device),
        "route": sol.route,
        "iterations": sol.stats.iterations,
        "converged": sol.stats.converged,
        "relative_residual": rel,
        "scipy_relative_residual": rel_sp,
        "launches": launches,
    }


if __name__ == "__main__":
    rec = main()
    print(json.dumps(rec), flush=True)
    sys.exit(0 if rec["displacement_rel_diff"] <= AGREE_TOL else 1)
