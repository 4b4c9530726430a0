"""Design sweeps of one cantilever: the load's magnitude (8 scales, tip
deflections exactly linear), Young's modulus (4 values, tips ~ 1/E), and
8 load cases through the multigrid route of ``solve_many``. Twin of
``examples/sweep.py``, which vmaps its first two sweeps: here the load
scales are one ``solve_many`` batch and the materials a loop of Jacobi
PCG solves, to the same tolerances.

    python -m fea_tpu_torch.examples.sweep [--device cpu]
"""
from __future__ import annotations

import numpy as np
import torch

import fea_tpu_torch as ftt

from ._cli import parse


def main(argv=None):
    args = parse(__doc__.splitlines()[0], argv)
    mat = ftt.Material(E=10_000_000 * ftt.units.psi, nu=0.3)
    nodes, elements = ftt.mesh.box_hex_mesh(4, 4, 24, 0.1, 0.1, 0.5)
    fixed = ftt.fix_where(nodes, lambda p: p[:, 2] == 0.0, 3)
    base_loads = np.zeros_like(nodes)
    tip = nodes[:, 2] == 0.5
    base_loads[tip, 1] = 1000.0 / tip.sum()
    scene = ftt.make_scene(nodes, elements, fixed, base_loads, mat, dtype=torch.float64, device=args.device)
    zero = scene.prescribed_or_zero(torch.float64)

    # --- sweep 1: load magnitude (linear: tips scale exactly) -------------
    scales = np.linspace(0.5, 4.0, 8)
    loads_batch = scales[:, None, None] * base_loads[None]
    u_batch = ftt.solve_many(scene, loads_batch, tol=1e-10).displacements.cpu().numpy()
    tips = u_batch[:, tip, 1].mean(axis=1)
    print("load scale -> tip deflection (m):")
    for s, t in zip(scales, tips):
        print(f"  {s:4.2f} x  ->  {t: .6e}")
    lin_err = np.max(np.abs(tips / tips[0] - scales / scales[0]))
    print(f"linearity check: max deviation {lin_err:.2e} (exact for a linear model)")
    assert lin_err < 1e-8

    # --- sweep 2: material stiffness (tip ~ 1/E) --------------------------
    Es = np.linspace(0.5, 2.0, 4) * mat.E
    tips_E = []
    for E in Es:
        scene_E = ftt.make_scene(nodes, elements, fixed, base_loads, ftt.Material(E=float(E), nu=0.3),
                                 dtype=torch.float64, device=args.device)
        op = ftt.build_operator(scene_E, dtype=torch.float64)
        u = ftt.solve_displacements(op, scene_E.loads, zero, tol=1e-10, max_iters=20000)
        tips_E.append(float(u[torch.as_tensor(tip, device=u.device), 1].mean()))
    tips_E = np.asarray(tips_E)
    print("E sweep -> tip deflection (m):")
    for E, t in zip(Es, tips_E):
        print(f"  E={E:.3e}  ->  {t: .6e}")
    inv_err = np.max(np.abs(tips_E * Es / (tips_E[0] * Es[0]) - 1.0))
    print(f"1/E scaling check: max deviation {inv_err:.2e}")
    assert inv_err < 1e-6

    # --- sweep 3: many load CASES through the multigrid route -------------
    rng = np.random.default_rng(3)
    k = 8
    cases = np.zeros((k, nodes.shape[0], 3))
    for i in range(k):
        cases[i, tip, 1] = rng.uniform(0.5, 2.0) * 1000.0 / tip.sum()
        cases[i, tip, 0] = rng.uniform(-1.0, 1.0) * 500.0 / tip.sum()
    sol_many = ftt.solve_many(scene, cases, tol=1e-9)
    tips_many = sol_many.displacements.cpu().numpy()[:, tip, 1].mean(axis=1)
    print("8 load cases, one batched multigrid solve:")
    for i, t in enumerate(tips_many):
        it = int(np.asarray(sol_many.stats.iterations)[i])
        print(f"  case {i}: tip {t: .6e} m  ({it} iterations)")
    assert bool(np.all(np.asarray(sol_many.stats.converged)))
    return tips, tips_E, tips_many


if __name__ == "__main__":
    main()
