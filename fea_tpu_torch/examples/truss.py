"""Two-bar truss, solved linearly and by the geometrically nonlinear
Newton-Krylov path; prints the apex displacements, Newton's iterations
and residual, and the member forces. Twin of ``examples/truss.py``.

    python -m fea_tpu_torch.examples.truss [--device cpu] [--show]
"""
from __future__ import annotations

import numpy as np
import torch

import fea_tpu_torch as ftt
from fea_tpu_torch.elements import truss

from ._cli import parse


def main(argv=None):
    args = parse(__doc__.splitlines()[0], argv)
    k = 1000.0
    nodes = np.array([[0.0, 0.0], [0.0, 1.0], [1.0, 0.5]])
    members = np.array([[0, 2], [1, 2]])
    fixed = np.zeros((3, 2), dtype=bool)
    fixed[0] = fixed[1] = True
    loads = np.zeros((3, 2))
    loads[2] = [0.0, -100.0]

    scene = ftt.make_scene(nodes, members, fixed, loads, ftt.Material(1.0, 0.0), family="bar2d",
                           section=np.full(2, k), dtype=torch.float64, device=args.device)

    lin = ftt.solve(scene, method="dense")
    print("linear apex displacement:", lin.displacements.cpu().numpy()[2])

    u_nl, stats = ftt.solve_nonlinear(scene, tol=1e-12)
    print("nonlinear apex displacement:", u_nl.cpu().numpy()[2])
    print(f"newton iterations: {int(stats.iterations)}, residual: {float(stats.residual_norm):.2e}")

    mf = truss.member_forces(scene.nodes, scene.elements, u_nl, scene.section).cpu().numpy()
    print("member axial forces (tension +):", mf)

    if args.show:
        import matplotlib.pyplot as plt

        fig, (ax0, ax1) = plt.subplots(1, 2, figsize=(10, 5))
        ftt.viz.mpl.plot_truss(ax0, nodes, members, loads=loads, annotate_members=True)
        ax0.set_title("undeformed + loads")
        ftt.viz.mpl.plot_truss(ax1, nodes, members, displacement=u_nl, member_forces=mf)
        ax1.set_title("deformed (nonlinear), colored by axial force")
        plt.show()
    return u_nl, stats


if __name__ == "__main__":
    main()
