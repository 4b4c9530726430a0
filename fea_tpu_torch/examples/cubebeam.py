"""Square-section hex8 cantilever, the reference's main demo: 4x4x49 = 784
hex8 elements, E = 10^7 psi, nu = 0.3, +y load on the y = 0 face; prints
the solve record, reactions in lbf and displacements in inch, and max |u|
against the anchor 3.0504e-4 m, then renders the deformed mesh (x100)
with ``--show``. Twin of ``examples/cubebeam.py``, solved in f64 (K7 f64
on the card) where the JAX demo's scene is f32: the port reports the
true residual, and an f32 apply's true residual floors at ~3e-2 here.

    python -m fea_tpu_torch.examples.cubebeam [--device cpu] [--show]
"""
from __future__ import annotations

import time

import numpy as np
import torch

import fea_tpu_torch as ftt
from fea_tpu_torch.materials import units

from ._cli import parse


def main(argv=None):
    args = parse(__doc__.splitlines()[0], argv)
    nodes, elements = ftt.mesh.box_hex_mesh(4, 4, 49, 0.1, 0.1, 1.0)

    linear_load = 100.0 * units.lbf / units.ft
    total_load = linear_load * 1.0
    force_per_node = total_load / ((4 + 1) * (50 + 1))
    loads = np.zeros_like(nodes)
    loads[nodes[:, 1] == 0.0, 1] += force_per_node

    fixed = ftt.fix_where(nodes, lambda p: p[:, 2] == 0.0, 3)
    scene = ftt.make_scene(nodes, elements, fixed, loads, ftt.Material(E=10_000_000 * units.psi, nu=0.3),
                           dtype=torch.float64, device=args.device)

    with ftt.utils.Timer() as timer:
        sol = timer.set_result(ftt.solve(scene, method="cg", tol=1e-8))
    rec = ftt.utils.record_solve(scene, sol.stats, timer.elapsed, method="cg")
    print(rec.to_json())

    u = sol.displacements.cpu().numpy()
    r = sol.reactions.cpu().numpy()
    with np.printoptions(precision=5, linewidth=200, suppress=True):
        print("forces / lbf:\n", r / units.lbf)
        print("displacements / inch:\n", u / units.inch)
    print("max |u| =", np.abs(u).max(), "m  (reference anchor: 3.0504e-4)")

    if args.show:
        displaced = nodes + u * 100
        if ftt.viz.HAS_PYVISTA:
            import pyvista as pv

            plotter = pv.Plotter()
            ftt.viz.pv.plot_deformed_overlay(plotter, nodes, elements, u, scale=100)
            plotter.show()
        else:
            import matplotlib.pyplot as plt

            fig = plt.figure()
            ax = fig.add_subplot(111, projection="3d")
            ftt.viz.mpl.plot_hex_elements(ax, nodes, elements, wireframe=True)
            mags = np.linalg.norm(u, axis=1)[elements].mean(axis=1)
            ftt.viz.mpl.plot_hex_elements(ax, displaced, elements, scalars=mags)
            plt.show()
    return sol


if __name__ == "__main__":
    main()
