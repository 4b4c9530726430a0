"""Hollow-tube hex8 cantilever: a 26-segment annulus (4 in outer, 3.9 in
inner radius) extruded to 50 node layers (1,274 elements, 7,800 DOF), a
cosine-distributed downward load on the lower outer surface, the root
fixed; prints the solve record, reactions in lbf and displacements in
inch. Twin of ``examples/tube.py``, solved in f64 where the JAX demo's
scene is f32 (see ``cubebeam``).

    python -m fea_tpu_torch.examples.tube [--device cpu] [--show] [--layers N]
"""
from __future__ import annotations

import numpy as np
import torch

import fea_tpu_torch as ftt
from fea_tpu_torch.materials import units

from ._cli import parse


def main(argv=None):
    args = parse(__doc__.splitlines()[0], argv, layers=(int, 50))
    n_seg = 26
    outer = 4 * units.inch
    nodes2d, quads = ftt.mesh.annulus_section(n_seg, 3.9 * units.inch, outer)

    forces2d = np.zeros_like(nodes2d)
    sel = slice(n_seg, (3 * n_seg) // 2)
    forces2d[sel, 1] = -np.cos(np.pi / 2 * nodes2d[sel, 0] / outer) * np.pi / 4 / outer

    nodes, elements = ftt.mesh.extrude_quads(nodes2d, quads, np.linspace(0.0, 1.0, args.layers))
    loads = np.zeros_like(nodes)
    loads[:, :2] = np.tile(forces2d, (args.layers, 1))

    fixed = ftt.fix_where(nodes, lambda p: p[:, 2] == 0.0, 3)
    scene = ftt.make_scene(nodes, elements, fixed, loads, ftt.Material(E=10_000_000 * units.psi, nu=0.3),
                           dtype=torch.float64, device=args.device)

    with ftt.utils.Timer() as timer:
        sol = timer.set_result(ftt.solve(scene, method="cg", tol=1e-8))
    print(ftt.utils.record_solve(scene, sol.stats, timer.elapsed).to_json())

    u = sol.displacements.cpu().numpy()
    with np.printoptions(precision=5, linewidth=200, suppress=True):
        print("forces / lbf:\n", sol.reactions.cpu().numpy() / units.lbf)
        print("displacements / inch:\n", u / units.inch)

    if args.show:
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
            ftt.viz.mpl.plot_hex_elements(ax, nodes + u * 100, elements, scalars=mags)
            plt.show()
    return sol


if __name__ == "__main__":
    main()
