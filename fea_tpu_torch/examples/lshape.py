"""L-shaped bracket: a box-subset topology end to end. The L-domain's
connectivity is not a box grid, so every full-grid detector and the
renumbering detector reject it; it is a subset of one, so it is embedded
in its bounding box (exactly-zero weights in the void) and solved by the
curvilinear route (K4/K5 on the card), then held against a dense solve.
Twin of ``examples/lshape.py``.

    python -m fea_tpu_torch.examples.lshape [--device cpu] [--show]
"""
from __future__ import annotations

import numpy as np
import torch

import fea_tpu_torch as ftt
from fea_tpu_torch.ops.canonical import infer_renumbered_grid, infer_subgrid_embedding
from fea_tpu_torch.solve.embed import build_subgrid_embedded, solve_subgrid_embedded

from ._cli import parse


def main(argv=None):
    args = parse(__doc__.splitlines()[0], argv)
    nx, nz = 6, 18
    lz = 0.1 * nz / nx
    nodes, elements = ftt.mesh.l_hex_mesh(nx, nx, nz, 0.1, 0.1, lz)
    nodes = np.asarray(nodes, np.float64)
    # distort the interior so no voxel shortcut applies
    rng = np.random.default_rng(11)
    interior = (nodes[:, 2] > 1e-12) & (nodes[:, 2] < lz - 1e-12)
    nodes += 0.15 * (0.1 / nx) * rng.uniform(-1, 1, nodes.shape) * interior[:, None]

    fixed = ftt.fix_where(nodes, lambda q: np.isclose(q[:, 2], 0.0), 3)
    loads = np.zeros_like(nodes)
    tip = np.isclose(nodes[:, 2], lz)
    loads[tip, 1] = 50.0 / tip.sum()

    scene = ftt.make_scene(nodes, np.asarray(elements), fixed, loads,
                           ftt.Material(E=10_000_000 * ftt.units.psi, nu=0.3), dtype=torch.float64,
                           device=args.device)
    print(f"L-domain: {scene.n_dof} DOF, {scene.n_elements} elements "
          "(connectivity defeats every full-grid detector)")

    assert infer_renumbered_grid(scene) is None
    det = infer_subgrid_embedding(scene)
    dims, lat, valid = det
    print(f"subgrid embedding detected: box {dims}, "
          f"{int(valid.sum())}/{valid.size} cells present")

    built = build_subgrid_embedded(scene, det)
    sol = solve_subgrid_embedded(scene, built, tol=1e-9)
    u = sol.displacements.cpu().numpy()
    print(f"solved: {int(sol.stats.iterations)} iterations, rel. residual "
          f"{float(sol.stats.relative_residual):.2e}, "
          f"max |u| = {np.abs(u).max():.4e} m")

    # cross-check against the element-gather dense oracle
    u_d = ftt.solve(scene, method="dense").displacements.cpu().numpy()
    rel = np.abs(u - u_d).max() / np.abs(u_d).max()
    print(f"vs dense oracle: max relative error {rel:.2e}")
    assert rel < 1e-7

    if args.show:
        import matplotlib.pyplot as plt

        from fea_tpu_torch.viz.mpl import plot_hex_elements

        fig = plt.figure()
        ax = fig.add_subplot(projection="3d")
        el = scene.host_elements
        mags = np.linalg.norm(u, axis=1)[el].mean(axis=1)
        plot_hex_elements(ax, nodes + 200.0 * u, el, scalars=mags)
        plt.show()
    return sol


if __name__ == "__main__":
    main()
