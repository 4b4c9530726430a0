"""A distorted (unstructured) hex8 cantilever: every interior node moved,
so no grid route takes it. Prints the iterations of scalar Jacobi,
block-Jacobi, the additive two-level and the Chebyshev two-level
preconditioner (flexible CG, f32 smoothing) on the same scene, and holds
the two-level solution against a dense solve. Twin of
``examples/unstructured.py``.

    python -m fea_tpu_torch.examples.unstructured [--device cpu] [--show]
"""
from __future__ import annotations

import numpy as np
import torch

import fea_tpu_torch as ftt
from fea_tpu_torch.ops.twolevel import build_two_level, build_two_level_cheb
from fea_tpu_torch.solvers.cg import fpcg, pcg

from ._cli import parse


def main(argv=None):
    args = parse(__doc__.splitlines()[0], argv)
    nx, ny, nz = 4, 4, 30
    nodes, elements = ftt.mesh.box_hex_mesh(nx, ny, nz, 0.1, 0.1, 1.0)
    rng = np.random.default_rng(7)
    h = 0.1 / nx
    interior = (nodes[:, 2] > 0) & (nodes[:, 2] < 1.0)
    nodes = nodes + 0.25 * h * rng.uniform(-1, 1, nodes.shape) * interior[:, None]

    fixed = ftt.fix_where(nodes, lambda p: np.isclose(p[:, 2], 0.0), dofs_per_node=3)
    loads = np.zeros_like(nodes)
    tip = np.isclose(nodes[:, 2], 1.0)
    loads[tip, 1] = 100.0 / tip.sum()

    scene = ftt.make_scene(nodes, elements, fixed, loads, ftt.Material(E=1e7, nu=0.3), dtype=torch.float64,
                           device=args.device)
    op = ftt.build_operator(scene, dtype=torch.float64)
    zero = torch.zeros_like(scene.loads)
    b = op.rhs(scene.loads, zero)

    print(f"{scene.n_dof} DOF, {elements.shape[0]} distorted hex8 elements "
          f"(min detJ = {float(op.geom.min_detj):.3e} > 0)")

    sol_j = ftt.solve_operator(op, scene.loads, zero, method="cg", tol=1e-8, max_iters=50_000, precondition=True)
    sol_b = ftt.solve_operator(op, scene.loads, zero, method="cg", tol=1e-8, max_iters=50_000,
                               precondition="block")
    tl = build_two_level(op, scene.host_nodes)
    u_add, stats_add = pcg(op.apply, b, precond=tl, tol=1e-8, max_iters=50_000)
    # the route solve() takes: f64 flexible CG, smoothing and coarse work in f32
    tlc = build_two_level_cheb(op, scene.host_nodes)
    u, stats = fpcg(op.apply, b, precond=tlc, tol=1e-8, max_iters=50_000)

    print(f"scalar Jacobi : {int(sol_j.stats.iterations):5d} iterations")
    print(f"block-Jacobi  : {int(sol_b.stats.iterations):5d} iterations")
    print(f"two-level     : {int(stats_add.iterations):5d} iterations ({tl.n_aggs} aggregates)")
    print(f"cheb two-level: {int(stats.iterations):5d} iterations "
          f"(fpcg, f32 smoothing, rel. residual {float(stats.relative_residual):.2e})")

    u_d = ftt.solve_operator(op, scene.loads, zero, method="dense").displacements
    err = float((u - u_d).abs().max() / u_d.abs().max())
    print(f"cheb two-level vs dense solve: max relative error {err:.2e}")
    assert err < 1e-6
    err_add = float((u_add - u).abs().max() / u.abs().max())
    print(f"additive vs cheb two-level agreement: {err_add:.2e}")
    assert err_add < 1e-6

    if args.show:
        u_np = u.cpu().numpy()
        if ftt.viz.HAS_PYVISTA:
            import pyvista as pv

            plotter = pv.Plotter()
            ftt.viz.pv.plot_deformed_overlay(plotter, nodes, elements, u_np, scale=100)
            plotter.show()
        else:
            import matplotlib.pyplot as plt

            fig = plt.figure()
            ax = fig.add_subplot(111, projection="3d")
            ftt.viz.mpl.plot_hex_elements(ax, nodes, elements, wireframe=True)
            mags = np.linalg.norm(u_np, axis=1)
            ftt.viz.mpl.plot_hex_elements(ax, nodes + 100 * u_np, elements, scalars=mags)
            plt.show()
    return u


if __name__ == "__main__":
    main()
