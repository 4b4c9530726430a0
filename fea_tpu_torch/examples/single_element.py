"""Single-hex8 forward / inverse round trip. Forward: impose a -0.1 z
shear on the top face of a 2x2x2 cube and compute the nodal forces
f = Ke u. Inverse: fix the bottom face, apply those forces and solve for
the displacements, which must give back the imposed shear. Twin of
``examples/single_element.py``.

    python -m fea_tpu_torch.examples.single_element [--device cpu] [--show]
"""
from __future__ import annotations

import numpy as np
import torch

import fea_tpu_torch as ftt
from fea_tpu_torch.elements import hex8

from ._cli import parse

UNIT_CUBE = np.array(
    [
        [-1, -1, -1], [+1, -1, -1], [+1, +1, -1], [-1, +1, -1],
        [-1, -1, +1], [+1, -1, +1], [+1, +1, +1], [-1, +1, +1],
    ],
    dtype=float,
)


def forward(material: ftt.Material):
    """Impose u (top-face shear) -> nodal forces f = Ke u (E = 1000,
    nu = 0)."""
    ke = hex8.stiffness_matrices(torch.as_tensor(UNIT_CUBE), torch.arange(8)[None], material)[0]
    displacements = np.zeros((8, 3))
    displacements[4:] += np.array([0.0, 0.0, -0.1])  # shear the top face
    forces = (ke.numpy() @ displacements.reshape(-1)).reshape(-1, 3)
    return displacements, forces


def inverse(material: ftt.Material, forces: np.ndarray, device):
    """Fix the bottom face, apply f, solve for u (``solve``, dense)."""
    elements = np.arange(8, dtype=np.int64)[None]
    fixed = np.zeros((8, 3), dtype=np.int64)
    fixed[:4] = 1  # bottom face fully constrained
    scene = ftt.make_scene(UNIT_CUBE, elements, fixed, forces, material, dtype=torch.float64, device=device)
    sol = ftt.solve(scene, method="dense")
    return sol.displacements.cpu().numpy()


def main(argv=None):
    args = parse(__doc__.splitlines()[0], argv)
    material = ftt.Material(E=1000.0, nu=0.0)
    u_imposed, forces = forward(material)
    print("imposed displacements\n", u_imposed)
    print("forces = Ke @ u\n", forces)

    u_solved = inverse(material, forces, args.device)
    print("recovered displacements\n", u_solved)

    # there and back again: the free (top) nodes recover the imposed shear
    err = np.abs(u_solved[4:] - u_imposed[4:]).max()
    print(f"round-trip max |u_solved - u_imposed| on free nodes = {err:.3e}")
    assert err < 1e-9, "round trip failed"

    if args.show:
        import matplotlib.pyplot as plt

        from fea_tpu_torch.viz.mpl import plot_forces, plot_hex_elements

        fig = plt.figure()
        ax = fig.add_subplot(111, projection="3d")
        hexes = np.arange(8, dtype=np.int64)[None]
        plot_hex_elements(ax, UNIT_CUBE, hexes, wireframe=True)
        plot_hex_elements(ax, UNIT_CUBE + u_solved, hexes)
        plot_forces(ax, UNIT_CUBE + u_solved, forces)
        ax.set_xlabel("X"), ax.set_ylabel("Y"), ax.set_zlabel("Z")
        plt.axis("scaled")
        plt.show()
    return err


if __name__ == "__main__":
    main()
