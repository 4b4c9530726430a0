"""Fixed-fixed Euler-Bernoulli beam under a uniform load: E = 210 GPa,
I = 1e-6 m^4, L = 1 m, q = 1 kN/m, 100 elements; prints the midspan
deflection against qL^4/384EI and the end moment against qL^2/12, and
plots displacement, moment and shear with ``--show``. Twin of
``examples/euler_bernoulli.py``.

    python -m fea_tpu_torch.examples.euler_bernoulli [--device cpu] [--show]
"""
from __future__ import annotations

import numpy as np
import torch

import fea_tpu_torch as ftt
from fea_tpu_torch.elements import beam

from ._cli import parse

E, I, L, q = 210e9, 1e-6, 1.0, 1000.0
N_ELEM = 100


def main(argv=None):
    args = parse(__doc__.splitlines()[0], argv)
    x = np.linspace(0.0, L, N_ELEM + 1)[:, None]
    elements = np.stack([np.arange(N_ELEM), np.arange(N_ELEM) + 1], axis=1)

    # consistent nodal load for uniform q (assembled from the element rule)
    fe = beam.uniform_load_vector(torch.as_tensor(x), torch.as_tensor(elements), q).numpy()
    loads = np.zeros((N_ELEM + 1, 2))
    dof = (elements[:, :, None] * 2 + np.arange(2)[None, None, :]).reshape(-1)
    np.add.at(loads.reshape(-1), dof, fe.reshape(-1))

    fixed = np.zeros((N_ELEM + 1, 2), dtype=bool)
    fixed[0] = fixed[-1] = True

    scene = ftt.make_scene(x, elements, fixed, loads, ftt.Material(E, 0.0), family="eb_beam",
                           section=np.float64(I), dtype=torch.float64, device=args.device)
    sol = ftt.solve(scene, method="dense")
    w = sol.displacements.cpu().numpy()[:, 0]

    exact = q * L**4 / (384 * E * I)
    print(f"midspan deflection: {w[N_ELEM // 2]:.9e} m")
    print(f"closed form qL^4/384EI: {exact:.9e} m")
    print(f"relative error: {abs(w[N_ELEM // 2] - exact) / exact:.2e}")

    M0, M1, V = (a.cpu().numpy() for a in ftt.post.beam_moment_shear(scene, sol.displacements))
    print("end moment (exact qL^2/12 = {:.1f}):".format(q * L**2 / 12), M0[0])

    if args.show:
        import matplotlib.pyplot as plt

        ftt.viz.mpl.plot_beam_results(x, w, M0, V)
        plt.show()
    return sol


if __name__ == "__main__":
    main()
