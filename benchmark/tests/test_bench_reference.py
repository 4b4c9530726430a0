"""The plain reference's hex8 K: properties any correct trilinear element
has (symmetry, six rigid-body modes, the patch test's exact constant
strain, distorted elements included), and its blocked K apply against a
dense assembly."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.meshes import box
from benchmark.reference import hex8

torch.set_num_threads(1)
E, NU = 68947600000.0, 0.3


def _mesh(distortion: float):
    cfg = dict(cells=[2, 3, 4], size=[0.1, 0.1, 1.0], distortion=distortion)
    m = box.build(cfg, np.random.default_rng(5))
    return torch.as_tensor(m["nodes"]), torch.as_tensor(m["elements"])


def _dense(nodes, elements):
    n = nodes.shape[0] * 3
    K = np.zeros((n, n))
    ke = hex8.element_stiffness(nodes[elements], E, NU).numpy()
    for e, el in enumerate(elements.numpy()):
        dofs = (3 * el[:, None] + np.arange(3)).ravel()
        K[np.ix_(dofs, dofs)] += ke[e]
    return K


@pytest.mark.parametrize("distortion", [0.0, 0.25])
def test_element_symmetric_with_six_rigid_modes(distortion):
    nodes, elements = _mesh(distortion)
    ke = hex8.element_stiffness(nodes[elements], E, NU).numpy()
    assert np.abs(ke - ke.transpose(0, 2, 1)).max() <= 1e-12 * np.abs(ke).max()
    ev = np.linalg.eigvalsh(ke)
    assert (np.abs(ev[:, :6]) <= 1e-10 * ev[:, -1:]).all() and (ev[:, 6:] > 1e-6 * ev[:, -1:]).all()


@pytest.mark.parametrize("distortion", [0.0, 0.25])
def test_patch_test_constant_strain(distortion):
    """u = A x gives zero force at every node inside the grid, and (on the
    undistorted box) the strain energy of the constant strain over its
    volume."""
    nodes, elements = _mesh(distortion)
    grid = _mesh(0.0)[0].numpy()
    A = np.array([[1e-3, 2e-4, -3e-4], [5e-4, -2e-3, 1e-4], [-1e-4, 3e-4, 7e-4]])
    u = nodes.numpy() @ A.T
    f = hex8.stiffness_apply(nodes, elements, E, NU, torch.as_tensor(u)[None])[0].numpy()
    x = grid
    interior = (x[:, 0] > 1e-12) & (x[:, 0] < 0.1 - 1e-12) & (x[:, 1] > 1e-12) & (x[:, 1] < 0.1 - 1e-12) \
        & (x[:, 2] > 1e-12) & (x[:, 2] < 1.0 - 1e-12)
    assert interior.any()
    assert np.abs(f[interior]).max() <= 1e-9 * np.abs(f).max()
    eps = 0.5 * (A + A.T)
    voigt = np.array([eps[0, 0], eps[1, 1], eps[2, 2], 2 * eps[0, 1], 2 * eps[1, 2], 2 * eps[2, 0]])
    if distortion == 0.0:
        energy = 0.1 * 0.1 * 1.0 * voigt @ hex8.elasticity(E, NU) @ voigt
        assert float((u * f).sum()) == pytest.approx(energy, rel=1e-10)


def test_apply_matches_dense_assembly():
    nodes, elements = _mesh(0.25)
    u = torch.as_tensor(np.random.default_rng(1).standard_normal((2,) + tuple(nodes.shape)))
    got = hex8.stiffness_apply(nodes, elements, E, NU, u).numpy().reshape(2, -1)
    want = u.numpy().reshape(2, -1) @ _dense(nodes, elements).T
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    d = hex8.stiffness_diagonal(nodes, elements, E, NU, torch.float64).numpy().ravel()
    assert np.allclose(d, np.diag(_dense(nodes, elements)), rtol=1e-13)
