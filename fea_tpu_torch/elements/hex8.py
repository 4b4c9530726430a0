"""8-node trilinear hexahedral solid element: the one-element stiffness.

The voxel route needs exactly one reference Ke, integrated on the host in
NumPy f64: 2x2x2 Gauss quadrature, isotropic 3D elasticity, engineering
shear strain in Voigt order (xx, yy, zz, xy, yz, zx), node order bottom
face CCW then top face CCW. Counterpart of the NumPy part of
``fea_tpu/elements/hex8.py``.
"""
from __future__ import annotations

import numpy as np

from ..materials import Material

__all__ = ["CORNER_SIGNS", "natural_gradients", "stiffness_matrix_np"]

# Natural coordinates (xi, eta, zeta) of the 8 corners; row a is node a.
CORNER_SIGNS = np.array(
    [
        [-1, -1, -1],
        [+1, -1, -1],
        [+1, +1, -1],
        [-1, +1, -1],
        [-1, -1, +1],
        [+1, -1, +1],
        [+1, +1, +1],
        [-1, +1, +1],
    ],
    dtype=np.float64,
)

# 2x2x2 Gauss points: the corner pattern scaled to +-1/sqrt(3), weight 1.
_GAUSS_POINTS = CORNER_SIGNS / np.sqrt(3.0)


def natural_gradients(points: np.ndarray | None = None) -> np.ndarray:
    """dN_a/d(xi_d) evaluated at quadrature points: (Q, 3, 8) table.

    N_a(x) = (1/8) prod_d (1 + x_d * s_{a,d}), so
    dN_a/dx_d = (s_{a,d}/8) * prod_{d' != d} (1 + x_{d'} * s_{a,d'}).
    """
    pts = _GAUSS_POINTS if points is None else np.atleast_2d(points)
    Q = pts.shape[0]
    terms = 1.0 + pts[:, None, :] * CORNER_SIGNS[None, :, :]  # (Q, 8, 3)
    D = np.empty((Q, 3, 8), dtype=np.float64)
    for d in range(3):
        others = [d2 for d2 in range(3) if d2 != d]
        D[:, d, :] = CORNER_SIGNS[None, :, d] / 8.0 * terms[:, :, others[0]] * terms[:, :, others[1]]
    return D


_D_QP = natural_gradients()  # (8, 3, 8) at the Gauss points


def stiffness_matrix_np(corners: np.ndarray, material: Material) -> np.ndarray:
    """Host NumPy (f64) stiffness of ONE hex8 element, (24, 24).

    ``corners`` (8, 3) in the element's local node order.
    """
    X = np.asarray(corners, np.float64)  # (8, 3)
    E = float(material.E)
    nu = float(material.nu)
    lam = E * nu / ((1.0 + nu) * (1.0 - 2.0 * nu))
    mu = E / (2.0 * (1.0 + nu))
    C = np.zeros((6, 6))
    C[:3, :3] = lam
    C[np.arange(3), np.arange(3)] = lam + 2.0 * mu
    C[np.arange(3, 6), np.arange(3, 6)] = mu
    D = _D_QP  # (Q, 3, 8)
    ke = np.zeros((24, 24))
    for q in range(D.shape[0]):
        J = D[q] @ X  # (3, 3)
        detj = np.linalg.det(J)
        G = np.linalg.solve(J, D[q])  # (3, 8) global gradients
        B = np.zeros((6, 8, 3))
        gx, gy, gz = G[0], G[1], G[2]
        B[0, :, 0] = gx
        B[1, :, 1] = gy
        B[2, :, 2] = gz
        B[3, :, 0] = gy
        B[3, :, 1] = gx
        B[4, :, 1] = gz
        B[4, :, 2] = gy
        B[5, :, 0] = gz
        B[5, :, 2] = gx
        Bq = B.reshape(6, 24)
        ke += detj * (Bq.T @ C @ Bq)
    return ke
