"""8-node trilinear hexahedral solid element stiffness.

2x2x2 Gauss quadrature, isotropic 3D elasticity, engineering shear strain
in Voigt order (xx, yy, zz, xy, yz, zx), node order bottom face CCW then
top face CCW. The voxel route needs exactly one reference Ke
(:func:`stiffness_matrix_np`); the curvilinear route integrates every
element, in chunks on the device (:func:`batched_ke`). Counterpart of
``fea_tpu/elements/hex8.py``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..materials import Material, lame_parameters

__all__ = ["CORNER_SIGNS", "batched_ke", "natural_gradients", "stiffness_matrix_np"]

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


def _b_matrices(G: torch.Tensor) -> torch.Tensor:
    """(..., 6, 24) strain-displacement matrices from global gradients
    G (..., 3, 8), in the column order 3 * node + component."""
    B = G.new_zeros(G.shape[:-2] + (6, 8, 3))
    gx, gy, gz = G[..., 0, :], G[..., 1, :], G[..., 2, :]
    B[..., 0, :, 0] = gx
    B[..., 1, :, 1] = gy
    B[..., 2, :, 2] = gz
    B[..., 3, :, 0] = gy
    B[..., 3, :, 1] = gx
    B[..., 4, :, 1] = gz
    B[..., 4, :, 2] = gy
    B[..., 5, :, 0] = gz
    B[..., 5, :, 2] = gx
    return B.reshape(G.shape[:-2] + (6, 24))


def _c_matrix_np(material: Material) -> np.ndarray:
    lam, mu = lame_parameters(material)
    C = np.zeros((6, 6))
    C[:3, :3] = lam
    C[np.arange(3), np.arange(3)] += 2.0 * mu
    C[np.arange(3, 6), np.arange(3, 6)] = mu
    return C


def batched_ke(xe: torch.Tensor, material: Material) -> tuple[torch.Tensor, torch.Tensor]:
    """Stiffness of a chunk of elements on xe's device, in xe's dtype.

    ``xe`` (E, 8, 3) corner coordinates in the element's node order.
    Returns the (E, 24, 24) Ke batch, sum_q detJ B^T C B, and the minimum
    detJ over the chunk's quadrature points as a 0-d tensor (the caller
    checks it once per assembly). Counterpart of
    ``fea_tpu/elements/hex8.py::precompute_geometry`` followed by
    ``stiffness_from_geometry``.
    """
    D = torch.as_tensor(_D_QP, dtype=xe.dtype, device=xe.device)  # (Q, 3, 8)
    J = torch.einsum("qda,ean->eqdn", D, xe)  # (E, Q, 3, 3)
    detj = torch.linalg.det(J)
    G = torch.linalg.solve(J, D.expand(J.shape[:2] + D.shape[1:]))  # (E, Q, 3, 8)
    B = _b_matrices(G)
    C = torch.as_tensor(_c_matrix_np(material), dtype=xe.dtype, device=xe.device)
    CB = torch.matmul(C, B) * detj[..., None, None]  # (E, Q, 6, 24)
    ke = torch.einsum("eqia,eqib->eab", B, CB)
    return ke, detj.min()
