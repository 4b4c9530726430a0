"""Plain hex8 stiffness for the benchmark's correctness check.

A frozen, independent statement of the element the configurations use:
8-node trilinear hexahedra, 2x2x2 Gauss quadrature, linear isotropic
elasticity with engineering shear strain, nodes ordered bottom face
counter-clockwise then top face counter-clockwise. It imports torch and
NumPy only, and nothing of the program under test: the check works K out
again from the mesh arrays the benchmark made, never from what the
program built.
"""
from __future__ import annotations

import numpy as np
import torch

# natural coordinates of the 8 corners; the 2x2x2 Gauss points are these
# scaled by 1/sqrt(3), each of weight 1
SIGNS = np.array([[-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1],
                  [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1]], np.float64)

# elements per block of the K apply: a block's element matrices take
# BLOCK x 24 x 24 values
BLOCK = 1 << 15


def natural_gradients() -> np.ndarray:
    """dN_a / d xi_d at the 8 Gauss points, (8, 3, 8)."""
    pts = SIGNS / np.sqrt(3.0)
    out = np.empty((8, 3, 8))
    for q, p in enumerate(pts):
        f = 1.0 + p[None, :] * SIGNS  # (8 nodes, 3 axes)
        for d in range(3):
            others = [e for e in range(3) if e != d]
            out[q, d] = SIGNS[:, d] / 8.0 * f[:, others[0]] * f[:, others[1]]
    return out


def elasticity(E: float, nu: float) -> np.ndarray:
    """6 x 6 isotropic elasticity in Voigt order (xx, yy, zz, xy, yz, zx)."""
    lam = E * nu / ((1.0 + nu) * (1.0 - 2.0 * nu))
    mu = E / (2.0 * (1.0 + nu))
    C = np.zeros((6, 6))
    C[:3, :3] = lam
    C[range(3), range(3)] = lam + 2.0 * mu
    C[range(3, 6), range(3, 6)] = mu
    return C


def element_stiffness(xe: torch.Tensor, E: float, nu: float) -> torch.Tensor:
    """Ke of each element, (B, 24, 24), from its corner coordinates
    ``xe`` (B, 8, 3), in ``xe``'s dtype."""
    dt, dev = xe.dtype, xe.device
    dN = torch.as_tensor(natural_gradients(), dtype=dt, device=dev)  # (8q, 3, 8)
    C = torch.as_tensor(elasticity(E, nu), dtype=dt, device=dev)
    J = torch.einsum("qda,baj->bqdj", dN, xe)  # (B, 8q, 3, 3)
    det = torch.linalg.det(J)
    dx = torch.linalg.solve(J, dN.expand(xe.shape[0], -1, -1, -1))  # (B, q, 3, 8): d N_a / d x_j
    Bm = torch.zeros(xe.shape[0], 8, 6, 24, dtype=dt, device=dev)
    gx, gy, gz = dx[:, :, 0], dx[:, :, 1], dx[:, :, 2]
    Bm[:, :, 0, 0::3] = gx
    Bm[:, :, 1, 1::3] = gy
    Bm[:, :, 2, 2::3] = gz
    Bm[:, :, 3, 0::3] = gy
    Bm[:, :, 3, 1::3] = gx
    Bm[:, :, 4, 1::3] = gz
    Bm[:, :, 4, 2::3] = gy
    Bm[:, :, 5, 0::3] = gz
    Bm[:, :, 5, 2::3] = gx
    return torch.einsum("bqki,kl,bqlj,bq->bij", Bm, C, Bm, det)


def stiffness_apply(nodes: torch.Tensor, elements: torch.Tensor, E: float, nu: float,
                    u: torch.Tensor) -> torch.Tensor:
    """K u for each of the k fields ``u`` (k, N, 3), over all DOFs, in
    ``u``'s dtype: element matrices in blocks of BLOCK elements, gathered
    and scattered by node index."""
    k, n = u.shape[0], u.shape[1]
    nodes = nodes.to(u.dtype)
    out = torch.zeros(k, n, 3, dtype=u.dtype, device=u.device)
    for lo in range(0, elements.shape[0], BLOCK):
        el = elements[lo:lo + BLOCK]
        ke = element_stiffness(nodes[el], E, nu)  # (B, 24, 24)
        ue = u[:, el].reshape(k, el.shape[0], 24)
        fe = torch.einsum("bij,kbj->kbi", ke, ue).reshape(k, el.shape[0] * 8, 3)
        out.index_add_(1, el.reshape(-1), fe)
    return out


def stiffness_diagonal(nodes: torch.Tensor, elements: torch.Tensor, E: float, nu: float,
                       dtype: torch.dtype) -> torch.Tensor:
    """diag(K) as (N, 3) in ``dtype``, element matrices in ``dtype``."""
    nodes = nodes.to(dtype)
    out = torch.zeros(nodes.shape[0], 3, dtype=dtype, device=nodes.device)
    for lo in range(0, elements.shape[0], BLOCK):
        el = elements[lo:lo + BLOCK]
        d = torch.diagonal(element_stiffness(nodes[el], E, nu), dim1=1, dim2=2)  # (B, 24)
        out.index_add_(0, el.reshape(-1), d.reshape(-1, 3))
    return out
