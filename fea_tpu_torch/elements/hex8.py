"""8-node trilinear hexahedral solid element stiffness.

2x2x2 Gauss quadrature, isotropic 3D elasticity, engineering shear strain
in Voigt order (xx, yy, zz, xy, yz, zx), node order bottom face CCW then
top face CCW. The voxel route needs exactly one reference Ke
(:func:`stiffness_matrix_np`); the curvilinear route integrates every
element, on the CPU in chunks (:func:`batched_ke`) and on the card in its
assembly kernel (``csrc/curv_weights.cu``, at this module's Gauss points); the
element-by-element operator precomputes the quadrature geometry of every
element (:func:`precompute_geometry`) and applies, diagonalizes or
integrates Ke from it. Counterpart of ``fea_tpu/elements/hex8.py``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..materials import Material, elasticity_matrix, lame_parameters

__all__ = [
    "CORNER_SIGNS",
    "Hex8Geometry",
    "apply_elements",
    "batched_ke",
    "block_diagonal",
    "centroid_strain_stress",
    "diagonal",
    "natural_gradients",
    "precompute_geometry",
    "stiffness_from_geometry",
    "stiffness_matrices",
    "stiffness_matrix_np",
    "von_mises",
]

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
_D_CENTROID = natural_gradients(np.zeros((1, 3)))  # (1, 3, 8) at xi = 0


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


def batched_ke(xe: torch.Tensor, material: Material) -> tuple[torch.Tensor, torch.Tensor]:
    """Stiffness of a chunk of elements on xe's device, in xe's dtype.

    ``xe`` (E, 8, 3) corner coordinates in the element's node order.
    Returns the (E, 24, 24) Ke batch, sum_q detJ B^T C B, and each
    element's minimum detJ over its quadrature points, (E,) (the caller
    checks the least once per assembly). The Jacobians are inverted in
    closed form, so a degenerate element gives inf or NaN entries rather
    than an error. Counterpart of
    ``fea_tpu/elements/hex8.py::precompute_geometry`` followed by
    ``stiffness_from_geometry``.
    """
    G, detj = _gradients(xe, _D_QP)
    return stiffness_from_geometry(Hex8Geometry(grads=G, wdetj=detj, min_detj=detj.min()), material), detj.amin(dim=1)


# Jacobians are inverted in closed form: the first batched torch.linalg
# call of a process costs about a second on the card.
def _det3(J: torch.Tensor) -> torch.Tensor:
    """Determinant of (..., 3, 3) by cofactor expansion."""
    return (
        J[..., 0, 0] * (J[..., 1, 1] * J[..., 2, 2] - J[..., 1, 2] * J[..., 2, 1])
        - J[..., 0, 1] * (J[..., 1, 0] * J[..., 2, 2] - J[..., 1, 2] * J[..., 2, 0])
        + J[..., 0, 2] * (J[..., 1, 0] * J[..., 2, 1] - J[..., 1, 1] * J[..., 2, 0])
    )


def _inv3(J: torch.Tensor, det: torch.Tensor) -> torch.Tensor:
    """Inverse of (..., 3, 3) as adjugate / det."""
    adj = torch.stack(
        [
            torch.stack([
                J[..., 1, 1] * J[..., 2, 2] - J[..., 1, 2] * J[..., 2, 1],
                J[..., 0, 2] * J[..., 2, 1] - J[..., 0, 1] * J[..., 2, 2],
                J[..., 0, 1] * J[..., 1, 2] - J[..., 0, 2] * J[..., 1, 1],
            ], dim=-1),
            torch.stack([
                J[..., 1, 2] * J[..., 2, 0] - J[..., 1, 0] * J[..., 2, 2],
                J[..., 0, 0] * J[..., 2, 2] - J[..., 0, 2] * J[..., 2, 0],
                J[..., 0, 2] * J[..., 1, 0] - J[..., 0, 0] * J[..., 1, 2],
            ], dim=-1),
            torch.stack([
                J[..., 1, 0] * J[..., 2, 1] - J[..., 1, 1] * J[..., 2, 0],
                J[..., 0, 1] * J[..., 2, 0] - J[..., 0, 0] * J[..., 2, 1],
                J[..., 0, 0] * J[..., 1, 1] - J[..., 0, 1] * J[..., 1, 0],
            ], dim=-1),
        ],
        dim=-2,
    )
    return adj / det[..., None, None]


@dataclasses.dataclass(frozen=True)
class Hex8Geometry:
    """Precomputed per-element quadrature geometry.

    grads:    (E, Q, 3, 8) global shape-function gradients J^-1 @ D
    wdetj:    (E, Q) quadrature weight * |J| (the weights are 1 for 2x2x2)
    min_detj: () the smallest detJ; the caller raises when it is <= 0
    """

    grads: torch.Tensor
    wdetj: torch.Tensor
    min_detj: torch.Tensor

    def astype(self, dtype: torch.dtype) -> "Hex8Geometry":
        return Hex8Geometry(self.grads.to(dtype), self.wdetj.to(dtype), self.min_detj.to(dtype))


def _gradients(X: torch.Tensor, D_np: np.ndarray) -> tuple[torch.Tensor, torch.Tensor]:
    """(global gradients (E, Q, 3, 8), detJ (E, Q)) of corner coordinates
    X (E, 8, 3) at the natural-gradient table D_np (Q, 3, 8)."""
    D = torch.as_tensor(D_np, dtype=X.dtype, device=X.device)
    J = torch.einsum("qda,ean->eqdn", D, X)  # J[e, q, d, n] = d x_n / d xi_d
    detj = _det3(J)
    return torch.einsum("eqdi,qia->eqda", _inv3(J, detj), D), detj


def precompute_geometry(nodes: torch.Tensor, elements: torch.Tensor, dtype=None) -> Hex8Geometry:
    """Quadrature geometry of all E elements at once, on the nodes'
    device: nodes (N, 3), elements (E, 8) -> Hex8Geometry in ``dtype``
    (the nodes' dtype when None)."""
    X = nodes[elements].to(dtype or nodes.dtype)  # (E, 8, 3)
    G, detj = _gradients(X, _D_QP)
    return Hex8Geometry(grads=G, wdetj=detj, min_detj=detj.min())


def stiffness_from_geometry(geom: Hex8Geometry, material: Material) -> torch.Tensor:
    """Explicit (E, 24, 24) stiffness batch, sum_q w detJ B^T C B."""
    G = geom.grads
    B = _b_matrices(G)  # (E, Q, 6, 24)
    C = elasticity_matrix(material, dtype=G.dtype, device=G.device)
    CB = torch.matmul(C, B) * geom.wdetj[..., None, None]
    return torch.einsum("eqia,eqib->eab", B, CB)


def stiffness_matrices(nodes: torch.Tensor, elements: torch.Tensor, material: Material, dtype=None) -> torch.Tensor:
    """Explicit (E, 24, 24) stiffness batch of a mesh (small systems, the
    dense solve, oracles and the ``stored`` operator)."""
    return stiffness_from_geometry(precompute_geometry(nodes, elements, dtype=dtype), material)


def apply_elements(geom: Hex8Geometry, u_e: torch.Tensor, material: Material) -> torch.Tensor:
    """Matrix-free element force f_e = Ke @ u_e without forming Ke:
    u_e (E, 8, 3) -> f_e (E, 8, 3).

    At each quadrature point the displacement gradient H = G @ u_e gives
    the strain eps = sym(H) and the stress sigma = lam tr(eps) I +
    2 mu eps, which goes back to the corners as w detJ G^T sigma.
    """
    lam, mu = lame_parameters(material)
    G = geom.grads
    u_e = u_e.to(G.dtype)
    H = torch.einsum("eqia,eaj->eqij", G, u_e)  # H[e, q, i, j] = d u_j / d x_i
    eps = 0.5 * (H + H.transpose(-1, -2))
    tr = eps.diagonal(dim1=-2, dim2=-1).sum(-1)
    sigma = 2.0 * mu * eps + (lam * tr)[..., None, None] * torch.eye(3, dtype=G.dtype, device=G.device)
    return torch.einsum("eqia,eqij,eq->eaj", G, sigma, geom.wdetj)


def diagonal(geom: Hex8Geometry, material: Material) -> torch.Tensor:
    """Per-element stiffness diagonal (E, 8, 3), in closed form for an
    isotropic C: K[3a+j, 3a+j] = sum_q w detJ [(lam + mu) G[j,a]^2 +
    mu |G[:,a]|^2]."""
    lam, mu = lame_parameters(material)
    G2 = geom.grads * geom.grads  # (E, Q, 3, 8)
    per_qp = (lam + mu) * G2 + mu * G2.sum(dim=-2, keepdim=True)
    return torch.einsum("eqja,eq->eaj", per_qp, geom.wdetj)


def block_diagonal(geom: Hex8Geometry, material: Material) -> torch.Tensor:
    """Per-element nodal 3x3 stiffness diagonal blocks (E, 8, 3, 3):
    (lam + mu) M + mu tr(M) I with M_ij = sum_q w detJ G[i,a] G[j,a]."""
    lam, mu = lame_parameters(material)
    G = geom.grads
    M = torch.einsum("eqia,eqja,eq->eaij", G, G, geom.wdetj)
    trM = M.diagonal(dim1=-2, dim2=-1).sum(-1)  # (E, 8)
    return (lam + mu) * M + (mu * trM)[..., None, None] * torch.eye(3, dtype=G.dtype, device=G.device)


def centroid_strain_stress(nodes: torch.Tensor, elements: torch.Tensor, u: torch.Tensor, material: Material):
    """Element-centroid Voigt strain and stress, (E, 6) each, evaluated at
    xi = 0 in u's dtype."""
    G = _gradients(nodes[elements].to(u.dtype), _D_CENTROID)[0][:, 0]  # (E, 3, 8)
    H = torch.einsum("eia,eaj->eij", G, u[elements])
    eps_t = 0.5 * (H + H.transpose(-1, -2))
    eps = torch.stack(
        [eps_t[:, 0, 0], eps_t[:, 1, 1], eps_t[:, 2, 2],
         2.0 * eps_t[:, 0, 1], 2.0 * eps_t[:, 1, 2], 2.0 * eps_t[:, 0, 2]],
        dim=-1,
    )
    C = elasticity_matrix(material, dtype=u.dtype, device=u.device)
    return eps, eps @ C.T


def von_mises(sigma_voigt: torch.Tensor) -> torch.Tensor:
    """Von Mises equivalent stress from (..., 6) Voigt stress."""
    sxx, syy, szz, sxy, syz, szx = sigma_voigt.unbind(-1)
    return torch.sqrt(
        0.5 * ((sxx - syy) ** 2 + (syy - szz) ** 2 + (szz - sxx) ** 2)
        + 3.0 * (sxy**2 + syz**2 + szx**2)
    )
