"""Pin-jointed axial bar (truss) element, 2D and 3D, batched.

Linear bar stiffness matrices for the K u = f path, and the
geometrically nonlinear internal force (force = k * stretch along the
current member axis) that ``solve_nonlinear`` drives to equilibrium with
Newton-Krylov. ``stiffness`` is the per-element axial stiffness
k = E A / L0. Counterpart of ``fea_tpu/elements/truss.py``.
"""
from __future__ import annotations

import torch

from . import per_element

__all__ = ["internal_forces", "member_forces", "stiffness_matrices"]


def _directions(nodes: torch.Tensor, elements: torch.Tensor):
    """Unit direction (E, dim) and length (E,) of each member."""
    d = nodes[elements[:, 1]] - nodes[elements[:, 0]]
    L = torch.linalg.vector_norm(d, dim=-1)
    return d / L[:, None], L


def stiffness_matrices(nodes: torch.Tensor, elements: torch.Tensor, stiffness) -> torch.Tensor:
    """Batched linear bar Ke, (E, 2*dim, 2*dim):
    k [[cc, -cc], [-cc, cc]] with cc = outer(c, c) for the unit axis c."""
    c, L = _directions(nodes, elements)
    k = per_element(stiffness, L)
    cc = c[:, :, None] * c[:, None, :]  # (E, dim, dim)
    top = torch.cat([cc, -cc], dim=-1)
    bot = torch.cat([-cc, cc], dim=-1)
    return k[:, None, None] * torch.cat([top, bot], dim=-2)


def internal_forces(nodes: torch.Tensor, elements: torch.Tensor, displacement: torch.Tensor, stiffness) -> torch.Tensor:
    """Nodal internal forces (N, dim) of the displaced truss.

    Member force -k (L0 - L) (tension positive), directed along the
    current member axis and summed +/- into the end nodes. Written with
    out-of-place ops, so ``torch.func.jvp`` gives the tangent operator.
    """
    current = nodes + displacement
    d = current[elements[:, 1]] - current[elements[:, 0]]
    L = torch.linalg.vector_norm(d, dim=-1)
    _, L0 = _directions(nodes, elements)
    force = -per_element(stiffness, L) * (L0 - L)
    fvec = (force / L)[:, None] * d  # (E, dim) force on the start node
    f = torch.zeros_like(current)
    return f.index_add(0, elements[:, 0], fvec).index_add(0, elements[:, 1], -fvec)


def member_forces(nodes: torch.Tensor, elements: torch.Tensor, displacement: torch.Tensor, stiffness) -> torch.Tensor:
    """Axial force per member (E,), tension positive."""
    current = nodes + displacement
    L = torch.linalg.vector_norm(current[elements[:, 1]] - current[elements[:, 0]], dim=-1)
    _, L0 = _directions(nodes, elements)
    return per_element(stiffness, L) * (L - L0)
