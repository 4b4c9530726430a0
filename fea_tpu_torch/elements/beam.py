"""Euler-Bernoulli bending element (2 DOF/node: deflection w, rotation theta).

The closed-form 4x4 Ke and the consistent nodal load of a uniform
distributed load, batched over all elements (per-element lengths and
section properties allowed), and the internal actions M = EI v'' and
V = EI v''' from the Hermite interpolant. Counterpart of
``fea_tpu/elements/beam.py``.
"""
from __future__ import annotations

import torch

from ..materials import Material
from . import per_element

__all__ = ["element_lengths", "moment_shear", "stiffness_matrices", "uniform_load_vector"]


def element_lengths(nodes: torch.Tensor, elements: torch.Tensor) -> torch.Tensor:
    """(E,) element lengths from 1D node coordinates (N,) or (N, 1).

    Signed: each element must run left to right, x[n1] > x[n0];
    ``build_operator`` checks that on the host.
    """
    x = nodes.reshape(-1)
    return x[elements[:, 1]] - x[elements[:, 0]]


def stiffness_matrices(nodes: torch.Tensor, elements: torch.Tensor, material: Material, inertia) -> torch.Tensor:
    """Batched (E, 4, 4) Euler-Bernoulli stiffness, (EI / L^3) times the
    closed form, DOF order (w0, th0, w1, th1) per element."""
    L = element_lengths(nodes, elements)
    EI = per_element(material.E * inertia, L)
    one = torch.ones_like(L)
    rows = [
        [12.0 * one, 6.0 * L, -12.0 * one, 6.0 * L],
        [6.0 * L, 4.0 * L**2, -6.0 * L, 2.0 * L**2],
        [-12.0 * one, -6.0 * L, 12.0 * one, -6.0 * L],
        [6.0 * L, 2.0 * L**2, -6.0 * L, 4.0 * L**2],
    ]
    Ke = torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)  # (E, 4, 4)
    return (EI / L**3)[:, None, None] * Ke


def uniform_load_vector(nodes: torch.Tensor, elements: torch.Tensor, q) -> torch.Tensor:
    """Consistent nodal load (E, 4) of a uniform transverse load q:
    q L / 2 * [1, L/6, 1, -L/6] per element."""
    L = element_lengths(nodes, elements)
    half = per_element(q, L) * L / 2.0
    return torch.stack([half, half * L / 6.0, half, -half * L / 6.0], dim=-1)


def moment_shear(nodes: torch.Tensor, elements: torch.Tensor, u: torch.Tensor, material: Material, inertia):
    """Per-element internal actions from the Hermite interpolant:
    (M0, M1, V), the bending moment at each element end and the
    (constant) shear force, each (E,).

      v''(0) = (-6 w0 - 4 L th0 + 6 w1 - 2 L th1) / L^2
      v''(L) = ( 6 w0 + 2 L th0 - 6 w1 + 4 L th1) / L^2
      v'''   = (12 w0 + 6 L th0 - 12 w1 + 6 L th1) / L^3
    """
    L = element_lengths(nodes, elements)
    EI = per_element(material.E * inertia, L)
    dof = u.reshape(-1, 2)
    w0, th0 = dof[elements[:, 0], 0], dof[elements[:, 0], 1]
    w1, th1 = dof[elements[:, 1], 0], dof[elements[:, 1], 1]
    M0 = EI * (-6.0 * w0 - 4.0 * L * th0 + 6.0 * w1 - 2.0 * L * th1) / L**2
    M1 = EI * (6.0 * w0 + 2.0 * L * th0 - 6.0 * w1 + 4.0 * L * th1) / L**2
    V = EI * (12.0 * w0 + 6.0 * L * th0 - 12.0 * w1 + 6.0 * L * th1) / L**3
    return M0, M1, V
