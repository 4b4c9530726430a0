"""Material models and unit constants.

Counterpart of ``fea_tpu/materials.py``: a linear isotropic material and
the US-customary to SI constants of the reference scripts.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["Material", "lame_parameters", "elasticity_matrix", "units"]


@dataclasses.dataclass(frozen=True)
class Material:
    """Linear isotropic material."""

    E: float  # Young's modulus
    nu: float  # Poisson's ratio


def lame_parameters(material: Material) -> tuple[float, float]:
    """(lambda, mu) Lamé parameters from (E, nu)."""
    E = float(material.E)
    nu = float(material.nu)
    lam = E * nu / ((1.0 + nu) * (1.0 - 2.0 * nu))
    mu = E / (2.0 * (1.0 + nu))
    return lam, mu


def elasticity_matrix(material: Material, dtype: torch.dtype = torch.float64, device=None) -> torch.Tensor:
    """6x6 isotropic elasticity matrix in Voigt order (xx,yy,zz,xy,yz,zx),
    engineering shear convention."""
    lam, mu = lame_parameters(material)
    C = torch.zeros((6, 6), dtype=dtype, device=device)
    C[:3, :3] = lam
    idx = torch.arange(3, device=device)
    C[idx, idx] = lam + 2.0 * mu
    C[idx + 3, idx + 3] = mu
    return C


class units:
    """US-customary → SI conversion constants."""

    psi = 6894.76
    lbf = 4.44822
    ft = 0.3048
    inch = 0.0254
