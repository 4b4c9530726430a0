"""Post-processing: reactions, stresses, beam internal actions, checkpoints.

Counterpart of ``fea_tpu/post.py``. A checkpoint is an ``.npz`` file with
the reference's keys, so a file saved by either package loads in the
other.
"""
from __future__ import annotations

import numpy as np
import torch

from .elements import beam as beam_el
from .elements import hex8 as hex8_el
from .elements import truss as truss_el
from .scene import Scene

__all__ = [
    "beam_moment_shear",
    "hex8_stress",
    "load_solution",
    "reactions",
    "save_solution",
    "truss_member_forces",
]


def reactions(op, u: torch.Tensor) -> torch.Tensor:
    """K @ u over all DOFs."""
    return op.apply_raw(u)


def hex8_stress(scene: Scene, u: torch.Tensor):
    """Element-centroid Voigt strain and stress and von Mises stress of a
    hex8 scene: (strain (E, 6), stress (E, 6), von_mises (E,))."""
    eps, sig = hex8_el.centroid_strain_stress(scene.nodes, scene.elements, u, scene.material)
    return eps, sig, hex8_el.von_mises(sig)


def beam_moment_shear(scene: Scene, u: torch.Tensor):
    """Per-element (M_left, M_right, V) of an eb_beam scene."""
    inertia = scene.section if scene.section is not None else 1.0
    return beam_el.moment_shear(scene.nodes, scene.elements, u, scene.material, inertia)


def truss_member_forces(scene: Scene, u: torch.Tensor) -> torch.Tensor:
    """Axial member forces (tension positive) of a bar scene."""
    return truss_el.member_forces(scene.nodes, scene.elements, u, scene.section)


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def save_solution(path: str, scene: Scene, u, reactions_=None) -> None:
    """Checkpoint a solved scene as a compressed ``.npz``."""
    payload = dict(
        nodes=_host(scene.nodes),
        elements=_host(scene.elements),
        fixed=_host(scene.fixed),
        loads=_host(scene.loads),
        displacements=_host(u),
        family=np.asarray(scene.family),
        E=np.asarray(scene.material.E),
        nu=np.asarray(scene.material.nu),
    )
    if reactions_ is not None:
        payload["reactions"] = _host(reactions_)
    if scene.section is not None:
        payload["section"] = _host(scene.section)
    np.savez_compressed(path, **payload)


def load_solution(path: str) -> dict:
    """A checkpoint back as a dict of NumPy arrays."""
    with np.load(path, allow_pickle=False) as data:
        return {k: data[k] for k in data.files}
