"""Detection of extruded (layer-major) hex8 meshes.

The extruded route (ROADMAP queue 1 item 12) is not ported yet, but its
detectors are: ``solve()`` must recognise an extruded scene before it
tries the curvilinear route, because a box-connectivity mesh extruded
along z matches both and the reference sends it to the extruded route.
NumPy on the host. Counterpart of ``fea_tpu/ops/extruded.py::
infer_extruded`` and ``fea_tpu/solve/extruded.py::extruded_mg_coarsenable``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..scene import Scene

__all__ = ["extruded_mg_coarsenable", "infer_extruded"]


def _expected_extruded_elements(quads: np.ndarray, n2: int, n_layers: int) -> np.ndarray:
    layer = np.arange(n_layers - 1)[:, None, None] * n2
    bottom = quads[None, :, :] + layer
    top = bottom + n2
    return np.concatenate([bottom, top], axis=-1).reshape(-1, 8)


def infer_extruded(scene: Scene) -> Optional[tuple[np.ndarray, int, int]]:
    """(section_quads, n2, n_layers) if the scene is a layer-major
    extrusion with uniform z spacing (the ``mesh.extrude_quads``
    convention), else None. Finds the layer period from where the z
    coordinate first jumps, then validates node layout and connectivity
    exactly."""
    if scene.family != "hex8":
        return None
    nodes = scene.host_nodes
    z = nodes[:, 2]
    jumps = np.nonzero(np.abs(np.diff(z)) > 0)[0]
    if jumps.size == 0:
        return None
    n2 = int(jumps[0]) + 1
    N = nodes.shape[0]
    if n2 < 3 or N % n2:
        return None
    L = N // n2
    if L < 2:
        return None
    grid = nodes.reshape(L, n2, 3)
    tol = 64.0 * float(np.finfo(nodes.dtype).eps) * max(float(np.max(np.abs(nodes))), 1e-30)
    # every layer carries the same section (x, y)
    if float(np.max(np.abs(grid[:, :, :2] - grid[0, :, :2][None]))) > tol:
        return None
    # constant z within a layer, uniform spacing across layers
    zl = grid[:, :, 2]
    if float(np.max(np.abs(zl - zl[:, :1]))) > tol:
        return None
    dz = np.diff(zl[:, 0])
    if dz.size == 0 or float(dz.min()) <= 0 or float(np.ptp(dz)) > 2 * tol:
        return None
    elements = scene.host_elements
    E = elements.shape[0]
    if E % (L - 1):
        return None
    Q2 = E // (L - 1)
    quads = elements[:Q2, :4].astype(np.int64)
    if np.any(quads < 0) or np.any(quads >= n2):
        return None
    if not np.array_equal(elements, _expected_extruded_elements(quads, n2, L)):
        return None
    return quads, n2, L


def extruded_mg_coarsenable(n_element_layers: int, thomas_layers: int = 17) -> bool:
    """True when the z hierarchy reaches a block-tridiagonal direct solve
    (<= 64 node layers): halve while even and above the Thomas target."""
    lz = n_element_layers
    while lz > thomas_layers - 1 and lz % 2 == 0:
        lz //= 2
    return lz + 1 <= 64
