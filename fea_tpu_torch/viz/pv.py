"""PyVista/VTK rendering (an optional dependency): ``plot_mesh`` builds a
``pv.UnstructuredGrid`` of VTK hexahedra (cell type 12) from the (E, 8)
connectivity and colors cells by their mean displacement magnitude;
arrows by ``add_arrows``; the deformed mesh over a ghost of the
undeformed one. A copy of ``fea_tpu/viz/pv.py`` whose functions take
NumPy arrays or tensors (on any device: they are copied to the host).
"""
from __future__ import annotations

import numpy as np

import pyvista as pv  # gated at package level (fea_tpu_torch.viz.__init__)

from ._host import host as _host

__all__ = [
    "hex_grid",
    "plot_mesh",
    "plot_nodes_pv",
    "plot_forces_pv",
    "plot_deformed_overlay",
    "structured_corner_array",
    "explicit_structured_grid",
]

_VTK_HEXAHEDRON = 12


def hex_grid(nodes, elements) -> "pv.UnstructuredGrid":
    """(N,3) nodes + (E,8) hex connectivity -> pv.UnstructuredGrid."""
    nodes = _host(nodes, dtype=float)
    elements = _host(elements, dtype=np.int64)
    E = elements.shape[0]
    cells = np.concatenate([np.full((E, 1), 8, dtype=np.int64), elements], axis=1).reshape(-1)
    celltypes = np.full(E, _VTK_HEXAHEDRON, dtype=np.uint8)
    return pv.UnstructuredGrid(cells, celltypes, nodes)


def plot_mesh(plotter, nodes, elements, displacements=None, show_edges=True, opacity=1.0, cmap="viridis", **kwargs):
    """Add a (possibly deformed) hex mesh; cells colored by per-element
    mean displacement magnitude when ``displacements`` is given."""
    grid = hex_grid(nodes, elements)
    if displacements is not None:
        disp = _host(displacements)
        mags = np.linalg.norm(disp, axis=1)
        cell_mags = mags[_host(elements)].mean(axis=1)
        grid.cell_data["|u|"] = cell_mags
        plotter.add_mesh(grid, scalars="|u|", cmap=cmap, show_edges=show_edges, opacity=opacity, **kwargs)
    else:
        plotter.add_mesh(grid, show_edges=show_edges, opacity=opacity, **kwargs)
    return grid


def plot_nodes_pv(plotter, nodes, **kwargs):
    plotter.add_points(_host(nodes, dtype=float), **kwargs)


def plot_forces_pv(plotter, nodes, forces, mag_scale=None, **kwargs):
    nodes = _host(nodes, dtype=float)
    forces = _host(forces, dtype=float)
    mags = np.linalg.norm(forces, axis=1)
    if mag_scale is None:
        mag_scale = 0.1 / max(mags.max(), 1e-30)
    plotter.add_arrows(nodes, forces, mag=mag_scale, **kwargs)


def plot_deformed_overlay(plotter, nodes, elements, displacements, scale=100.0, **kwargs):
    """Undeformed ghost (opacity 0.2) under the exaggerated deformed mesh —
    the demos' render."""
    plot_mesh(plotter, nodes, elements, show_edges=True, opacity=0.2)
    displaced = _host(nodes) + _host(displacements) * scale
    return plot_mesh(plotter, displaced, elements, displacements=displacements, show_edges=True, **kwargs)


from ..mesh import structured_corner_array  # noqa: F401  (re-export)


def explicit_structured_grid(dims, spacing=(1.0, 1.0, 1.0)) -> "pv.ExplicitStructuredGrid":
    """pv.ExplicitStructuredGrid over a regular voxel grid, connectivity
    computed by VTK."""
    corners = structured_corner_array(dims, spacing)
    grid = pv.ExplicitStructuredGrid(np.asarray(dims) + 1, corners)
    return grid.compute_connectivity()
