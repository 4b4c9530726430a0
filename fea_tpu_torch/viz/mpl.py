"""Matplotlib 3D/2D plotting: node scatter, hex element faces
(Poly3DCollection), wireframes, force quivers colored and scaled by
magnitude, 2D truss plots with member annotations, and the 3-panel beam
figure. A copy of ``fea_tpu/viz/mpl.py`` whose functions take NumPy
arrays or tensors (on any device: they are copied to the host).
matplotlib is imported inside the functions, so importing this module
does not need it.
"""
from __future__ import annotations

import numpy as np

from ..mesh import hex_surface_quads
from ._host import host as _host

__all__ = [
    "plot_nodes",
    "plot_hex_elements",
    "plot_forces",
    "plot_truss",
    "plot_beam_results",
]


def plot_nodes(ax, nodes, **kwargs):
    """3D node scatter."""
    nodes = _host(nodes)
    ax.scatter(nodes[:, 0], nodes[:, 1], nodes[:, 2], **kwargs)


def plot_hex_elements(ax, nodes, elements, wireframe=False, scalars=None, cmap="viridis", alpha=1.0):
    """Render hex8 elements as quad faces.

    ``scalars`` (E,) colors each element's 6 faces through ``cmap``
    (e.g. displacement magnitude or von Mises stress).
    """
    import matplotlib
    from matplotlib import colors as mcolors
    from mpl_toolkits.mplot3d.art3d import Poly3DCollection

    nodes = _host(nodes)
    elements = _host(elements)
    faces = hex_surface_quads(elements)  # (6E, 4)
    polys = nodes[faces]  # (6E, 4, 3)
    if wireframe:
        # transparent RGBA, not "none": an empty facecolor array makes
        # Poly3DCollection's draw-time z-sort zip nothing and crash on
        # matplotlib >= 3.10 (caught by tests/test_viz.py)
        coll = Poly3DCollection(polys, facecolors=(0.0, 0.0, 0.0, 0.0), edgecolors="k", linewidths=0.3)
    else:
        if scalars is not None:
            scalars = _host(scalars)
            norm = mcolors.Normalize(vmin=scalars.min(), vmax=scalars.max())
            face_colors = matplotlib.colormaps[cmap](norm(np.repeat(scalars, 6)))
            coll = Poly3DCollection(polys, facecolors=face_colors, edgecolors="k", linewidths=0.2, alpha=alpha)
        else:
            coll = Poly3DCollection(polys, facecolors="tab:blue", edgecolors="k", linewidths=0.2, alpha=alpha)
    ax.add_collection3d(coll)
    ax.auto_scale_xyz(nodes[:, 0], nodes[:, 1], nodes[:, 2])
    return coll


def plot_forces(ax, nodes, forces, min_resolution=1e-9, length_scale=0.1, cmap="plasma"):
    """Force quivers colored & scaled by magnitude with a minimum-resolution
    floor."""
    import matplotlib
    from matplotlib import colors as mcolors

    nodes = _host(nodes)
    forces = _host(forces)
    mags = np.linalg.norm(forces, axis=1)
    big = mags > max(min_resolution, mags.max() * 1e-6 if mags.size else 0.0)
    if not big.any():
        return
    norm = mcolors.Normalize(vmin=0.0, vmax=mags[big].max())
    colormap = matplotlib.colormaps[cmap]
    for p, f, m in zip(nodes[big], forces[big], mags[big]):
        ax.quiver(
            p[0], p[1], p[2], f[0], f[1], f[2],
            color=colormap(norm(m)), length=length_scale * m / mags[big].max(), normalize=True,
        )


def plot_truss(
    ax,
    nodes,
    members,
    displacement=None,
    loads=None,
    member_forces=None,
    label_nodes=True,
    annotate_members=False,
):
    """2D truss plot: members (colored by axial force when provided), node
    labels, and load quivers.

    ``annotate_members`` adds per-member length/angle labels, rotated
    along the member."""
    import matplotlib
    from matplotlib import colors as mcolors

    nodes = _host(nodes)
    if displacement is not None:
        nodes = nodes + _host(displacement)
    members = _host(members)
    if member_forces is not None:
        mf = _host(member_forces)
        vmax = max(np.abs(mf).max(), 1e-30)
        norm = mcolors.Normalize(vmin=-vmax, vmax=vmax)
        colormap = matplotlib.colormaps["coolwarm"]
        colors = [colormap(norm(f)) for f in mf]
    else:
        colors = ["k"] * len(members)
    for (i, j), c in zip(members, colors):
        ax.plot([nodes[i, 0], nodes[j, 0]], [nodes[i, 1], nodes[j, 1]], "-", color=c)
        if annotate_members:
            dx, dy = nodes[j] - nodes[i]
            length = float(np.hypot(dx, dy))
            angle = float(np.degrees(np.arctan2(dy, dx)))
            mid = 0.5 * (nodes[i] + nodes[j])
            ax.text(
                mid[0],
                mid[1],
                f"[{i},{j}] L={length:.2f} {angle:.0f}\N{DEGREE SIGN}",
                fontsize=9,
                ha="center",
                va="bottom",
                rotation=angle,
                rotation_mode="anchor",
            )
    ax.scatter(nodes[:, 0], nodes[:, 1], zorder=3)
    if label_nodes:
        for idx, p in enumerate(nodes):
            ax.annotate(f"{idx}", (p[0], p[1]), fontsize=9, ha="right")
    if loads is not None:
        loads = _host(loads)
        nz = np.linalg.norm(loads, axis=1) > 0
        ax.quiver(nodes[nz, 0], nodes[nz, 1], loads[nz, 0], loads[nz, 1], color="tab:red")
    ax.set_aspect("equal", adjustable="box")
    ax.grid(True)


def plot_beam_results(x, w, M, V, fig=None):
    """3-panel displacement / moment / shear plot."""
    import matplotlib.pyplot as plt

    if fig is None:
        fig = plt.figure(figsize=(12, 8))
    labels = [
        ("Displacement (m)", _host(w)),
        ("Bending Moment (Nm)", _host(M)),
        ("Shear Force (N)", _host(V)),
    ]
    x = _host(x).reshape(-1)
    for i, (ylabel, y) in enumerate(labels, start=1):
        ax = fig.add_subplot(3, 1, i)
        xs = x if y.shape[0] == x.shape[0] else 0.5 * (x[:-1] + x[1:])
        ax.plot(xs, y, marker="o", markersize=3)
        ax.set_xlabel("Position along the beam (m)")
        ax.set_ylabel(ylabel)
        ax.grid(True)
    fig.tight_layout()
    return fig
