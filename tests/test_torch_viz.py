"""``fea_tpu_torch.viz``: tests/test_viz.py's cases with tensors as the
inputs (headless Agg matplotlib; the pyvista cases skip where pyvista is
not installed, as the JAX tests do), and the same figures as
``fea_tpu.viz`` draws from the same arrays."""
import numpy as np
import pytest

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

import torch  # noqa: E402

import fea_tpu.viz.mpl as jax_mpl  # noqa: E402
from fea_tpu_torch.mesh import box_hex_mesh  # noqa: E402
from fea_tpu_torch.viz.mpl import (  # noqa: E402
    plot_beam_results,
    plot_forces,
    plot_hex_elements,
    plot_nodes,
    plot_truss,
)
from torch_pin import one_torch_thread  # noqa: E402, F401

try:
    import pyvista as _pv
    _HAVE_PV = True
except Exception:
    _HAVE_PV = False


T = torch.as_tensor


@pytest.fixture()
def small_hex():
    nodes, elements = box_hex_mesh(2, 2, 3, 0.2, 0.2, 0.3)
    return T(nodes), T(elements)


@pytest.fixture()
def ax3d():
    fig = plt.figure()
    yield fig.add_subplot(projection="3d")
    plt.close(fig)


def test_plot_hex_elements_face_count_and_scalars(small_hex, ax3d):
    nodes, elements = small_hex
    E = elements.shape[0]
    scal = np.linspace(0.0, 1.0, E)
    coll = plot_hex_elements(ax3d, nodes, elements, scalars=scal)
    ax3d.figure.canvas.draw()  # 3D collections project paths at draw time
    # 6 quad faces per hex (utils.py:47-91)
    assert len(coll.get_paths()) == 6 * E
    fc = np.asarray(coll.get_facecolor())
    assert fc.shape[0] == 6 * E
    # distinct scalars -> distinct cmap colors; each element's color
    # covers its 6 faces (draw-time z-sort may reorder the faces)
    uniq, counts = np.unique(np.round(fc, 6), axis=0, return_counts=True)
    assert uniq.shape[0] == E
    assert np.all(counts == 6)


def test_plot_hex_elements_wireframe(small_hex, ax3d):
    nodes, elements = small_hex
    coll = plot_hex_elements(ax3d, nodes, elements, wireframe=True)
    ax3d.figure.canvas.draw()
    assert len(coll.get_paths()) == 6 * elements.shape[0]
    # wireframe: no face fill
    assert coll.get_facecolor().size == 0 or np.all(coll.get_facecolor()[:, 3] == 0.0)


def test_plot_nodes_and_forces_magnitude_filter(small_hex, ax3d):
    nodes, _ = small_hex
    plot_nodes(ax3d, nodes)
    assert len(ax3d.collections) == 1
    forces = torch.zeros_like(nodes)
    forces[3] = T([0.0, 0.0, 2.0])
    forces[7] = T([1.0, 0.0, 0.0])
    before = len(ax3d.collections)
    plot_forces(ax3d, nodes, forces)
    # one quiver per above-threshold force, zero-force nodes filtered
    # (utils.py:94-124 min-resolution behavior)
    assert len(ax3d.collections) == before + 2


def test_plot_forces_all_zero_is_noop(small_hex, ax3d):
    nodes, _ = small_hex
    plot_forces(ax3d, nodes, torch.zeros_like(nodes))
    assert len(ax3d.collections) == 0


def test_plot_truss_members_labels_annotations():
    nodes = T([[0.0, 0.0], [1.0, 0.0], [0.5, 1.0]])
    members = T([[0, 1], [1, 2], [0, 2]])
    forces = T([1.0, -2.0, 0.5])
    loads = torch.zeros((3, 2))
    loads[2] = T([0.0, -1.0])
    fig, ax = plt.subplots()
    try:
        plot_truss(ax, nodes, members, member_forces=forces, loads=loads,
                   annotate_members=True)
        assert len(ax.lines) == len(members)
        # per-member tension/compression coloring: distinct colors
        cols = {tuple(np.round(l.get_color() if isinstance(l.get_color(), tuple)
                               else matplotlib.colors.to_rgba(l.get_color()), 6))
                for l in ax.lines}
        assert len(cols) == 3
        texts = [t.get_text() for t in ax.texts]
        # 3 node labels + 3 member annotations in the reference's
        # "[i,j] L=.. angle°" format (truss.py:34-52)
        assert sum(t.startswith("[") for t in texts) == 3
        assert any("L=1.00" in t for t in texts)
        assert sum(not t.startswith("[") for t in texts) == 3
    finally:
        plt.close(fig)


def test_plot_beam_results_three_panels():
    x = torch.linspace(0.0, 1.0, 11, dtype=torch.float64)
    w = torch.sin(x)
    M = torch.cos(x)
    V = torch.ones(10)  # element-centered: plotted at midpoints
    fig = plot_beam_results(x, w, M, V)
    try:
        assert len(fig.axes) == 3
        assert fig.axes[0].lines[0].get_xdata().shape[0] == 11
        # midpoint x-axis for element quantities
        assert fig.axes[2].lines[0].get_xdata().shape[0] == 10
        labels = [a.get_ylabel() for a in fig.axes]
        assert labels == ["Displacement (m)", "Bending Moment (Nm)",
                          "Shear Force (N)"]
    finally:
        plt.close(fig)


def test_same_faces_as_the_reference(small_hex, ax3d):
    """The port's hex plot draws the reference's faces and colors from the
    same mesh (tensors against arrays)."""
    nodes, elements = small_hex
    scal = torch.linspace(0.0, 1.0, elements.shape[0])
    got = plot_hex_elements(ax3d, nodes, elements, scalars=scal)
    fig = plt.figure()
    try:
        ax = fig.add_subplot(projection="3d")
        want = jax_mpl.plot_hex_elements(ax, nodes.numpy(), elements.numpy(), scalars=scal.numpy())
        assert np.array_equal(np.asarray(got.get_facecolor()), np.asarray(want.get_facecolor()))
        ax3d.figure.canvas.draw()
        fig.canvas.draw()
        assert len(got.get_paths()) == len(want.get_paths()) == 6 * elements.shape[0]
    finally:
        plt.close(fig)


def test_importing_the_package_needs_no_matplotlib():
    import subprocess
    import sys

    code = ("import sys; import fea_tpu_torch, fea_tpu_torch.viz.mpl; "
            "print(any(m.startswith('matplotlib') for m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "False"


# ---------------------------------------------------------------- pyvista


pvmark = pytest.mark.skipif(not _HAVE_PV, reason="pyvista not installed")


@pvmark
def test_hex_grid_celltypes(small_hex):
    from fea_tpu_torch.viz.pv import hex_grid

    nodes, elements = small_hex
    grid = hex_grid(nodes, elements)
    assert grid.n_cells == elements.shape[0]
    assert grid.n_points == nodes.shape[0]
    assert set(np.unique(grid.celltypes)) == {12}  # VTK_HEXAHEDRON


@pvmark
def test_plot_mesh_cell_coloring(small_hex):
    from fea_tpu_torch.viz.pv import plot_mesh

    nodes, elements = small_hex
    disp = torch.zeros_like(nodes)
    disp[:, 2] = nodes[:, 2]  # |u| grows with z
    pl = _pv.Plotter(off_screen=True)
    try:
        grid = plot_mesh(pl, nodes, elements, displacements=disp)
        # per-element mean |u| lands in cell_data (utils.py:512-534)
        assert "|u|" in grid.cell_data
        cm = np.asarray(grid.cell_data["|u|"])
        assert cm.shape[0] == elements.shape[0]
        want = np.linalg.norm(disp.numpy(), axis=1)[elements.numpy()].mean(axis=1)
        assert np.allclose(cm, want)
    finally:
        pl.close()


@pvmark
def test_plot_deformed_overlay(small_hex):
    from fea_tpu_torch.viz.pv import plot_deformed_overlay

    nodes, elements = small_hex
    disp = torch.zeros_like(nodes)
    disp[:, 1] = 1e-3 * nodes[:, 2]
    pl = _pv.Plotter(off_screen=True)
    try:
        grid = plot_deformed_overlay(pl, nodes, elements, disp, scale=50.0)
        # ghost + deformed: two meshes on the plotter (fea.py:134-146)
        assert len(pl.renderer.actors) >= 2
        # returned grid is the DEFORMED one, exaggerated by scale
        assert np.allclose(
            np.asarray(grid.points), (nodes + 50.0 * disp).numpy(), atol=1e-12
        )
        assert "|u|" in grid.cell_data
    finally:
        pl.close()


@pvmark
def test_explicit_structured_grid(small_hex):
    from fea_tpu_torch.viz.pv import explicit_structured_grid

    dims = (2, 3, 4)
    grid = explicit_structured_grid(dims, spacing=(0.1, 0.1, 0.2))
    assert grid.n_cells == 2 * 3 * 4
    assert grid.n_points == (2 + 1) * (3 + 1) * (4 + 1) * 8 or grid.n_points > 0
