"""The benchmark's scenes, one function each, shared by ``bench_torch.py``,
the family benches of this package and ``chip_smoke.py``.

Each builds the scene of its tool in the JAX package's ``bench.py`` and
``tools/`` (named on each function) from the same mesh generator, seed,
distortion, node numbering, supports and loads, and returns the scene
beside the host arrays the host checks read. A scene goes on the CUDA
card unless ``device`` says otherwise (``scene.resolve_device``).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import mesh
from ..materials import Material, units
from ..scene import fix_where, make_scene

__all__ = ["MATERIAL", "cantilever", "distorted_arrays", "cantilever_bcs", "distorted", "renumbered",
           "l_domain", "TUBE_LOAD", "tube"]

# E = 10e6 psi, nu = 0.3: every scene of bench.py and tools/
MATERIAL = Material(E=10_000_000 * units.psi, nu=0.3)


def cantilever(dims, device=None):
    """bench.py's voxel cantilever at ``dims`` = (nx, ny, nz) voxels
    (``bench.py:186-199``): a 0.1 x 0.1 x 1.0 box, z = 0 fixed, a +y shear
    of 100 lbf/ft x 1.0 spread evenly over the tip face. ``tip_exact`` is
    the Euler-Bernoulli tip deflection P L^3 / 3 E I."""
    nx, ny, nz = dims
    lx = ly = 0.1
    lz = 1.0
    nodes, elements = mesh.box_hex_mesh(nx, ny, nz, lx, ly, lz)
    fixed = fix_where(nodes, lambda p: p[:, 2] == 0.0, 3)
    loads = np.zeros_like(nodes)
    tip = nodes[:, 2] == lz
    total_load = 100.0 * units.lbf / units.ft * lz
    loads[tip, 1] = total_load / tip.sum()
    scene = make_scene(nodes, elements, fixed, loads, MATERIAL, dtype=torch.float64, device=device)
    I = lx * ly**3 / 12.0
    tip_exact = total_load * lz**3 / (3 * MATERIAL.E * I)
    return scene, dict(nodes=nodes, elements=elements, fixed=fixed, loads=loads, tip=tip, tip_exact=tip_exact,
                       mat=MATERIAL)


def distorted_arrays(dims, lz=1.0):
    """tools/curv_bench.py's mesh: a 0.1 x 0.1 x lz box of ``dims``
    cells, its interior nodes moved by 0.25 h U(-1, 1) (seed 7, h = 0.1 /
    nx). Returns the nodes, the elements and the generator, which
    tools/canon_bench.py goes on drawing from."""
    nx, ny, nz = dims
    nodes, elements = mesh.box_hex_mesh(nx, ny, nz, 0.1, 0.1, lz)
    rng = np.random.default_rng(7)
    h = 0.1 / nx
    interior = (nodes[:, 2] > 0) & (nodes[:, 2] < lz)
    nodes = nodes + 0.25 * h * rng.uniform(-1, 1, nodes.shape) * interior[:, None]
    return nodes, elements, rng


def cantilever_bcs(nodes, lz=1.0):
    """tools/curv_bench.py's supports and load: z = 0 fixed, a total +y
    load of 1.0 spread evenly over the z = lz face. Returns (fixed, loads,
    tip)."""
    fixed = fix_where(nodes, lambda q: np.isclose(q[:, 2], 0.0), 3)
    loads = np.zeros_like(nodes)
    tip = np.isclose(nodes[:, 2], lz)
    loads[tip, 1] = 1.0 / tip.sum()
    return fixed, loads, tip


def distorted(dims, device=None):
    """tools/curv_bench.py's scene at ``dims``: the curvilinear route's
    (``bench.py``'s ``curvilinear`` at 24x24x96, ``curvilinear_812k`` at
    40x40x160)."""
    nodes, elements, _ = distorted_arrays(dims)
    fixed, loads, tip = cantilever_bcs(nodes)
    scene = make_scene(nodes, elements, fixed, loads, MATERIAL, dtype=torch.float64, device=device)
    return scene, dict(nodes=nodes, elements=elements, fixed=fixed, loads=loads, tip=tip, mat=MATERIAL)


def renumbered(dims, device=None):
    """tools/canon_bench.py's scene: :func:`distorted`'s mesh with its
    nodes renumbered by a permutation from the same generator and its
    elements shuffled. Original node k is node ``pi[k]`` of the scene; the
    host dict holds the renumbered arrays (``nodes``, ``elements``,
    ``fixed``, ``loads``, ``tip``) and the original mesh (``orig_nodes``,
    ``orig_elements``)."""
    nodes, elements, rng = distorted_arrays(dims)
    N = nodes.shape[0]
    pi = rng.permutation(N)
    inv = np.empty_like(pi)
    inv[pi] = np.arange(N)
    nodes_r = nodes[inv]
    el_r = pi[elements]
    el_r = el_r[rng.permutation(el_r.shape[0])]
    fixed_r, loads_r, tip_r = cantilever_bcs(nodes_r)
    scene = make_scene(nodes_r, el_r, fixed_r, loads_r, MATERIAL, dtype=torch.float64, device=device)
    return scene, dict(nodes=nodes_r, elements=el_r, fixed=fixed_r, loads=loads_r, tip=tip_r, mat=MATERIAL,
                       orig_nodes=nodes, orig_elements=elements, pi=pi)


def l_domain(dims, device=None):
    """tools/arbitrary_bench.py's scene at ``dims``: the L-domain
    ``l_hex_mesh(nx, ny, nz, 0.1, 0.1, 0.1 nz / nx)``, interior nodes
    moved by 0.2 h U(-1, 1) (seed 7, h = 0.1 / nx), z = 0 fixed, a total
    +y load of 1.0 on the tip face (``bench.py``'s ``arbitrary`` at
    40x40x144)."""
    nx, ny, nz = dims
    lz = 0.1 * nz / nx
    nodes, elements = mesh.l_hex_mesh(nx, ny, nz, 0.1, 0.1, lz)
    rng = np.random.default_rng(7)
    interior = (nodes[:, 2] > 1e-12) & (nodes[:, 2] < lz - 1e-12)
    nodes = nodes + 0.2 * (0.1 / nx) * rng.uniform(-1, 1, nodes.shape) * interior[:, None]
    fixed = fix_where(nodes, lambda q: np.isclose(q[:, 2], 0.0), 3)
    loads = np.zeros_like(nodes)
    tip = np.isclose(nodes[:, 2], lz)
    loads[tip, 1] = 1.0 / max(tip.sum(), 1)
    scene = make_scene(nodes, elements, fixed, loads, MATERIAL, dtype=torch.float64, device=device)
    return scene, dict(nodes=nodes, elements=elements, fixed=fixed, loads=loads, tip=tip, mat=MATERIAL)


TUBE_LOAD = 1000.0  # lbf, tools/tube_bench.py's cosine tip load


def tube(segments, layers, device=None):
    """tools/tube_bench.py's scene: an annulus of ``segments`` segments, 4 in
    outer and 3.9 in inner radius, 2 ft long, extruded in ``layers``
    element layers, z = 0 fixed, a cosine-weighted downward load of
    ``TUBE_LOAD`` lbf on the lower outer tip ring (``bench.py``'s ``extruded``
    at 256 x 384). Returns (scene, detected, host): ``detected`` feeds the
    extruded set-up, ``host["w"]`` holds the load's weights (sum 1)."""
    from ..ops.extruded import extruded_scene_tube

    r_out, r_in, length = 4 * units.inch, 3.9 * units.inch, 2 * units.ft
    base, detected = extruded_scene_tube(segments, layers, r_in, r_out, length, MATERIAL,
                                         dtype=torch.float64, device=device)
    nodes, elements = base.host_nodes, base.host_elements
    fixed = base.fixed.cpu().numpy()
    tip = nodes[:, 2] == nodes[:, 2].max()
    sel = tip & (np.abs(np.hypot(nodes[:, 0], nodes[:, 1]) - r_out) < 1e-9) & (nodes[:, 1] < 0)
    w = np.zeros(nodes.shape[0])
    w[sel] = np.cos(0.5 * np.pi * nodes[sel, 0] / r_out)
    w /= w.sum()
    loads = np.zeros_like(nodes)
    loads[:, 1] = -TUBE_LOAD * w
    scene = make_scene(nodes, elements, fixed, loads, MATERIAL, dtype=torch.float64, device=base.device)
    return scene, detected, dict(nodes=nodes, elements=elements, fixed=fixed, loads=loads, tip=tip, w=w,
                                 mat=MATERIAL)
