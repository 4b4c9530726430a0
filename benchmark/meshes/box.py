"""The box cantilever: a hex8 mesh of an (lx, ly, lz) box, z = 0 fixed,
the load spread evenly over the nodes of the z = lz face.

A frozen copy of the generators of the scenes the configurations come
from (fea-tpu's ``mesh.box_hex_mesh``, ``tools/curv_bench.py``'s
distortion and supports): nodes x fastest, then y, then z; elements layer
by layer, [bottom 4 | top 4], each face counter-clockwise. With
``distortion`` d > 0 every node off the two z faces moves by
d h U(-1, 1) on each axis, h = lx / nx, drawn from the generator the
harness passes (one per mesh, from the run's seed).
"""
from __future__ import annotations

import numpy as np


def box_hex_mesh(nx: int, ny: int, nz: int, lx: float, ly: float, lz: float):
    x = np.linspace(0.0, lx, nx + 1)
    y = np.linspace(0.0, ly, ny + 1)
    X, Y = np.meshgrid(x, y, indexing="xy")
    nodes2d = np.stack([X.ravel(), Y.ravel()], axis=1)
    J, I = np.meshgrid(np.arange(ny), np.arange(nx), indexing="ij")
    n1 = J * (nx + 1) + I
    quads = np.stack([n1, n1 + 1, n1 + nx + 2, n1 + nx + 1], axis=-1).reshape(-1, 4).astype(np.int64)
    n, z = nodes2d.shape[0], np.linspace(0.0, lz, nz + 1)
    nodes = np.empty((n * (nz + 1), 3))
    nodes[:, :2] = np.tile(nodes2d, (nz + 1, 1))
    nodes[:, 2] = np.repeat(z, n)
    bottom = quads[None, :, :] + np.arange(nz)[:, None, None] * n
    elements = np.concatenate([bottom, bottom + n], axis=-1).reshape(-1, 8)
    return nodes, elements


def build(config: dict, rng: np.random.Generator) -> dict:
    """nodes (N, 3), elements (E, 8), fixed (N, 3) bool, tip (N,) bool."""
    nx, ny, nz = config["cells"]
    lx, ly, lz = config["size"]
    nodes, elements = box_hex_mesh(nx, ny, nz, lx, ly, lz)
    d = config["distortion"]
    if d > 0:
        interior = (nodes[:, 2] > 0) & (nodes[:, 2] < lz)
        nodes = nodes + d * (lx / nx) * rng.uniform(-1, 1, nodes.shape) * interior[:, None]
    fixed = np.repeat((nodes[:, 2] == 0.0)[:, None], 3, axis=1)
    return dict(nodes=nodes, elements=elements, fixed=fixed, tip=nodes[:, 2] == lz)
