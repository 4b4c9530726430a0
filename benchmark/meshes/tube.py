"""The hollow-tube cantilever: an annulus of ``segments`` quads between
radii ``r_in`` and ``r_out``, extruded along z in ``layers`` element
layers of a tube ``length`` long, the z = 0 ring fixed, the load spread
evenly over the nodes of the z = length face.

A frozen copy of the generators of the scene the configuration comes
from (fea-tpu's ``mesh.annulus_section`` and ``mesh.extrude_quads``, as
``tools/tube_bench.py`` calls them): the section's nodes inner ring then
outer ring, each counter-clockwise from the x axis, quad i wound
[i, i + n, (i + 1) % n + n, (i + 1) % n]; nodes layer by layer (layer-major);
elements layer by layer, [bottom 4 | top 4] (the reference's
``stack_faces_2d``). It draws no random numbers.
"""
from __future__ import annotations

import numpy as np


def annulus_section(n: int, r_in: float, r_out: float):
    """(2 n, 2) section nodes and (n, 4) quads of an annulus."""
    thetas = np.linspace(0.0, 2.0 * np.pi, n, endpoint=False)
    unit = np.stack([np.cos(thetas), np.sin(thetas)], axis=1)
    nodes2d = np.vstack([unit * r_in, unit * r_out])
    i = np.arange(n)
    quads = np.stack([i, i + n, (i + 1) % n + n, (i + 1) % n], axis=1).astype(np.int64)
    return nodes2d, quads


def extrude_quads(nodes2d: np.ndarray, quads: np.ndarray, z: np.ndarray):
    """A layer-major hex8 mesh of the section extruded through heights ``z``."""
    n, layers = nodes2d.shape[0], z.shape[0]
    nodes = np.empty((n * layers, 3))
    nodes[:, :2] = np.tile(nodes2d, (layers, 1))
    nodes[:, 2] = np.repeat(z, n)
    bottom = quads[None, :, :] + np.arange(layers - 1)[:, None, None] * n
    elements = np.concatenate([bottom, bottom + n], axis=-1).reshape(-1, 8)
    return nodes, elements


def build(config: dict, rng: np.random.Generator) -> dict:
    """nodes (N, 3), elements (E, 8), fixed (N, 3) bool, tip (N,) bool;
    ``rng`` is not drawn from."""
    nodes2d, quads = annulus_section(config["segments"], config["r_in"], config["r_out"])
    length = config["length"]
    nodes, elements = extrude_quads(nodes2d, quads, np.linspace(0.0, length, config["layers"] + 1))
    fixed = np.repeat((nodes[:, 2] == 0.0)[:, None], 3, axis=1)
    return dict(nodes=nodes, elements=elements, fixed=fixed, tip=nodes[:, 2] == length)
