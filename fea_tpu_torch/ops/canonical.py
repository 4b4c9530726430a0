"""Connectivity canonicalization: detect box-grid meshes under node
renumbering.

The curvilinear and voxel routes key off the canonical box-grid node
order of ``mesh.box_hex_mesh``. A mesh whose nodes were renumbered
(partitioners, mesh optimizers, file round-trips) presents the same
topology in scrambled ids. This module recovers the grid:

  * each hex8 element's corner order is the topological compass: corner
    pairs that differ along one axis are that axis's edges, whatever the
    node ids (the corner convention of ``ops.structured._CORNERS``);
  * per-axis successor maps (node -> node + axis) are built vectorized
    and checked for global consistency; their chain positions give every
    node its (ix, iy, iz) grid coordinate;
  * the induced permutation is verified exactly: applied to the
    connectivity (element rows ordered by their min-corner coordinate) it
    must reproduce ``_expected_box_elements`` bit for bit.

NumPy on the host, never touching coordinates. Counterpart of
``fea_tpu/ops/canonical.py``. ``infer_subgrid_embedding`` recognises a
mesh whose cells are a subset of a box grid's, which the embedded route
(``solve/embed.py``) solves on the box.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..scene import Scene, make_scene
from .structured import _expected_box_elements

__all__ = ["canonicalize_scene", "infer_renumbered_grid", "infer_subgrid_embedding"]

# corner pairs (a, b) with corner_b = corner_a + unit step along axis,
# in the _CORNERS order (0,0,0),(0,0,1),(0,1,1),(0,1,0),(1,0,0),(1,0,1),
# (1,1,1),(1,1,0) = (cz, cy, cx)
_X_EDGES = ((0, 1), (3, 2), (4, 5), (7, 6))
_Y_EDGES = ((0, 3), (1, 2), (4, 7), (5, 6))
_Z_EDGES = ((0, 4), (1, 5), (2, 6), (3, 7))


def _successors(el: np.ndarray, pairs, N: int) -> Optional[np.ndarray]:
    """Per-node successor along one axis, or None on any inconsistency
    (two elements disagreeing about a node's neighbour = not a grid)."""
    s = np.full(N, -1, np.int64)
    for a, b in pairs:
        s[el[:, a]] = el[:, b]
    for a, b in pairs:  # re-check: later writes must agree with all edges
        if not np.array_equal(s[el[:, a]], el[:, b]):
            return None
    return s


def _chain_positions(s: np.ndarray, N: int) -> Optional[np.ndarray]:
    """Position of each node in its successor chain (0 at the head), or
    None if the chains are malformed (cycles / shared tails)."""
    has_pred = np.zeros(N, bool)
    valid = s >= 0
    has_pred[s[valid]] = True
    # a node that is the successor of two nodes means shared tails
    counts = np.bincount(s[valid], minlength=N)
    if counts.max(initial=0) > 1:
        return None
    pos = np.full(N, -1, np.int64)
    frontier = np.nonzero(~has_pred)[0]
    pos[frontier] = 0
    step = 0
    while frontier.size:
        step += 1
        if step > N:
            return None  # cycle
        nxt = s[frontier]
        frontier = nxt[nxt >= 0]
        if frontier.size:
            if (pos[frontier] >= 0).any():
                return None
            pos[frontier] = step
    if (pos < 0).any():
        return None
    return pos


def infer_renumbered_grid(scene: Scene):
    """``(dims, perm)`` if the connectivity is a box grid under SOME node
    renumbering (``perm[n]`` is node n's canonical grid id), else None.
    The permutation is verified exactly before it is returned."""
    if scene.family != "hex8":
        return None
    el = scene.host_elements
    if el.ndim != 2 or el.shape[1] != 8 or el.shape[0] == 0:
        return None
    N = scene.n_nodes
    sx = _successors(el, _X_EDGES, N)
    sy = _successors(el, _Y_EDGES, N)
    sz = _successors(el, _Z_EDGES, N)
    if sx is None or sy is None or sz is None:
        return None
    ix = _chain_positions(sx, N)
    iy = _chain_positions(sy, N)
    iz = _chain_positions(sz, N)
    if ix is None or iy is None or iz is None:
        return None
    X, Y, Z = int(ix.max()) + 1, int(iy.max()) + 1, int(iz.max()) + 1
    if X * Y * Z != N or min(X, Y, Z) < 2:
        return None
    perm = iz * (X * Y) + iy * X + ix
    seen = np.zeros(N, bool)
    seen[perm] = True
    if not seen.all():
        return None
    nx, ny, nz = X - 1, Y - 1, Z - 1
    if el.shape[0] != nx * ny * nz:
        return None
    # exact verification: canonical connectivity, element rows ordered
    # by their min-corner coordinate
    el_mapped = perm[el]
    order = np.argsort(iz[el[:, 0]] * (nx * ny) + iy[el[:, 0]] * nx + ix[el[:, 0]], kind="stable")
    if not np.array_equal(el_mapped[order], _expected_box_elements(nx, ny, nz)):
        return None
    return (nx, ny, nz), perm


def canonicalize_scene(scene: Scene, dims, perm: np.ndarray) -> Scene:
    """The scene with nodes re-ordered into canonical grid order (node n
    moves to row ``perm[n]``) and the verified canonical connectivity, in
    the scene's dtype on its device; solutions map back as
    ``u_orig = u_canon[perm]``."""
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size)
    idx = lambda t: None if t is None else t.cpu().numpy()[inv]  # noqa: E731
    return make_scene(
        idx(scene.nodes), _expected_box_elements(*dims), idx(scene.fixed), idx(scene.loads),
        scene.material, prescribed=idx(scene.prescribed), dtype=scene.nodes.dtype,
        device=scene.device,
    )


def infer_subgrid_embedding(scene: Scene):
    """``(dims, lat, valid)`` if the connectivity embeds into a box grid as a
    subset of its cells (L-domains, steps, holes), else None: ``dims`` the
    box's element counts (nx, ny, nz), ``lat`` (N,) each node's flat lattice
    id in box node order, ``valid`` (nz, ny, nx) the present cells.

    Index arithmetic only, with the result of ``fea_tpu/ops/canonical.py::
    infer_subgrid_embedding``: each element's corner order pins its base
    cell from any one known corner, so lattice coordinates spread from
    element 0. The reference sweeps every element once a lattice step (230
    sweeps of 172,800 elements, 29 s on the host, for bench.py's arbitrary
    scene); here each sweep places only the elements that touch the nodes
    placed by the one before. Any disagreement (two elements placing a node
    differently, two nodes on one site, a disconnected mesh, a repeated
    cell) returns None.
    """
    from .structured import _CORNERS

    if scene.family != "hex8":
        return None
    el = scene.host_elements
    if el.ndim != 2 or el.shape[1] != 8 or el.shape[0] == 0:
        return None
    E, N = el.shape[0], scene.n_nodes
    offs = np.array([(cx, cy, cz) for (cz, cy, cx) in _CORNERS], np.int64)  # (ix, iy, iz) a corner
    unset = np.iinfo(np.int64).min
    # the elements of each node: slots order[start[n]:start[n + 1]] of el.ravel()
    flat = el.reshape(-1)
    order = np.argsort(flat, kind="stable")
    start = np.zeros(N + 1, np.int64)
    np.cumsum(np.bincount(flat, minlength=N), out=start[1:])
    coords = np.full((N, 3), unset, np.int64)
    placed = np.zeros(E, bool)
    coords[el[0, 0]] = 0
    frontier = el[:1, 0]
    while frontier.size:
        counts = start[frontier + 1] - start[frontier]
        slots = np.repeat(start[frontier] - np.cumsum(counts) + counts, counts) + np.arange(counts.sum())
        cand = np.unique(order[slots] // 8)
        cand = cand[~placed[cand]]
        if not cand.size:
            break
        c_el = coords[el[cand]]  # (C, 8, 3), at least one corner known
        known = c_el[:, :, 0] != unset
        first = known.argmax(axis=1)
        base = c_el[np.arange(cand.size), first] - offs[first]
        # every known corner must imply the same base cell
        if (known & (c_el - offs[None] != base[:, None]).any(axis=2)).any():
            return None
        tgt = el[cand].reshape(-1)
        vals = (base[:, None] + offs[None]).reshape(-1, 3)
        new = ~known.reshape(-1)
        tgt, vals = tgt[new], vals[new]
        # two elements of this sweep placing one node must agree
        o = np.argsort(tgt, kind="stable")
        tgt, vals = tgt[o], vals[o]
        same = tgt[1:] == tgt[:-1]
        if (vals[1:][same] != vals[:-1][same]).any():
            return None
        coords[tgt] = vals
        placed[cand] = True
        frontier = np.unique(tgt)
    if not placed.all() or (coords[:, 0] == unset).any():
        return None  # disconnected, or a node of no element
    c_el = coords[el]
    if (c_el - offs[None] != (c_el[:, 0] - offs[0])[:, None]).any():
        return None
    coords -= coords.min(axis=0)
    X, Y, Z = (int(m) + 1 for m in coords.max(axis=0))
    if min(X, Y, Z) < 2:
        return None
    lat = coords[:, 2] * (X * Y) + coords[:, 1] * X + coords[:, 0]
    if np.unique(lat).size != N:
        return None
    nx, ny, nz = X - 1, Y - 1, Z - 1
    c0 = coords[el[:, 0]]
    cell = c0[:, 2] * (ny * nx) + c0[:, 1] * nx + c0[:, 0]
    if np.unique(cell).size != E:
        return None
    valid = np.zeros(nz * ny * nx, bool)
    valid[cell] = True
    return (nx, ny, nz), lat, valid.reshape(nz, ny, nx)
