"""Stencil-form stiffness operator for structured voxel meshes.

On a regular (nx, ny, nz) voxel grid every element shares one 24x24
reference Ke, and the node<->element maps are slice shifts, so K @ u
needs no index arrays at all:

    u grid (Z, Y, X, 3)
      -> u_e = concat of 8 corner-shifted slices      (nz, ny, nx, 24)
      -> f_e = u_e @ Ke^T                             (nz*ny*nx, 24)
      -> f   = sum of 8 corner-shifted slice-adds     (Z, Y, X, 3)

That is :func:`stencil_apply_grid`, the plain torch version of the CUDA
kernels K1 and K2 (:mod:`fea_tpu_torch.ops.cuda_stencil`), which
:class:`StructuredOperator` applies through
:func:`~fea_tpu_torch.ops.cuda_stencil.stencil_apply`;
:func:`stencil_apply_slab_grid` and :func:`stencil_apply_chunked_grid` are
the plain versions of their z-slab forms, K1's halo form and K3. The
NumPy helpers below are the host f64 oracle and the hierarchy builder's
region tables.

Counterpart of ``fea_tpu/ops/structured.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..elements import hex8 as hex8_el
from ..materials import Material
from ..scene import Scene, fix_where, make_scene
from ..utils.profiling import span
from .cuda_stencil import StencilWeights, check_free_mask, stencil_apply, stencil_weights

__all__ = [
    "StructuredOperator",
    "build_structured_operator",
    "structured_scene",
    "infer_box_dims",
    "stencil_apply_chunked_grid",
    "stencil_apply_grid",
    "stencil_apply_np",
    "stencil_apply_slab_grid",
    "stencil_diag_grid",
    "stencil_diag_np",
]

# Corner offsets (dz, dy, dx) in node-grid index space, in the element's
# local node order (bottom face CCW then top face CCW, x fastest, y
# middle, z layer-major — the box_hex_mesh convention).
_CORNERS = (
    (0, 0, 0),
    (0, 0, 1),
    (0, 1, 1),
    (0, 1, 0),
    (1, 0, 0),
    (1, 0, 1),
    (1, 1, 1),
    (1, 1, 0),
)


def stencil_apply_grid(ke: torch.Tensor, g: torch.Tensor, dims: tuple[int, int, int],
                       free: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K @ u in grid space: g (Z, Y, X, 3) -> (Z, Y, X, 3), in g's dtype;
    with a 0/1 mask ``free`` of g's shape, the masked operator
    ``free * K(free * g) + (1 - free) * g``, written out unfused.

    The plain version of K1 (f32) and K2 (f64): 8 corner slice-gathers,
    one (E, 24) @ (24, 24) product, 8 corner slice-adds.
    """
    if free is not None:
        return free * stencil_apply_grid(ke, free * g, dims) + (1.0 - free) * g
    nx, ny, nz = dims
    ke = ke.to(device=g.device, dtype=g.dtype)
    u_e = torch.cat(
        [g[dz : dz + nz, dy : dy + ny, dx : dx + nx, :] for dz, dy, dx in _CORNERS], dim=-1
    )  # (nz, ny, nx, 24)
    f_e = u_e @ ke.T
    f = torch.zeros_like(g)
    for a, (dz, dy, dx) in enumerate(_CORNERS):
        f[dz : dz + nz, dy : dy + ny, dx : dx + nx, :] += f_e[..., 3 * a : 3 * a + 3]
    return f


def stencil_apply_slab_grid(ke: torch.Tensor, g_ext: torch.Tensor, z0: int, z_real: int,
                            free_ext: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K @ u on the planes ``z0 .. z0 + Zl - 1`` of a grid of ``z_real``
    planes, from the halo-extended slab g_ext (Zl + 2, Y, X, 3) that holds
    global planes ``z0 - 1 .. z0 + Zl``: (Zl, Y, X, 3). With ``free_ext``,
    the 0/1 mask on the same planes, those planes of the masked operator
    ``F * K(F * g) + (1 - F) * g``.

    The plain version of K1's halo form (f32) and K3 (f64): the elements
    that touch the slab's planes and exist in the global grid (element
    layers ``max(z0 - 1, 0) .. min(z0 + Zl, z_real - 1) - 1``) go through
    :func:`stencil_apply_grid`. Planes at or past ``z_real`` are zero
    padding, never read, with output 0 (masked: ``(1 - F) * g``).
    """
    if free_ext is not None:
        F = free_ext[1:-1]
        return F * stencil_apply_slab_grid(ke, free_ext * g_ext, z0, z_real) + (1.0 - F) * g_ext[1:-1]
    Zl = g_ext.shape[0] - 2
    Y, X = g_ext.shape[1:3]
    lo, hi = max(z0 - 1, 0), min(z0 + Zl, z_real - 1)  # global element layers [lo, hi)
    out = torch.zeros((Zl,) + tuple(g_ext.shape[1:]), dtype=g_ext.dtype, device=g_ext.device)
    if hi > lo:
        a = lo - (z0 - 1)  # slab index of global plane lo
        f = stencil_apply_grid(ke, g_ext[a : a + hi - lo + 1], (X - 1, Y - 1, hi - lo))  # planes lo..hi
        s, e = max(z0, lo), min(z0 + Zl - 1, hi)
        out[s - z0 : e - z0 + 1] = f[s - lo : e - lo + 1]
    return out


def stencil_apply_chunked_grid(ke: torch.Tensor, g: torch.Tensor, n_chunks: int,
                               free: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K @ u on the whole grid g (Z, Y, X, 3), as :func:`stencil_apply_slab_grid`
    on each of the z chunks of ``cuda_stencil.z_chunk_bounds(Z, n_chunks)``
    with zero planes past the grid's ends, masked by ``free`` as
    :func:`stencil_apply_grid` is: the plain version of
    ``cuda_stencil.stencil_apply_chunked``."""
    from .cuda_stencil import z_chunk_bounds

    Z = g.shape[0]
    zero = torch.zeros_like(g[:1])

    def ext(t, s, e):
        return torch.cat([t[s - 1 : s] if s > 0 else zero, t[s:e], t[e : e + 1] if e < Z else zero])

    slabs = []
    for s, e in z_chunk_bounds(Z, n_chunks):
        slabs.append(stencil_apply_slab_grid(ke, ext(g, s, e), s, Z, None if free is None else ext(free, s, e)))
    return torch.cat(slabs)


def stencil_diag_grid(ke: torch.Tensor, dims: tuple[int, int, int]) -> torch.Tensor:
    """The assembled diagonal of K in grid space, (Z, Y, X, 3), in ke's
    dtype on its device: each element adds the diagonal of its corner's
    3x3 block of Ke into that corner's node, corner by corner. Built once
    an operator, so it is plain torch."""
    nx, ny, nz = dims
    kd = torch.diagonal(ke)
    d = torch.zeros((nz + 1, ny + 1, nx + 1, 3), dtype=ke.dtype, device=ke.device)
    for a, (dz, dy, dx) in enumerate(_CORNERS):
        d[dz : dz + nz, dy : dy + ny, dx : dx + nx, :] += kd[3 * a : 3 * a + 3]
    return d


# -- host-side (NumPy) twins ---------------------------------------------------
# Used at build time (multigrid hierarchy, lambda_max bounds) and as the
# f64 oracle that checks the card's results independently of its kernels.


def corner_table_np(per_row: np.ndarray) -> np.ndarray:
    """(3, 3, 3, 3) region table of assembled per-corner contributions.

    On a full voxel box the assembly of a shared per-element 24-vector
    is constant over the 27 boundary classes (min-face / interior /
    max-face per axis); entry [iz, iy, ix] is that class's 3-vector.
    """
    pr = np.asarray(per_row).reshape(8, 3)

    def exists(axis_class: int, corner_off: int) -> bool:
        # corner offset 0 needs an element above (fails on the max face);
        # offset 1 needs one below (fails on the min face)
        return not ((corner_off == 0 and axis_class == 2) or (corner_off == 1 and axis_class == 0))

    table = np.zeros((3, 3, 3, 3), pr.dtype)
    for iz in range(3):
        for iy in range(3):
            for ix in range(3):
                v = np.zeros(3, pr.dtype)
                for a, (az, ay, ax) in enumerate(_CORNERS):
                    if exists(iz, az) and exists(iy, ay) and exists(ix, ax):
                        v += pr[a]
                table[iz, iy, ix] = v
    return table


def fill_regions_np(table: np.ndarray, dims: tuple[int, int, int]) -> np.ndarray:
    """Broadcast a (3, 3, 3, 3) region table onto the (Z, Y, X, 3) grid."""
    nx, ny, nz = dims
    d = np.empty((nz + 1, ny + 1, nx + 1, 3), table.dtype)
    sl = {0: slice(0, 1), 1: slice(1, -1), 2: slice(-1, None)}
    for iz in range(3):
        for iy in range(3):
            for ix in range(3):
                d[sl[iz], sl[iy], sl[ix], :] = table[iz, iy, ix]
    return d


def stencil_diag_np(ke: np.ndarray, dims: tuple[int, int, int]) -> np.ndarray:
    """NumPy twin of :func:`stencil_diag_grid`, by the 27-region table."""
    return fill_regions_np(corner_table_np(np.ascontiguousarray(np.diagonal(ke))), dims)


def stencil_apply_np(ke: np.ndarray, g: np.ndarray, dims: tuple[int, int, int]) -> np.ndarray:
    """NumPy twin of :func:`stencil_apply_grid` (f64 host oracle)."""
    nx, ny, nz = dims
    f = np.zeros_like(g)
    for a, ca in enumerate(_CORNERS):
        f_a = np.zeros((nz, ny, nx, 3), g.dtype)
        for b, cb in enumerate(_CORNERS):
            dz, dy, dx = cb
            u_b = g[dz : dz + nz, dy : dy + ny, dx : dx + nx, :]
            f_a += u_b @ ke[3 * a : 3 * a + 3, 3 * b : 3 * b + 3].T
        dz, dy, dx = ca
        f += np.pad(f_a, ((dz, 1 - dz), (dy, 1 - dy), (dx, 1 - dx), (0, 0)))
    return f


@dataclasses.dataclass(frozen=True)
class StructuredOperator:
    """Voxel-grid stiffness operator in stencil form."""

    weights: StencilWeights  # the shared reference Ke, (24, 24) and region table
    free: torch.Tensor  # (N, 3) free-DOF mask (flat node order)
    dims: tuple[int, int, int]  # (nx, ny, nz) elements

    @property
    def ke(self) -> torch.Tensor:
        return self.weights.ke

    @property
    def grid_shape(self) -> tuple[int, int, int]:
        nx, ny, nz = self.dims
        return (nz + 1, ny + 1, nx + 1)

    @property
    def n_nodes(self) -> int:
        Z, Y, X = self.grid_shape
        return Z * Y * X

    @property
    def dofs_per_node(self) -> int:
        return 3

    @property
    def n_dof(self) -> int:
        return 3 * self.n_nodes

    def astype(self, dtype: torch.dtype) -> "StructuredOperator":
        """Cast payloads (build at f64, cast down for mixed precision)."""
        return dataclasses.replace(
            self, weights=self.weights.astype(dtype), free=self.free.to(dtype)
        )

    def _grid(self, u: torch.Tensor) -> torch.Tensor:
        Z, Y, X = self.grid_shape
        return u.reshape(Z, Y, X, 3).contiguous()

    def apply_raw(self, u: torch.Tensor) -> torch.Tensor:
        """K @ u over all DOFs.  u (N, 3) flat -> (N, 3) flat."""
        return stencil_apply(self.weights, self._grid(u)).reshape(-1, 3)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """The masked operator F K(F x) + (1 - F) x, one kernel launch on
        the card (the mask is applied inside the stencil)."""
        return stencil_apply(self.weights, self._grid(x), self._grid(self.free.to(x.dtype))).reshape(-1, 3)

    def rhs(self, loads: torch.Tensor, prescribed: torch.Tensor) -> torch.Tensor:
        F = self.free.to(loads.dtype)
        xp = (1.0 - F) * prescribed.to(loads.dtype)
        return F * (loads - self.apply_raw(xp)) + xp

    def diag_raw(self) -> torch.Tensor:
        """The assembled diagonal of K, (N, 3) flat, in the operator's dtype."""
        return stencil_diag_grid(self.ke, self.dims).reshape(-1, 3)

    def diag_masked(self) -> torch.Tensor:
        """The diagonal of the masked operator: K's on free DOFs, 1 on fixed
        ones (the Jacobi preconditioner of the inner solve)."""
        F = self.free
        return F * self.diag_raw() + (1.0 - F)


def _expected_box_elements(nx: int, ny: int, nz: int) -> np.ndarray:
    """box_hex_mesh's connectivity by pure index arithmetic (no nodes)."""
    X, Yn = nx + 1, ny + 1
    i = np.arange(nx, dtype=np.int64)
    j = np.arange(ny, dtype=np.int64)
    k = np.arange(nz, dtype=np.int64)
    base = k[:, None, None] * (Yn * X) + j[None, :, None] * X + i[None, None, :]
    quad = np.stack([base, base + 1, base + X + 1, base + X], axis=-1)
    return np.concatenate([quad, quad + Yn * X], axis=-1).reshape(-1, 8)


def _validate_box_scene(scene: Scene, dims: tuple[int, int, int]) -> None:
    """Raise ValueError unless the scene IS a regular voxel box with
    box_hex_mesh ordering and ``dims`` elements per axis.

    O(N) host arithmetic: the connectivity is compared with the expected
    index pattern, and node positions with the outer-product grid of the
    three axis coordinate vectors, which also certifies element
    congruence (uniform spacing per axis).
    """
    nx, ny, nz = dims
    E = nx * ny * nz
    if scene.n_elements != E:
        raise ValueError(f"scene has {scene.n_elements} elements, dims imply {E}")
    X, Yn, Zn = nx + 1, ny + 1, nz + 1
    if scene.n_nodes != X * Yn * Zn:
        raise ValueError(f"scene has {scene.n_nodes} nodes, dims imply {X * Yn * Zn}")
    if not np.array_equal(scene.host_elements, _expected_box_elements(nx, ny, nz)):
        raise ValueError(
            "scene connectivity does not match the structured voxel grid "
            f"implied by dims={dims}; the stencil operator requires the "
            "box_hex_mesh node/element ordering"
        )
    nodes = scene.host_nodes
    # eps * max|coordinate| rounding (f32-built meshes) is noise, not geometry
    tol = 64.0 * float(np.finfo(nodes.dtype).eps) * max(float(np.max(np.abs(nodes))), 1e-30)
    xs = nodes[:X, 0]
    ys = nodes[: Yn * X : X, 1]
    zs = nodes[:: Yn * X, 2]
    for name, v in (("x", xs), ("y", ys), ("z", zs)):
        d = np.diff(v)
        if d.size == 0 or float(d.min()) <= 0 or float(np.ptp(d)) > 2 * tol:
            raise ValueError(
                f"structured operator requires uniform {name}-spacing "
                "(congruent voxel elements)"
            )
    grid = nodes.reshape(Zn, Yn, X, 3)
    ok = (
        float(np.max(np.abs(grid[..., 0] - xs[None, None, :]))) <= tol
        and float(np.max(np.abs(grid[..., 1] - ys[None, :, None]))) <= tol
        and float(np.max(np.abs(grid[..., 2] - zs[:, None, None]))) <= tol
    )
    if not ok:
        raise ValueError(
            "structured operator requires congruent voxel elements "
            "(node positions must form the regular axis-product grid)"
        )


def infer_box_dims(scene: Scene) -> Optional[tuple[int, int, int]]:
    """(nx, ny, nz) if the scene is a regular voxel box in box_hex_mesh
    ordering, else None.

    Infers the row lengths from where the x/y coordinates wrap, then runs
    the full O(N) validation, so arbitrary hex meshes are never taken for
    a box.
    """
    if scene.family != "hex8":
        return None
    nodes = scene.host_nodes
    x = nodes[:, 0]
    dec = np.nonzero(x[1:] < x[:-1])[0]
    X = int(dec[0]) + 1 if dec.size else nodes.shape[0]
    if X < 2 or nodes.shape[0] % X:
        return None
    y = nodes[::X, 1]
    dec = np.nonzero(y[1:] < y[:-1])[0]
    Yn = int(dec[0]) + 1 if dec.size else y.shape[0]
    if Yn < 2 or nodes.shape[0] % (X * Yn):
        return None
    Zn = nodes.shape[0] // (X * Yn)
    if Zn < 2:
        return None
    dims = (X - 1, Yn - 1, Zn - 1)
    try:
        _validate_box_scene(scene, dims)
    except ValueError:
        return None
    return dims


@span("fea.build.operator")
def build_structured_operator(
    scene: Scene, dims: tuple[int, int, int], dtype: torch.dtype = torch.float32
) -> StructuredOperator:
    """Operator for a voxel scene produced by ``mesh.box_hex_mesh(*dims, ...)``,
    on the scene's device.

    Validates that the scene's connectivity IS the structured grid the
    stencil assumes and that all elements are congruent, then integrates
    the single shared Ke in host NumPy f64 and rounds it to ``dtype``.
    """
    _validate_box_scene(scene, dims)
    X0 = scene.host_nodes[scene.host_elements[0]]  # (8, 3)
    ke = hex8_el.stiffness_matrix_np(X0, scene.material)
    return StructuredOperator(
        weights=stencil_weights(ke, dtype, scene.device),
        free=check_free_mask(scene.free_mask(dtype)),
        dims=dims,
    )


def structured_scene(
    nx: int,
    ny: int,
    nz: int,
    lx: float,
    ly: float,
    lz: float,
    material: Material,
    *,
    fix=None,
    loads=None,
    dtype: torch.dtype = torch.float32,
    device=None,
) -> tuple[Scene, tuple[int, int, int]]:
    """Voxel cantilever scene + dims for the structured operator.
    ``fix``/``loads`` follow :func:`fea_tpu_torch.make_scene`; the default
    fixes the z == 0 face."""
    from ..mesh import box_hex_mesh

    nodes, elements = box_hex_mesh(nx, ny, nz, lx, ly, lz)
    if fix is None:
        fix = fix_where(nodes, lambda p: p[:, 2] == 0.0, 3)
    if loads is None:
        loads = np.zeros_like(nodes)
    scene = make_scene(nodes, elements, fix, loads, material, dtype=dtype, device=device)
    return scene, (nx, ny, nz)
