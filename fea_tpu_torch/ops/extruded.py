"""Semi-structured operator for extruded (layer-major) hex8 meshes.

A tube and any other section extruded along z with uniform spacing
(``mesh.extrude_quads``): node ``layer * n2 + i`` sits at section node
``i``, layer ``layer``, and every element is a section quad spanning two
adjacent layers. All layers are congruent, so the operator keeps one
24x24 Ke per SECTION QUAD, (Q2, 24, 24), and its apply is

  * a small gather of the section corners of every layer,
  * one batched product over the Q2 quads (``torch.bmm`` in the
    operator's dtype; torch's default keeps TF32 off for it),
  * and an accumulate by the padded section incidence, a masked
    gather-sum in a fixed order (no ``index_add_``, whose atomics sum in
    no fixed order, so a CUDA-graph replay is bit for bit the last).

The field is the (L, n2, 3) view of the layer-major (N, 3) vector. That
is the plain version, the CPU path; on the card ``apply`` and ``apply_raw``
launch the hand-written kernel E (``ops/cuda_extruded.py``,
``csrc/extruded.cu``: the whole masked apply in one launch) or raise, and
the layer-slab path of ``parallel/extruded.py`` keeps the plain pieces
``_element_forces`` / ``_accumulate``. The reference has no Pallas kernel
on this route. Counterpart of
``fea_tpu/ops/extruded.py``, with the detectors ``infer_extruded`` and
``extruded_mg_coarsenable``; its interface is StiffnessOperator's
(apply / apply_raw / rhs / diag_masked / free / n_dof), so
``solve_operator`` and the staged FCG loop take it as it stands. The
z-semicoarsened preconditioner is ``ops/extruded_mg.py``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from ..dtypes import torch_dtype
from ..elements import hex8 as hex8_el
from ..scene import Scene
from ..utils.profiling import span
from . import cuda_extruded

__all__ = [
    "ExtrudedOperator",
    "build_extruded_operator",
    "extruded_mg_coarsenable",
    "extruded_scene_tube",
    "infer_extruded",
]


def _section_incidence(quads: np.ndarray, n2: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Section node -> (quad, corner) incidence lists, padded to the
    largest valence: the scatter-add as a masked gather-sum (fixed order,
    no atomics)."""
    lists: list[list[tuple[int, int]]] = [[] for _ in range(n2)]
    for q, quad in enumerate(quads):
        for c, n in enumerate(quad):
            lists[int(n)].append((q, c))
    V = max(len(l) for l in lists)
    inc_q = np.zeros((n2, V), np.int64)
    inc_c = np.zeros((n2, V), np.int64)
    inc_m = np.zeros((n2, V), np.float64)
    for n, l in enumerate(lists):
        for j, (q, c) in enumerate(l):
            inc_q[n, j] = q
            inc_c[n, j] = c
            inc_m[n, j] = 1.0
    return inc_q, inc_c, inc_m


@dataclasses.dataclass(frozen=True)
class ExtrudedOperator:
    """Extruded-mesh stiffness operator: a per-section-quad Ke batch."""

    kes: torch.Tensor  # (Q2, 24, 24) per-quad reference Ke
    quads: torch.Tensor  # (Q2, 4) int64 section connectivity
    free: torch.Tensor  # (N, 3) free-DOF mask, N = L * n2
    inc_q: torch.Tensor  # (n2, V) int64 incidence: quad index
    inc_c: torch.Tensor  # (n2, V) int64 incidence: corner index
    inc_m: torch.Tensor  # (n2, V, 1) 0/1 incidence mask, the kes' dtype
    n2: int  # nodes a layer
    n_layers: int  # node layers L

    geom = None  # detJ validated at build time on the host

    @classmethod
    def from_numpy(cls, kes: np.ndarray, quads: np.ndarray, free: np.ndarray, *, n_layers: int,
                   device) -> "ExtrudedOperator":
        """The operator of host arrays (for example ``fea_tpu``'s
        operator's ``kes``, ``quads`` and ``free``, pulled to the host), in
        the dtype of ``kes`` on ``device``."""
        kes = np.asarray(kes)
        free = np.asarray(free).reshape(-1, 3)
        return _make(kes, np.asarray(quads, np.int64), free, free.shape[0] // n_layers, n_layers,
                     torch_dtype(kes.dtype), torch.device(device))

    @property
    def n_nodes(self) -> int:
        return self.n2 * self.n_layers

    @property
    def dofs_per_node(self) -> int:
        return 3

    @property
    def n_dof(self) -> int:
        return 3 * self.n_nodes

    @property
    def dtype(self) -> torch.dtype:
        return self.kes.dtype

    def astype(self, dtype: torch.dtype) -> "ExtrudedOperator":
        return dataclasses.replace(self, kes=self.kes.to(dtype), free=self.free.to(dtype),
                                   inc_m=self.inc_m.to(dtype))

    def _element_forces(self, g: torch.Tensor) -> torch.Tensor:
        """g (L, n2, 3) -> per-element forces (Q2, L - 1, 24), for any
        number of consecutive node layers L (a slab of the mesh too)."""
        uq = g[:, self.quads].reshape(g.shape[0], -1, 12)  # (L, Q2, 12): 4 corners x 3
        ue = torch.cat([uq[:-1], uq[1:]], dim=2)  # (L-1, Q2, 24): bottom corners, then top
        # one batched product for every element: fe[q, l] = Ke_q ue[l, q]
        return torch.bmm(ue.transpose(0, 1), self.kes.to(g.dtype).transpose(1, 2))

    def _accumulate(self, fe: torch.Tensor) -> torch.Tensor:
        """(Q2, L - 1, 24) element forces -> (L, n2, 3) nodal forces."""
        fe = fe.reshape(fe.shape[0], fe.shape[1], 8, 3)
        m = self.inc_m.to(fe.dtype)

        def acc(part):  # (Q2, L-1, 4, 3) -> (L-1, n2, 3), summed over the valence in order
            return (part[self.inc_q, :, self.inc_c] * m[:, :, None]).sum(dim=1).transpose(0, 1)

        out = fe.new_zeros((fe.shape[1] + 1, self.n2, 3))
        out[:-1] = acc(fe[:, :, :4])  # bottom-face contributions -> layer l
        out[1:] += acc(fe[:, :, 4:])  # top-face contributions -> layer l + 1
        return out

    @functools.cached_property
    def _tile_plans(self) -> dict:
        """Kernel E's plans and laid-out Ke (``cuda_extruded._tables``),
        made at the first apply on the card and kept with the operator."""
        return {}

    def apply_raw(self, u: torch.Tensor) -> torch.Tensor:
        """K @ u over all DOFs. u (N, 3) flat -> (N, 3) flat: kernel E for a
        CUDA tensor, the plain version for a CPU one."""
        if u.is_cuda:
            return cuda_extruded.extruded_apply(self, u, masked=False)
        g = u.reshape(self.n_layers, self.n2, 3)
        return self._accumulate(self._element_forces(g)).reshape(-1, 3)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """F * K (F * x) + (1 - F) * x: kernel E for a CUDA tensor, the plain
        version for a CPU one."""
        if x.is_cuda:
            return cuda_extruded.extruded_apply(self, x, masked=True)
        F = self.free.to(x.dtype)
        return F * self.apply_raw(F * x) + (1.0 - F) * x

    def rhs(self, loads: torch.Tensor, prescribed: torch.Tensor) -> torch.Tensor:
        F = self.free.to(loads.dtype)
        xp = (1.0 - F) * prescribed.to(loads.dtype)
        return F * (loads - self.apply_raw(xp)) + xp

    def diag_raw(self) -> torch.Tensor:
        """Assembled stiffness diagonal (N, 3)."""
        kd = torch.diagonal(self.kes, dim1=1, dim2=2).reshape(-1, 8, 3)  # (Q2, 8, 3)
        m = self.inc_m.to(kd.dtype)

        def acc(part):  # (Q2, 4, 3) -> (n2, 3)
            return (part[self.inc_q, self.inc_c] * m).sum(dim=1)

        b = acc(kd[:, :4])  # from the element layer above a node layer
        t = acc(kd[:, 4:])  # from the element layer below
        d = (b + t)[None].repeat(self.n_layers, 1, 1)
        d[0] = b
        d[-1] = t
        return d.reshape(-1, 3)

    def diag_masked(self) -> torch.Tensor:
        F = self.free
        return F * self.diag_raw() + (1.0 - F)


def _make(kes: np.ndarray, quads: np.ndarray, free, n2: int, n_layers: int, dtype: torch.dtype,
          device: torch.device) -> ExtrudedOperator:
    inc_q, inc_c, inc_m = _section_incidence(quads, n2)
    t = lambda a, dt: torch.tensor(np.asarray(a), device=device).to(dt)  # noqa: E731
    return ExtrudedOperator(
        kes=t(kes, dtype),
        quads=t(quads, torch.int64),
        free=free.to(device=device, dtype=dtype) if isinstance(free, torch.Tensor) else t(free, dtype),
        inc_q=t(inc_q, torch.int64),
        inc_c=t(inc_c, torch.int64),
        inc_m=t(inc_m[:, :, None], dtype),
        n2=n2,
        n_layers=n_layers,
    )


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


def integrate_section_kes(section: np.ndarray, quads: np.ndarray, h: float, material) -> np.ndarray:
    """(Q2, 24, 24) f64 Ke of every section quad extruded by ``h``, on the
    host (O(Q2) work: all layers are congruent under uniform z spacing).
    Raises ValueError for an inverted or degenerate quad (a non-positive
    cross product of its section edges at corner 0)."""
    kes = np.empty((quads.shape[0], 24, 24))
    for q, quad in enumerate(quads):
        sec = section[quad, :2]  # (4, 2)
        v1 = sec[1] - sec[0]
        v2 = sec[3] - sec[0]
        if v1[0] * v2[1] - v1[1] * v2[0] <= 0:
            raise ValueError(f"section quad {q} is inverted or degenerate")
        corners = np.concatenate([np.column_stack([sec, np.zeros(4)]), np.column_stack([sec, np.full(4, h)])])
        kes[q] = hex8_el.stiffness_matrix_np(corners, material)
    return kes


@span("fea.build.operator")
def build_extruded_operator(
    scene: Scene,
    detected: Optional[tuple[np.ndarray, int, int]] = None,
    dtype: torch.dtype = torch.float32,
) -> ExtrudedOperator:
    """Operator for a layer-major extruded scene, on the scene's device.

    Integrates one f64 Ke per section quad on the host and raises
    ValueError for an inverted or degenerate section quad.
    """
    detected = detected if detected is not None else infer_extruded(scene)
    if detected is None:
        raise ValueError(
            "scene is not a layer-major uniform extrusion; build it with "
            "fea_tpu_torch.mesh.extrude_quads (reference stack_faces_2d ordering)"
        )
    quads, n2, L = detected
    quads = np.asarray(quads, np.int64)
    grid = scene.host_nodes.reshape(L, n2, 3)
    h = float(grid[1, 0, 2] - grid[0, 0, 2])
    kes = integrate_section_kes(grid[0], quads, h, scene.material)
    return _make(kes, quads, scene.free_mask(dtype), n2, L, torch_dtype(dtype), scene.device)


def extruded_scene_tube(
    n_segments: int,
    n_layers_el: int,
    inner_radius: float,
    outer_radius: float,
    length: float,
    material,
    *,
    dtype: torch.dtype = torch.float64,
    device=None,
):
    """The reference's tube (an annulus extruded along z) at any
    resolution: the z == 0 ring fixed, no loads, on ``device`` (the card
    unless asked otherwise). Returns (scene, detected), where
    ``detected`` feeds :func:`build_extruded_operator`."""
    from ..mesh import annulus_section, extrude_quads
    from ..scene import fix_where, make_scene

    nodes2d, quads = annulus_section(n_segments, inner_radius, outer_radius)
    nodes, elements = extrude_quads(nodes2d, quads, np.linspace(0.0, length, n_layers_el + 1))
    fix = fix_where(nodes, lambda p: p[:, 2] == 0.0, 3)
    scene = make_scene(nodes, elements, fix, np.zeros_like(nodes), material, dtype=dtype, device=device)
    return scene, (quads.astype(np.int64), nodes2d.shape[0], n_layers_el + 1)
