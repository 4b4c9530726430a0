"""Scene description — the data model.

``nodes (N, d)``, ``elements (E, npe)`` integer connectivity, a per-DOF
constraint mask (True = fixed), nodal ``loads (N, dpn)`` and optional
prescribed displacements on the fixed DOFs, as torch tensors on one
device. Counterpart of ``fea_tpu/scene.py``; node order and array
layouts are the JAX package's.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .dtypes import torch_dtype
from .materials import Material

__all__ = [
    "ElementFamily",
    "FAMILIES",
    "Scene",
    "make_scene",
    "scene_from_numpy",
    "fix_where",
    "resolve_device",
    "dof_ids",
]


@dataclasses.dataclass(frozen=True)
class ElementFamily:
    """Static description of an element formulation."""

    name: str
    nodes_per_element: int
    dofs_per_node: int

    @property
    def dofs_per_element(self) -> int:
        return self.nodes_per_element * self.dofs_per_node


FAMILIES: dict[str, ElementFamily] = {
    # 8-node trilinear hexahedron, 3 translational DOFs/node
    "hex8": ElementFamily("hex8", 8, 3),
    # Euler-Bernoulli bending element, (w, theta) per node
    "eb_beam": ElementFamily("eb_beam", 2, 2),
    # Pin-jointed axial bar in 2D / 3D
    "bar2d": ElementFamily("bar2d", 2, 2),
    "bar3d": ElementFamily("bar3d", 2, 3),
}


@dataclasses.dataclass(frozen=True)
class Scene:
    """A complete analysis scene, its tensors on one device.

    ``section`` carries family-specific scalars/arrays: for ``eb_beam``
    the second moment of area I; for bars the axial stiffness inputs.
    """

    nodes: torch.Tensor  # (N, dim) float
    elements: torch.Tensor  # (E, npe) int64
    fixed: torch.Tensor  # (N, dpn) bool — True = constrained
    loads: torch.Tensor  # (N, dpn) float — applied nodal loads
    material: Material
    family: str = "hex8"
    prescribed: Optional[torch.Tensor] = None  # (N, dpn) float, used where fixed
    section: Optional[torch.Tensor] = None  # family-specific section property

    @property
    def element_family(self) -> ElementFamily:
        return FAMILIES[self.family]

    @property
    def device(self) -> torch.device:
        return self.nodes.device

    @property
    def n_nodes(self) -> int:
        return self.nodes.shape[-2]

    @property
    def n_elements(self) -> int:
        return self.elements.shape[-2]

    @property
    def n_dof(self) -> int:
        return self.n_nodes * self.element_family.dofs_per_node

    # The routing detectors read the mesh on the host; each host copy is
    # taken once per scene and tensor version, not once per detector, so a
    # caller's in-place torch edit of the tensor is copied again (an
    # inference tensor, which has no version, is copied once). The package
    # never writes a scene's tensors in place.
    @property
    def host_nodes(self) -> np.ndarray:
        """``nodes`` as a NumPy array."""
        return self._host("nodes")

    @property
    def host_elements(self) -> np.ndarray:
        """``elements`` as a NumPy array."""
        return self._host("elements")

    def _host(self, name: str) -> np.ndarray:
        t = getattr(self, name)
        version = tensor_version(t)
        kept = self.__dict__.get("_host_" + name)  # frozen: set through __dict__, as cached_property does
        if kept is None or kept[0] != version:
            kept = self.__dict__["_host_" + name] = (version, t.cpu().numpy())
        return kept[1]

    def free_mask(self, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """1.0 on free DOFs, 0.0 on fixed."""
        return 1.0 - self.fixed.to(dtype)

    def prescribed_or_zero(self, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        if self.prescribed is None:
            return torch.zeros(self.fixed.shape, dtype=dtype, device=self.device)
        return self.prescribed.to(dtype)

    def to(self, device) -> "Scene":
        """The same scene with every tensor on ``device``."""
        move = lambda t: None if t is None else t.to(device)  # noqa: E731
        return dataclasses.replace(
            self,
            nodes=move(self.nodes),
            elements=move(self.elements),
            fixed=move(self.fixed),
            loads=move(self.loads),
            prescribed=move(self.prescribed),
            section=move(self.section),
        )


def tensor_version(t: torch.Tensor) -> Optional[int]:
    """``t``'s version counter, which every in-place torch operation on it
    or a view of it bumps; None for an inference tensor, which has none."""
    return None if t.is_inference() else t._version


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: ``device`` when given, else the
    CUDA card. Without a card and without an explicit device this
    raises; nothing moves to the CPU unless the caller asks for it."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "fea_tpu_torch runs on a CUDA card by default and none is "
            "available; pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda")


def _tensor(a, dtype, device) -> torch.Tensor:
    """A copy of ``a`` (array-like or tensor) as ``dtype`` on ``device``."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype, copy=True)
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def make_scene(
    nodes,
    elements,
    fixed,
    loads,
    material: Material,
    family: str = "hex8",
    prescribed=None,
    section=None,
    dtype: torch.dtype = torch.float32,
    device=None,
) -> Scene:
    """Build a Scene from host arrays or tensors, normalizing dtypes and
    shapes, with every tensor on ``device``: the CUDA card when None
    (see :func:`resolve_device`), the CPU only when asked for.

    Accepts 0/1 int constraint masks as well as booleans.
    """
    fam = FAMILIES[family]
    nodes = _tensor(nodes, dtype, resolve_device(device))
    device = nodes.device
    elements = _tensor(elements, torch.int64, device)
    fixed = _tensor(fixed, torch.float64, device) != 0
    loads = _tensor(loads, dtype, device)
    if elements.ndim != 2 or elements.shape[1] != fam.nodes_per_element:
        raise ValueError(
            f"elements must be (E, {fam.nodes_per_element}) for family {family}, got {tuple(elements.shape)}"
        )
    if tuple(fixed.shape) != (nodes.shape[0], fam.dofs_per_node):
        raise ValueError(
            f"fixed mask must be (N, {fam.dofs_per_node}), got {tuple(fixed.shape)}"
        )
    if loads.shape != fixed.shape:
        raise ValueError(f"loads must match fixed mask shape {tuple(fixed.shape)}, got {tuple(loads.shape)}")
    if prescribed is not None:
        prescribed = _tensor(prescribed, dtype, device)
    if section is not None:
        section = _tensor(section, dtype, device)
    return Scene(
        nodes=nodes,
        elements=elements,
        fixed=fixed,
        loads=loads,
        material=material,
        family=family,
        prescribed=prescribed,
        section=section,
    )


def scene_from_numpy(
    nodes, elements, fixed, loads, E, nu, prescribed=None, *, family: str = "hex8", section=None, device=None
) -> Scene:
    """A scene from the NumPy arrays of another scene (for example a
    ``fea_tpu`` scene pulled to the host), in the floating dtype of
    ``nodes``, on ``device`` as :func:`make_scene` places it. A scene and
    its material are this system's only parameters, so this carries one
    across whole: a beam or bar scene with its ``family`` and
    ``section``."""
    nodes = np.asarray(nodes)
    return make_scene(
        nodes, elements, fixed, loads, Material(E=float(E), nu=float(nu)), family=family,
        prescribed=prescribed, section=section, dtype=torch_dtype(nodes.dtype), device=device,
    )


def dof_ids(elements: torch.Tensor, dofs_per_node: int) -> torch.Tensor:
    """Element-local to global DOF map, (E, npe * dpn) int64 on the
    elements' device: entry [e, a * dpn + j] = elements[e, a] * dpn + j."""
    E, npe = elements.shape
    offs = torch.arange(dofs_per_node, dtype=torch.int64, device=elements.device)
    return (elements.to(torch.int64)[:, :, None] * dofs_per_node + offs).reshape(E, npe * dofs_per_node)


def fix_where(nodes, predicate, dofs_per_node: int) -> np.ndarray:
    """Constraint-mask builder: fix all DOFs of nodes selected by
    ``predicate(nodes) -> (N,) bool``, as a host (N, dofs_per_node)
    bool array."""
    nodes = nodes.cpu().numpy() if isinstance(nodes, torch.Tensor) else np.asarray(nodes)
    sel = np.asarray(predicate(nodes)).astype(bool)
    mask = np.zeros((nodes.shape[0], dofs_per_node), dtype=bool)
    mask[sel] = True
    return mask
