"""The element-by-element global stiffness operator, with masking.

K is never formed: an apply is

    gather u_e  ->  element apply  ->  incidence-plan scatter

which is O(E) memory. Boundary conditions are applied by masking: with
F the 0/1 free-DOF mask and x_p the prescribed values,

    A(x) = F . K(F . x) + (1-F) . x          (constrained rows = identity)
    b    = F . (loads - K((1-F) . x_p)) + (1-F) . x_p

and A u = b gives the reduced system's solution on the free DOFs and
u = x_p on the fixed ones.

Three element applies, chosen when the operator is built:

  * ``hex8_matfree``: the quadrature-level apply from precomputed
    gradients (torch einsums; the JAX package has no kernel for it);
  * ``stored``: an (E, k, k) Ke batch, K6 on the card (beams, bars, a
    prebuilt hex8 Ke batch);
  * ``uniform``: one (k, k) Ke shared by every element of a congruent
    (voxel) mesh, K7 on the card.

Counterpart of ``fea_tpu/operator.py``. Its ``use_pallas`` switch has no
counterpart: on a CUDA tensor the ``stored`` and ``uniform`` applies are
K6 and K7 (``ops/cuda_apply.py``), and on a CPU tensor their plain
versions.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from . import assembly
from .elements import beam as beam_el
from .elements import hex8 as hex8_el
from .elements import truss as truss_el
from .materials import Material
from .ops.cuda_apply import batched_matvec_stored, batched_matvec_uniform
from .scene import FAMILIES, Scene, resolve_device
from .utils.profiling import span

__all__ = ["StiffnessOperator", "build_operator", "operator_from_numpy"]

KINDS = ("hex8_matfree", "stored", "uniform")


@dataclasses.dataclass(frozen=True)
class StiffnessOperator:
    """Matrix-free K with boundary-condition masking, every tensor on one
    device.

    :meth:`apply_raw` is K @ u over all DOFs (reactions); :meth:`apply` is
    the masked operator that CG runs on.
    """

    elements: torch.Tensor  # (E, npe) int64
    free: torch.Tensor  # (N, dpn) compute dtype: 1.0 free, 0.0 fixed
    plan: Optional[assembly.IncidencePlan]
    kind: str
    # the payload of the kind: geom and material (hex8_matfree) or ke
    geom: Optional[hex8_el.Hex8Geometry] = None
    material: Optional[Material] = None
    ke: Optional[torch.Tensor] = None  # (E, k, k) stored | (k, k) uniform
    # optional (E,) 0/1 element validity: slots with 0 add no force
    valid: Optional[torch.Tensor] = None
    # element chunk of the matfree apply (None: all at once); tests pin
    # chunked == unchunked with it
    matfree_chunk: Optional[int] = None

    @property
    def n_nodes(self) -> int:
        return self.free.shape[0]

    @property
    def dofs_per_node(self) -> int:
        return self.free.shape[1]

    @property
    def n_dof(self) -> int:
        return self.free.shape[0] * self.free.shape[1]

    @property
    def dtype(self) -> torch.dtype:
        return self.free.dtype

    def astype(self, dtype: torch.dtype) -> "StiffnessOperator":
        """The same operator with its float payloads cast to ``dtype``."""
        cast = lambda t: None if t is None else t.to(dtype)  # noqa: E731
        plan = self.plan
        if plan is not None:
            plan = dataclasses.replace(plan, mask=plan.mask.to(dtype))
        return dataclasses.replace(
            self,
            free=self.free.to(dtype),
            geom=None if self.geom is None else self.geom.astype(dtype),
            plan=plan,
            ke=cast(self.ke),
            valid=cast(self.valid),
        )

    # -- element-level apply ------------------------------------------------
    def _element_apply(self, u_e: torch.Tensor) -> torch.Tensor:
        """(E, npe, dpn) -> (E, npe, dpn) element force contributions."""
        E, npe, dpn = u_e.shape
        if self.kind == "hex8_matfree":
            chunk = self.matfree_chunk
            if chunk is not None and E > chunk:
                f = torch.cat([
                    hex8_el.apply_elements(
                        hex8_el.Hex8Geometry(self.geom.grads[s : s + chunk], self.geom.wdetj[s : s + chunk],
                                             self.geom.min_detj),
                        u_e[s : s + chunk], self.material,
                    )
                    for s in range(0, E, chunk)
                ])
            else:
                f = hex8_el.apply_elements(self.geom, u_e, self.material)
            f = f.reshape(E, npe * dpn)
        elif self.kind == "uniform":
            f = batched_matvec_uniform(self.ke, u_e.reshape(E, npe * dpn).to(self.ke.dtype))
        elif self.kind == "stored":
            f = batched_matvec_stored(self.ke, u_e.reshape(E, npe * dpn).to(self.ke.dtype))
        else:
            raise ValueError(f"unknown operator kind {self.kind!r}")
        if self.valid is not None:
            f = f * self.valid[:, None]
        return f.reshape(E, npe, dpn)

    # -- global applies -----------------------------------------------------
    def apply_raw(self, u: torch.Tensor) -> torch.Tensor:
        """K @ u over all DOFs, no masking. u, result: (N, dpn)."""
        f_e = self._element_apply(assembly.gather_element_dofs(u, self.elements))
        if self.plan is not None:
            return self.plan.scatter_add(f_e.reshape(-1)).reshape(self.free.shape)
        return assembly.scatter_add_direct(f_e, self.elements, self.n_nodes)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """Masked operator A(x) = F.K(F.x) + (1-F).x: SPD on the free
        DOFs, the identity on the fixed ones."""
        F = self.free.to(x.dtype)
        return F * self.apply_raw(F * x) + (1.0 - F) * x

    def rhs(self, loads: torch.Tensor, prescribed: torch.Tensor) -> torch.Tensor:
        """Right-hand side consistent with :meth:`apply` (module doc)."""
        F = self.free.to(loads.dtype)
        xp = (1.0 - F) * prescribed.to(loads.dtype)
        return F * (loads - self.apply_raw(xp)) + xp

    # -- preconditioning ----------------------------------------------------
    def diag_raw(self) -> torch.Tensor:
        """Assembled diagonal of K, (N, dpn): the Jacobi preconditioner."""
        E, npe = self.elements.shape
        dpn = self.dofs_per_node
        if self.kind == "hex8_matfree":
            d_e = hex8_el.diagonal(self.geom, self.material)
        elif self.kind == "uniform":
            d_e = torch.diagonal(self.ke).expand(E, npe * dpn).reshape(E, npe, dpn)
        else:
            d_e = torch.diagonal(self.ke, dim1=-2, dim2=-1).reshape(E, npe, dpn)
        if self.valid is not None:
            d_e = d_e * self.valid[:, None, None]
        if self.plan is not None:
            return self.plan.scatter_add(d_e.reshape(-1)).reshape(self.free.shape)
        return assembly.scatter_add_direct(d_e, self.elements, self.n_nodes)

    def block_diag_raw(self) -> torch.Tensor:
        """Assembled nodal diagonal blocks of K, (N, dpn, dpn): the data of
        the block-Jacobi preconditioner, one extra element pass and no
        (E, 24, 24) batch for the matfree kind."""
        E, npe = self.elements.shape
        dpn = self.dofs_per_node
        if self.kind == "hex8_matfree":
            b_e = hex8_el.block_diagonal(self.geom, self.material)
        elif self.kind == "uniform":
            k4 = self.ke.reshape(npe, dpn, npe, dpn)
            # corner-diagonal blocks ke[a, :, a, :] -> (npe, dpn, dpn)
            b_e = torch.diagonal(k4, dim1=0, dim2=2).permute(2, 0, 1).expand(E, npe, dpn, dpn)
        else:
            k5 = self.ke.reshape(E, npe, dpn, npe, dpn)
            b_e = torch.diagonal(k5, dim1=1, dim2=3).permute(0, 3, 1, 2)
        if self.valid is not None:
            b_e = b_e * self.valid[:, None, None, None]
        blocks = assembly.scatter_add_direct(b_e.reshape(E, npe, dpn * dpn), self.elements, self.n_nodes)
        return blocks.reshape(self.n_nodes, dpn, dpn)

    def block_diag_inv_masked(self) -> torch.Tensor:
        """Inverted nodal diagonal blocks of the MASKED operator,
        (N, dpn, dpn): diag(F) B diag(F) + diag(1-F) per node, SPD by
        construction, inverted in closed form (adjugate / det)."""
        B = self.block_diag_raw()
        F = self.free.to(B.dtype)  # (N, dpn)
        dpn = self.dofs_per_node
        eye = torch.eye(dpn, dtype=B.dtype, device=B.device)
        Bm = F[:, :, None] * B * F[:, None, :] + (1.0 - F)[:, :, None] * eye
        # a free DOF with no element keeps a zero row after masking:
        # regularized to the identity, as diag_masked does
        zero = torch.diagonal(Bm, dim1=-2, dim2=-1) <= 0
        Bm = torch.where(zero[:, :, None] | zero[:, None, :], (zero[:, :, None] & (eye > 0)).to(B.dtype), Bm)
        if dpn == 3:
            return hex8_el._inv3(Bm, hex8_el._det3(Bm))
        if dpn == 2:
            det = Bm[:, 0, 0] * Bm[:, 1, 1] - Bm[:, 0, 1] * Bm[:, 1, 0]
            adj = torch.stack([
                torch.stack([Bm[:, 1, 1], -Bm[:, 0, 1]], dim=-1),
                torch.stack([-Bm[:, 1, 0], Bm[:, 0, 0]], dim=-1),
            ], dim=-2)
            return adj / det[:, None, None]
        raise ValueError(f"block_diag_inv_masked: no closed form for {dpn} DOFs a node")

    def diag_masked(self) -> torch.Tensor:
        """Diagonal of the masked operator: K's diagonal on the free DOFs,
        1 on the fixed ones."""
        F = self.free
        return F * self.diag_raw() + (1.0 - F)

    # -- explicit matrices (small systems / oracles) -------------------------
    def element_matrices(self) -> torch.Tensor:
        """(E, k, k) explicit Ke batch, whatever the kind."""
        E, npe = self.elements.shape
        k = npe * self.dofs_per_node
        if self.kind == "hex8_matfree":
            return hex8_el.stiffness_from_geometry(self.geom, self.material)
        if self.kind == "uniform":
            return self.ke.expand(E, k, k)
        return self.ke

    def dense(self) -> torch.Tensor:
        """Dense global K (ndof, ndof): small systems only."""
        return assembly.assemble_dense(self.element_matrices(), self.elements, self.dofs_per_node, self.n_dof)


def _elements_congruent(nodes: np.ndarray, elements: np.ndarray, tol: float = 1e-9) -> bool:
    """True when every element is a translate of element 0 (voxel meshes)."""
    X = nodes[elements]  # (E, npe, dim)
    rel = X - X[:, :1, :]
    scale = max(float(np.max(np.abs(rel[0]))), 1e-30)
    return bool(np.max(np.abs(rel - rel[0])) <= tol * scale)


@span("fea.build.operator")
def build_operator(
    scene: Scene,
    dtype: torch.dtype = torch.float32,
    use_plan: bool = True,
    uniform: bool | str = "auto",
) -> StiffnessOperator:
    """The stiffness operator of ``scene``, on the scene's device, in
    ``dtype``.

    The host work (the incidence plan, the congruence test) runs here,
    once per topology. A congruent hex8 mesh (``uniform="auto"``) gets
    the ``uniform`` kind, its one Ke integrated on the host in f64 and
    then cast; any other hex8 mesh gets ``hex8_matfree``; beams and bars
    get ``stored``.
    """
    fam = FAMILIES[scene.family]
    dev = scene.device
    elements_np = scene.host_elements
    nodes_np = scene.host_nodes
    plan = (
        assembly.build_incidence_plan(elements_np, fam.dofs_per_node, scene.n_nodes, dtype=dtype, device=dev)
        if use_plan else None
    )
    base = dict(elements=scene.elements, free=scene.free_mask(dtype), plan=plan)
    nodes = scene.nodes.to(dtype)

    if scene.family == "hex8":
        is_uniform = _elements_congruent(nodes_np, elements_np) if uniform == "auto" else bool(uniform)
        if is_uniform:
            ke = hex8_el.stiffness_matrix_np(nodes_np[elements_np[0]].astype(np.float64), scene.material)
            return StiffnessOperator(**base, kind="uniform", ke=torch.as_tensor(ke, device=dev).to(dtype))
        geom = hex8_el.precompute_geometry(nodes, scene.elements, dtype=dtype)
        return StiffnessOperator(**base, kind="hex8_matfree", geom=geom, material=scene.material)

    if scene.family == "eb_beam":
        L_np = nodes_np.reshape(-1)[elements_np[:, 1]] - nodes_np.reshape(-1)[elements_np[:, 0]]
        if np.any(L_np <= 0):
            bad = int(np.argmax(L_np <= 0))
            raise ValueError(
                f"beam element {bad} has non-positive length {L_np[bad]:g}; "
                "node order per element must be (left, right)"
            )
        inertia = scene.section if scene.section is not None else 1.0
        ke = beam_el.stiffness_matrices(nodes, scene.elements, scene.material, inertia).to(dtype)
        return StiffnessOperator(**base, kind="stored", ke=ke)

    if scene.family in ("bar2d", "bar3d"):
        if scene.section is None:
            raise ValueError("bar scenes require section = axial stiffness k per element")
        ke = truss_el.stiffness_matrices(nodes, scene.elements, scene.section).to(dtype)
        return StiffnessOperator(**base, kind="stored", ke=ke)

    raise ValueError(f"unsupported family {scene.family!r}")


def operator_from_numpy(
    kind: str,
    elements,
    free,
    *,
    ke=None,
    grads=None,
    wdetj=None,
    material: Optional[Material] = None,
    valid=None,
    device=None,
) -> StiffnessOperator:
    """An operator from the NumPy arrays of another one (for example a
    ``fea_tpu`` operator pulled to the host), in the floating dtype of
    ``free``, on ``device`` (the card unless the caller asks for the
    CPU). The incidence plan is rebuilt from ``elements``."""
    if kind not in KINDS:
        raise ValueError(f"unknown operator kind {kind!r}, expected one of {KINDS}")
    dev = resolve_device(device)
    free = torch.tensor(np.asarray(free), device=dev)
    dtype = free.dtype
    elements_np = np.asarray(elements).astype(np.int64)
    as_t = lambda a: None if a is None else torch.tensor(np.asarray(a), device=dev).to(dtype)  # noqa: E731
    geom = None
    if kind == "hex8_matfree":
        w = as_t(wdetj)
        geom = hex8_el.Hex8Geometry(grads=as_t(grads), wdetj=w, min_detj=w.min())
    plan = assembly.build_incidence_plan(elements_np, free.shape[1], free.shape[0], dtype=dtype, device=dev)
    return StiffnessOperator(
        elements=torch.as_tensor(elements_np, device=dev), free=free, plan=plan, kind=kind,
        geom=geom, material=material, ke=as_t(ke), valid=as_t(valid),
    )
