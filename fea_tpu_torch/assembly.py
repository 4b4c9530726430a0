"""Assembly: element <-> global DOF gather/scatter and global-matrix builders.

The topology is fixed, so what depends on it is computed once on the
host into an index plan, and each operator apply is a gather, the
element apply, and one padded-incidence reduction:

  * gather:  u (N, dpn) -> u_e (E, npe, dpn), a plain index;
  * scatter: the transposed "incidence plan" lists, for every global DOF,
    the (at most ``max_valence``) slots of the flat element-force array
    that sum into it, padded. The scatter is then a gather and a masked
    sum over the valence axis: deterministic, where ``index_add_`` on a
    CUDA tensor sums through atomics in no fixed order.

Explicit global matrices (dense, sparse COO) are for small systems and
oracles only. Counterpart of ``fea_tpu/assembly.py``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .scene import dof_ids

__all__ = [
    "IncidencePlan",
    "assemble_bcoo",
    "assemble_dense",
    "build_incidence_plan",
    "gather_element_dofs",
    "scatter_add_direct",
]


def gather_element_dofs(u: torch.Tensor, elements: torch.Tensor) -> torch.Tensor:
    """u (N, dpn) -> per-element nodal values (E, npe, dpn)."""
    return u[elements]


def scatter_add_direct(f_e: torch.Tensor, elements: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """(E, npe, c) -> (N, c) by ``index_add``: the oracle of the incidence
    plan and the scatter of an operator built without one. On a CUDA
    tensor the order of the sums is not fixed."""
    c = f_e.shape[-1]
    out = torch.zeros((n_nodes, c), dtype=f_e.dtype, device=f_e.device)
    return out.index_add_(0, elements.reshape(-1), f_e.reshape(-1, c))


@dataclasses.dataclass(frozen=True)
class IncidencePlan:
    """Transpose of the element -> DOF map, padded to uniform valence.

    positions: (ndof, max_valence) int64, flat indices into the
               (E * npe * dpn,) element-force array that sum into each
               global DOF (padded entries point at slot 0);
    mask:      (ndof, max_valence) float, 1.0 real, 0.0 pad.
    """

    positions: torch.Tensor
    mask: torch.Tensor

    @property
    def n_dof(self) -> int:
        return self.positions.shape[0]

    def scatter_add(self, f_e_flat: torch.Tensor) -> torch.Tensor:
        """(E * npe * dpn,) flat element forces -> (ndof,) assembled vector."""
        return (f_e_flat[self.positions] * self.mask.to(f_e_flat.dtype)).sum(dim=1)


def build_incidence_plan(
    elements: np.ndarray, dofs_per_node: int, n_nodes: int, *, dtype: torch.dtype = torch.float32, device=None
) -> IncidencePlan:
    """The padded incidence plan, built on the host (one stable argsort of
    the E * npe * dpn slot targets) and placed on ``device`` with its
    mask in ``dtype``."""
    elements = np.asarray(elements)
    targets = (
        elements[:, :, None].astype(np.int64) * dofs_per_node + np.arange(dofs_per_node)[None, None, :]
    ).reshape(-1)
    ndof = n_nodes * dofs_per_node
    order = np.argsort(targets, kind="stable")
    sorted_targets = targets[order]
    counts = np.bincount(sorted_targets, minlength=ndof)
    max_val = int(counts.max()) if counts.size else 0
    positions = np.zeros((ndof, max_val), dtype=np.int64)
    mask = np.zeros((ndof, max_val), dtype=np.float64)
    # slot of each sorted entry within its DOF's run
    starts = np.zeros(ndof + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    slot = np.arange(targets.size, dtype=np.int64) - starts[sorted_targets]
    positions[sorted_targets, slot] = order
    mask[sorted_targets, slot] = 1.0
    return IncidencePlan(
        positions=torch.as_tensor(positions, device=device),
        mask=torch.as_tensor(mask, device=device).to(dtype),
    )


def _pair_indices(elements: torch.Tensor, dofs_per_node: int) -> tuple[torch.Tensor, torch.Tensor]:
    dmap = dof_ids(elements, dofs_per_node)  # (E, k)
    E, k = dmap.shape
    return dmap[:, :, None].expand(E, k, k), dmap[:, None, :].expand(E, k, k)


def assemble_dense(Ke: torch.Tensor, elements: torch.Tensor, dofs_per_node: int, n_dof: int) -> torch.Tensor:
    """Dense global K (n_dof, n_dof) from a batched Ke (E, k, k): small
    systems and oracles only."""
    rows, cols = _pair_indices(elements, dofs_per_node)
    K = torch.zeros((n_dof, n_dof), dtype=Ke.dtype, device=Ke.device)
    return K.index_put_((rows, cols), Ke, accumulate=True)


def assemble_bcoo(Ke: torch.Tensor, elements: torch.Tensor, dofs_per_node: int, n_dof: int) -> torch.Tensor:
    """Sparse global K as a coalesced ``torch.sparse_coo_tensor``
    (duplicates summed): medium systems and export."""
    rows, cols = _pair_indices(elements, dofs_per_node)
    idx = torch.stack([rows.reshape(-1), cols.reshape(-1)])
    return torch.sparse_coo_tensor(idx, Ke.reshape(-1), (n_dof, n_dof), check_invariants=False).coalesce()
