"""The arbitrary-topology routes of ``solve()``: hex8 meshes that no grid
route and no box embedding takes.

* **AMG** (the default): the stiffness assembled into node-major BCSR on
  the scene's device and the smoothed-aggregation V-cycle over it
  (``ops/amg.py``), in the staged FCG loop (``solve/staged.py``), whose
  f64 apply and certification (``certify.refine_true``) are the BCSR f64
  apply on the same device.
* **Two-level** (the fallback): the element-by-element f64 operator
  (``operator.py``) with the Chebyshev-smoothed two-level preconditioner
  (``ops/twolevel.py``), in the same loop.

Counterpart of ``fea_tpu/solve/unstructured.py``: ``build_amg_setup``,
``_solve_unstructured_amg`` and, for the fallback,
``_solve_unstructured_ddq``. The reference runs both loops in double-f32
pair space (``BCSRPairOperator``, ``ops/ddq.py``) and certifies on the
host, because its chip has no f64; here the loop and the certification
apply in native f64, so neither the pair operators nor the host tier are
ported.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..scene import Scene
from . import staged
from ._types import Solution

__all__ = ["build_amg_setup"]


def build_amg_setup(scene: Scene, *, check_jacobians: bool = True, degree: int = 2, nodes_per_aggregate: int = 32,
                    progress: Optional[Callable[[str], None]] = None):
    """One-time set-up of the AMG route: ``(op, amg)``, the f64
    :class:`~fea_tpu_torch.ops.amg.BCSROperator` of the scene and the SA
    V-cycle over it, both on the scene's device. ``progress`` is given a
    line at each stage."""
    from ..ops.amg import BCSROperator, assemble_bcsr, build_amg

    say = progress if progress is not None else (lambda s: None)
    host = assemble_bcsr(scene.nodes, scene.elements, scene.material, scene.fixed)
    if check_jacobians and host.min_detj <= 0.0:
        raise ValueError(
            f"Non-positive Jacobian determinant (min detJ = {host.min_detj:g}); "
            "check element shapes / node ordering."
        )
    say(f"amg assembled: {host.nbr.shape[0]} nodes, V={host.nbr.shape[1]}")
    amg = build_amg(scene.host_nodes, host, degree=degree, nodes_per_aggregate=nodes_per_aggregate,
                    progress=progress)
    return BCSROperator.from_blocks(host.nbr, host.W, host.free, torch.float64), amg


def _solve_unstructured_amg(scene: Scene, setup, *, tol: float, max_iters: int,
                            progress: Optional[Callable[[str], None]] = None) -> Solution:
    """The AMG route's solve: f64 FCG with the SA V-cycle, certified by the
    true residual of the f64 BCSR apply."""
    op, amg = setup
    return staged.solve_operator_fpcg_staged(
        op, scene.loads, scene.prescribed_or_zero(torch.float64), amg, tol=tol, max_iters=max_iters,
        progress=progress,
    )


def _solve_unstructured_two_level(scene: Scene, op64, precond, *, tol: float, max_iters: int) -> Solution:
    """The two-level route's solve: f64 FCG over the element-by-element f64
    operator with the Chebyshev two-level preconditioner, certified by the
    true residual of that operator's apply. Counterpart of the reference's
    ``_solve_unstructured_ddq``, in native f64."""
    return staged.solve_operator_fpcg_staged(
        op64, scene.loads, scene.prescribed_or_zero(torch.float64), precond, tol=tol, max_iters=max_iters,
    )
