"""The controls: answers in float32, the precision under the float64
the configurations state, in the program's place. A run of the harness
with either (``benchmark/control.py``) has to come out not correct: that
shows the comparison separates float64 answers from float32 ones.

* This module itself, as an entry: the plain reference in float32. It
  offers the entry points the harness drives (``make_scene``,
  ``Material``, ``solve``, ``solve_many``, ``clear_build_cache``) and
  answers each load case with a Jacobi-preconditioned CG in float32 on
  the reference's own K (``hex8.py``), element matrices in float32; its
  reactions are that K applied to its displacements, in float32. It
  stops at MAX_ITERS uncertified, so only its reactions are judged.
* ``Rounded(api)``: the program's own answers, displacements and
  reactions rounded to float32, with the program's own claim that each
  case is certified: the step of returning float32 answers. Its
  residual is judged, and sets the residual limit's upper reading.
"""
from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import numpy as np
import torch

from . import hex8

F32 = torch.float32
MAX_ITERS = 1000  # float32 CG stalls far above the configurations' tolerance long before this


@dataclasses.dataclass(frozen=True)
class Material:
    E: float
    nu: float


@dataclasses.dataclass(frozen=True)
class Scene:
    nodes: torch.Tensor
    elements: torch.Tensor
    fixed: torch.Tensor
    loads: torch.Tensor
    material: Material


def make_scene(nodes, elements, fixed, loads, material, dtype=torch.float64, device=None) -> Scene:
    dev = torch.device(device or "cuda")
    return Scene(torch.as_tensor(np.asarray(nodes), dtype=dtype, device=dev),
                 torch.as_tensor(np.asarray(elements), dtype=torch.int64, device=dev),
                 torch.as_tensor(np.asarray(fixed), dtype=torch.bool, device=dev),
                 torch.as_tensor(loads, dtype=dtype, device=dev), material)


class _Operator:
    """K of one mesh in float32: every element matrix, once."""

    def __init__(self, scene: Scene):
        el = scene.elements
        nodes = scene.nodes.to(F32)
        self.elements = el
        self.ke = torch.cat([hex8.element_stiffness(nodes[el[lo:lo + hex8.BLOCK]], scene.material.E,
                                                    scene.material.nu)
                             for lo in range(0, el.shape[0], hex8.BLOCK)])
        self.free = (~scene.fixed).to(F32)
        self.diag = hex8.stiffness_diagonal(scene.nodes, el, scene.material.E, scene.material.nu, F32)

    def apply(self, u: torch.Tensor) -> torch.Tensor:
        k, n, el = u.shape[0], u.shape[1], self.elements
        out = torch.zeros(k, n, 3, dtype=F32, device=u.device)
        for lo in range(0, el.shape[0], hex8.BLOCK):
            e = el[lo:lo + hex8.BLOCK]
            fe = torch.einsum("bij,kbj->kbi", self.ke[lo:lo + hex8.BLOCK], u[:, e].reshape(k, e.shape[0], 24))
            out.index_add_(1, e.reshape(-1), fe.reshape(k, -1, 3))
        return out


_OPS: dict = {}


def clear_build_cache() -> None:
    _OPS.clear()


def _operator(scene: Scene) -> _Operator:
    key = (id(scene.nodes), id(scene.elements))
    if key not in _OPS:
        _OPS.clear()
        _OPS[key] = (scene.nodes, scene.elements, _Operator(scene))
    return _OPS[key][2]


def _pcg(op: _Operator, b: torch.Tensor, tol: float):
    """Jacobi PCG on the masked system F K F + (1 - F), k cases at once."""
    F = op.free
    dinv = 1.0 / (F * op.diag + (1.0 - F))
    A = lambda p: F * op.apply(F * p) + (1.0 - F) * p  # noqa: E731
    b = F * b
    bn = torch.linalg.vector_norm(b, dim=(1, 2)).clamp_min(1e-30)
    x = torch.zeros_like(b)
    r = b.clone()
    z = dinv * r
    p = z.clone()
    rz = (r * z).sum(dim=(1, 2))
    its = 0
    while its < MAX_ITERS:
        Ap = A(p)
        alpha = rz / (p * Ap).sum(dim=(1, 2))
        x += alpha[:, None, None] * p
        r -= alpha[:, None, None] * Ap
        its += 1
        rel = torch.linalg.vector_norm(r, dim=(1, 2)) / bn
        if bool((rel <= tol).all()):
            break
        z = dinv * r
        rz_new = (r * z).sum(dim=(1, 2))
        p = z + (rz_new / rz)[:, None, None] * p
        rz = rz_new
    return x, its, rel


def _solve_cases(scene: Scene, loads: torch.Tensor, tol: float):
    op = _operator(scene)
    x, its, rel = _pcg(op, loads.to(F32), tol)
    conv = (rel <= tol).cpu().numpy()
    stats = SimpleNamespace(iterations=np.full(loads.shape[0], its), converged=conv,
                            relative_residual=rel.cpu().numpy())
    return SimpleNamespace(displacements=x.to(torch.float64), reactions=op.apply(x).to(torch.float64), stats=stats)


def solve(scene: Scene, *, tol: float, on_nonconverged: str = "ignore"):
    sol = _solve_cases(scene, scene.loads[None], tol)
    st = sol.stats
    return SimpleNamespace(displacements=sol.displacements[0], reactions=sol.reactions[0],
                           stats=SimpleNamespace(iterations=int(st.iterations[0]), converged=bool(st.converged[0]),
                                                 relative_residual=float(st.relative_residual[0])))


def solve_many(scene: Scene, loads_batch: torch.Tensor, *, tol: float, on_nonconverged: str = "ignore"):
    return _solve_cases(scene, loads_batch, tol)


def _rounded(sol):
    return dataclasses.replace(sol, displacements=sol.displacements.to(F32).to(torch.float64),
                               reactions=sol.reactions.to(F32).to(torch.float64))


class Rounded:
    """``api`` (the program, passed in) with every answer rounded to
    float32 where it is returned."""

    def __init__(self, api):
        self.api = api

    def __getattr__(self, name):
        return getattr(self.api, name)

    def solve(self, scene, **kw):
        return _rounded(self.api.solve(scene, **kw))

    def solve_many(self, scene, loads_batch, **kw):
        return _rounded(self.api.solve_many(scene, loads_batch, **kw))
