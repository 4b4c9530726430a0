"""The comparison that decides a run's ``correct``.

Each sampled answer of the window (one load case: displacements u and
reactions R, as the program returned them) is judged against K worked
out again by the plain reference (``hex8.py``) from the mesh arrays and
loads the benchmark made, in float64 on the run's device:

* ``residual``: ||F (f - K u)|| / ||F f||, F the free mask, f the loads,
  of each case the program certified (an answer it reports as not
  converged says so; it counts as failed, and is not wrong). The
  configuration states the limit: the tolerance it solves to.
* ``reactions``: ||R - K u|| / ||K u|| over all DOFs: the reactions the
  program returns are K u.
* ``support_u``: max |u| at the fixed DOFs over max |u|: the supports
  hold (prescribed zero), exactly.

A run's number is the worst over the cases judged. A number that is not
finite reads as infinity, which no limit passes.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import hex8

NAMES = ("residual", "reactions", "support_u")


def _finite(x: float) -> float:
    return x if math.isfinite(x) else math.inf


def judge(nodes: np.ndarray, elements: np.ndarray, fixed: np.ndarray, loads: np.ndarray, u: np.ndarray,
          reactions: np.ndarray, certified: list, E: float, nu: float, device) -> dict:
    """The three numbers, a list of k each, of answers ``u`` and
    ``reactions`` (k, N, 3) to ``loads`` (k, N, 3) on one mesh; the
    residual of a case not ``certified`` is None."""
    dev = torch.device(device)
    f64 = torch.float64
    u_t = torch.as_tensor(u, dtype=f64, device=dev)
    ku = hex8.stiffness_apply(torch.as_tensor(nodes, dtype=f64, device=dev),
                              torch.as_tensor(elements, dtype=torch.int64, device=dev), E, nu, u_t)
    f = torch.as_tensor(loads, dtype=f64, device=dev)
    fixed_t = torch.as_tensor(fixed, dtype=torch.bool, device=dev)
    free = (~fixed_t).to(f64)
    res = torch.linalg.vector_norm(free * (f - ku), dim=(1, 2)) / torch.linalg.vector_norm(free * f, dim=(1, 2))
    r_t = torch.as_tensor(reactions, dtype=f64, device=dev)
    rea = torch.linalg.vector_norm(r_t - ku, dim=(1, 2)) / torch.linalg.vector_norm(ku, dim=(1, 2))
    u_max = u_t.abs().amax(dim=(1, 2))
    sup = torch.where(fixed_t, u_t.abs(), torch.zeros_like(u_t)).amax(dim=(1, 2)) / u_max
    out = {name: [_finite(float(x)) for x in v] for name, v in zip(NAMES, (res, rea, sup))}
    out["residual"] = [x if ok else None for x, ok in zip(out["residual"], certified)]
    return out


def worst(readings: list[dict]) -> dict:
    """The worst of each number over several ``judge`` readings; None
    for a number no case has."""
    return {name: max((x for r in readings for x in r[name] if x is not None), default=None) for name in NAMES}


def passes(numbers: dict, limits: dict) -> bool:
    """Every number that was read at or under its limit."""
    return all(numbers[name] is None or numbers[name] <= limits[name] for name in NAMES)
