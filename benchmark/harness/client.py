"""The one waiting caller: makes each request's scene and loads, calls
the program's public entry (``solve`` or ``solve_many``), and times the
call until its result is synchronised on the device."""
from __future__ import annotations

import dataclasses
import sys
import time

import numpy as np
import torch
from torch.profiler import record_function

STAGED = "fea_tpu_torch.solve.staged"  # the program's counters of the staged FCG


@dataclasses.dataclass
class Record:
    r: int
    cases: int
    dof: int
    latency_s: float
    done_at: float
    iterations: list
    converged: list
    relative_residual: list  # the program's own figure, beside the reference's after the window
    capture_ms: float | None
    route: str | None
    profiled: bool = False


def _capture_ms() -> float | None:
    staged = sys.modules.get(STAGED)
    return None if staged is None else float(staged.COUNTS["capture_ms"])


class Client:
    def __init__(self, api, gen, device: torch.device):
        self.api, self.gen, self.dev = api, gen, device
        cfg = gen.config
        self.material = api.Material(E=cfg["E"], nu=cfg["nu"])
        self.tol = cfg["tol"]
        self.many = gen.mix["entry"] == "solve_many"
        self.scene = self._scene(gen.base) if gen.shared else None

    def _scene(self, mesh: dict):
        zeros = np.zeros_like(mesh["nodes"])
        return self.api.make_scene(mesh["nodes"], mesh["elements"], mesh["fixed"], zeros, self.material,
                                   dtype=torch.float64, device=self.dev)

    def _sync(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def request(self, r: int):
        """Run request r; returns its Record and its answers, displacements
        and reactions, each (cases, N, 3) on the device."""
        gen = self.gen
        with record_function("bench.inputs"):
            mesh = gen.mesh(r)
            scene = self.scene if gen.shared else self._scene(mesh)
            tip = torch.as_tensor(np.nonzero(mesh["tip"])[0], device=self.dev)
            loads = torch.zeros((gen.cases,) + mesh["nodes"].shape, dtype=torch.float64, device=self.dev)
            loads[:, tip] = torch.as_tensor(gen.tip_loads(r, mesh), device=self.dev)[:, None, :]
            if not self.many:
                scene = dataclasses.replace(scene, loads=loads[0])
        self._sync()
        cap0 = _capture_ms()
        t0 = time.perf_counter()
        with record_function("bench.request"):
            if self.many:
                sol = self.api.solve_many(scene, loads, tol=self.tol, on_nonconverged="ignore")
            else:
                sol = self.api.solve(scene, tol=self.tol, on_nonconverged="ignore")
            self._sync()
        t1 = time.perf_counter()
        cap1 = _capture_ms()
        u, reac = sol.displacements, sol.reactions
        if not self.many:
            u, reac = u[None], reac[None]
        rec = Record(
            r=r, cases=gen.cases, dof=int(mesh["nodes"].size), latency_s=t1 - t0, done_at=t1,
            iterations=np.atleast_1d(np.asarray(sol.stats.iterations)).astype(int).tolist(),
            converged=np.atleast_1d(np.asarray(sol.stats.converged)).astype(bool).tolist(),
            relative_residual=np.atleast_1d(np.asarray(sol.stats.relative_residual)).astype(float).tolist(),
            capture_ms=None if cap0 is None or cap1 is None else cap1 - cap0,
            route=getattr(sol, "route", None),
        )
        return rec, u, reac
