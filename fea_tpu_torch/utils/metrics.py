"""Per-solve records: n_dof, n_elements, iterations, the residual, wall
time and DOF/s. Counterpart of ``fea_tpu/utils/metrics.py``; ``backend``
is the type of the scene's device (``"cuda"`` or ``"cpu"``)."""
from __future__ import annotations

import dataclasses
import json
from typing import Optional

__all__ = ["SolveRecord", "record_solve", "records"]

records: list["SolveRecord"] = []


@dataclasses.dataclass
class SolveRecord:
    n_dof: int
    n_elements: int
    iterations: int
    relative_residual: float
    wall_time_s: float
    method: str = "cg"
    backend: str = ""
    extra: Optional[dict] = None

    @property
    def dof_per_s(self) -> float:
        return self.n_dof / self.wall_time_s if self.wall_time_s > 0 else float("inf")

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["dof_per_s"] = self.dof_per_s
        return json.dumps(d)


def record_solve(scene, stats, wall_time_s: float, method: str = "cg", **extra) -> SolveRecord:
    """Build, store in :data:`records`, and return the record of a solve."""
    rec = SolveRecord(
        n_dof=scene.n_dof,
        n_elements=scene.n_elements,
        iterations=int(stats.iterations),
        relative_residual=float(stats.relative_residual),
        wall_time_s=wall_time_s,
        method=method,
        backend=scene.device.type,
        extra=extra or None,
    )
    records.append(rec)
    return rec
