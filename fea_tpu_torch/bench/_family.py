"""What the family benches share: the stage harness, the device's
bookkeeping, the host's independent K u, the card timer, and the voxel
stencil's CSR matrix (the library line of the tools that time an apply).

The harness (:class:`Stages`, counterpart of ``tools/_family_util.py``)
prints a heartbeat on stderr at each stage's start and end, holds a wall
deadline (SIGALRM), and turns a failure into a partial record: the stages
completed, their times and the error, printed as the family's JSON line
with a non-zero exit code (:func:`cli`), so that a run that fails still
leaves a record. Every stage time ends in a ``torch.cuda.synchronize()``
on the card.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

__all__ = ["FamilyDeadline", "Stages", "add_common_args", "add_solve_args", "best_of", "cli", "device_label", "failed",
           "graph_ms", "host_check", "host_ku", "host_stencil_residual", "peak_gb", "region_field", "reset_peak",
           "stencil_csr", "sync"]


class FamilyDeadline(Exception):
    pass


def sync(device: torch.device) -> None:
    """Wait for the card's queue (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def reset_peak(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def peak_gb(device: torch.device):
    """Peak device memory allocated since :func:`reset_peak`, GB; None on
    the CPU."""
    return torch.cuda.max_memory_allocated(device) / 1e9 if device.type == "cuda" else None


def device_label(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them, or
    ``"cpu"``."""
    if device.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()
        return out[device.index or 0].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        return f"{torch.cuda.get_device_name(device)}, power limit not read"


def add_common_args(p: argparse.ArgumentParser) -> None:
    """``--device`` and ``--deadline-s``, which every harnessed module reads."""
    p.add_argument("--device", default=None, help="torch device (default: the CUDA card; 'cpu' to run on the CPU)")
    p.add_argument("--deadline-s", type=float, default=420.0,
                   help="wall deadline (SIGALRM): on expiry a partial record with the stages completed is printed; "
                   "0 for none")


def add_solve_args(p: argparse.ArgumentParser, repeats: bool = True) -> None:
    """``--tol`` and, where the module repeats its timed solve, ``--repeats``."""
    p.add_argument("--tol", type=float, default=1e-8)
    if repeats:
        p.add_argument("--repeats", type=int, default=2)


def _launch_counters() -> tuple[dict, ...]:
    """The kernel wrappers' launch counts (K1-K7 and their slab forms),
    each counted where its kernel is launched on the card."""
    from ..ops import cuda_apply, cuda_stencil, cuda_varstencil

    return cuda_stencil.LAUNCHES, cuda_varstencil.LAUNCHES, cuda_apply.LAUNCHES


class Stages:
    """Stage timer, heartbeat and deadline of one family run on ``device``.
    Its record carries the peak device memory and the kernel launches of
    the whole run (both reset when it starts)."""

    def __init__(self, tag: str, device: torch.device, deadline_s: float | None = None):
        self.tag = tag
        self.device = device
        self.t0 = time.perf_counter()
        self.stage_s: dict[str, float] = {}
        self.current: str | None = None
        self.extra: dict = {}
        self._old_alarm = None
        for counts in _launch_counters():
            counts.update(dict.fromkeys(counts, 0))
        if deadline_s and deadline_s > 0 and hasattr(signal, "SIGALRM"):
            def on_alarm(signum, frame):
                raise FamilyDeadline(f"wall deadline {deadline_s:.0f} s hit in stage {self.current!r}")

            self._old_alarm = signal.signal(signal.SIGALRM, on_alarm)
            signal.alarm(max(1, int(deadline_s)))
        reset_peak(device)

    def say(self, msg: str) -> None:
        print(f"[{self.tag} +{time.perf_counter() - self.t0:6.1f}s] {msg}", file=sys.stderr, flush=True)

    def stage(self, name: str) -> "_StageCtx":
        return _StageCtx(self, name)

    def _disarm(self) -> None:
        if self._old_alarm is not None:
            signal.alarm(0)
            signal.signal(signal.SIGALRM, self._old_alarm)
            self._old_alarm = None

    def _record(self, payload: dict) -> dict:
        rec = dict(payload)
        rec.setdefault("stage_s", dict(self.stage_s))
        rec.setdefault("total_s", time.perf_counter() - self.t0)
        rec.update(self.extra)
        rec["device"] = device_label(self.device)
        rec["peak_mem_gb"] = peak_gb(self.device)
        rec["launches"] = {k: n for counts in _launch_counters() for k, n in counts.items()}
        return rec

    def run(self, fn) -> dict:
        """``fn()``'s record, or on any exception (the deadline included)
        the partial record: ``partial``, ``error``, ``stage_reached`` and
        the stages completed."""
        try:
            rec = fn()
        except Exception as exc:  # the family's boundary: every failure becomes its record
            self.say(f"failed in stage {self.current!r}: {type(exc).__name__}: {exc}")
            rec = dict(partial=True, error=f"{type(exc).__name__}: {exc}", stage_reached=self.current)
        finally:
            self._disarm()
        return self._record(rec)


class _StageCtx:
    def __init__(self, stages: Stages, name: str):
        self.stages, self.name = stages, name

    def __enter__(self):
        self.stages.current = self.name
        self.stages.say(f"stage {self.name}: start")
        self.t = time.perf_counter()
        return self

    def __exit__(self, et, ev, tb):
        if et is None:
            sync(self.stages.device)
        dt = time.perf_counter() - self.t
        self.stages.stage_s[self.name] = dt
        if et is None:
            self.stages.say(f"stage {self.name}: {dt:.3f} s")
            self.stages.current = None
        return False


def best_of(st: Stages, repeats: int, solve) -> tuple:
    """max(repeats, 2) timed calls of ``solve()`` (the first carries the
    graph capture), each its own stage: (best wall, its solution, walls)."""
    best, walls = None, []
    for rep in range(max(repeats, 2)):
        with st.stage(f"solve_{rep}"):
            t0 = time.perf_counter()
            sol = solve()
            sync(st.device)
            t = time.perf_counter() - t0
        walls.append(t)
        st.say(f"repeat {rep}: {t:.3f} s, {sol.stats.iterations} iterations, "
               f"reported {sol.stats.relative_residual:.2e}")
        if best is None or t < best[0]:
            best = (t, sol)
    return best[0], best[1], walls


def failed(rec: dict) -> bool:
    """A family record that did not end in a converged solve whose host
    true residual is at most its ``tol``."""
    res = rec.get("relative_residual")
    return bool(rec.get("partial")) or not rec.get("converged") or res is None or not res <= rec["tol"]


def cli(main, failed=failed) -> None:
    """Run a family's ``main(argv)``, print its record as one JSON line,
    and exit 0; 3 for a partial record (the tools' code), 1 for a run
    that failed its gates (``failed(record)``, by default :func:`failed`)."""
    rec = main(sys.argv[1:])
    print(json.dumps(rec), flush=True)
    sys.exit(3 if rec.get("partial") else 1 if failed(rec) else 0)


# Natural coordinates of the hex8 corners (bottom face counter-clockwise,
# then the top face), written out here rather than taken from the package
_HEX_SIGNS = np.array([[-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1],
                       [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1]], np.float64)


def host_ku(nodes, elements, E, nu, u, chunk=32_768):
    """K u in NumPy f64, element by element through the connectivity.

    At each 2x2x2 Gauss point of each element the displacement gradient
    gives the stress sigma = lam tr(eps) I + 2 mu eps, which goes back to
    corner a as detJ sigma grad N_a; the corner forces are summed into
    their nodes. The Jacobian is inverted by its cofactors. No weight
    field, stencil, B matrix or Voigt order: this shares no code with the
    package's assembly or its kernels. Chunks of elements run on the
    host's cores; their forces are summed in chunk order.
    """
    lam = E * nu / ((1.0 + nu) * (1.0 - 2.0 * nu))
    mu = E / (2.0 * (1.0 + nu))

    def forces(e0):
        el = elements[e0 : e0 + chunk]
        X, U = nodes[el], u[el]  # (E, 8, 3)
        f = np.zeros_like(U)
        for q in _HEX_SIGNS / np.sqrt(3.0):
            t = 1.0 + q * _HEX_SIGNS  # (8, 3)
            dN = _HEX_SIGNS / 8.0 * np.stack([t[:, 1] * t[:, 2], t[:, 0] * t[:, 2], t[:, 0] * t[:, 1]], 1)
            J = np.transpose(X, (0, 2, 1)) @ dN  # J[e, j, i] = dx_j / dxi_i
            # row i of J^-1 is (column i+1 x column i+2) / det
            cof = np.stack([np.cross(J[:, :, (i + 1) % 3], J[:, :, (i + 2) % 3]) for i in range(3)], 1)
            det = np.einsum("ej,ej->e", J[:, :, 0], cof[:, 0])
            G = dN @ (cof / det[:, None, None])  # dN_a / dx_j
            H = np.transpose(U, (0, 2, 1)) @ G  # du_i / dx_j
            eps = 0.5 * (H + np.transpose(H, (0, 2, 1)))
            sig = 2.0 * mu * eps
            sig[:, [0, 1, 2], [0, 1, 2]] += lam * np.trace(eps, axis1=1, axis2=2)[:, None]
            f += det[:, None, None] * (G @ sig)
        return f

    Ku = np.zeros_like(u)
    starts = range(0, elements.shape[0], chunk)
    with ThreadPoolExecutor(max_workers=os.cpu_count()) as pool:
        for e0, f in zip(starts, pool.map(forces, starts)):
            el = elements[e0 : e0 + chunk]
            for c in range(3):
                Ku[:, c] += np.bincount(el.ravel(), weights=f[..., c].ravel(), minlength=u.shape[0])
    return Ku


def host_check(nodes, elements, mat, fixed, loads, u):
    """(Ku, true relative residual) of the masked system in NumPy f64,
    from :func:`host_ku`: independent of the device assembly and of the
    kernels."""
    Ku = host_ku(nodes, elements, float(mat.E), float(mat.nu), u)
    F = 1.0 - fixed.astype(np.float64)
    return Ku, float(np.linalg.norm(F * (loads - Ku)) / np.linalg.norm(F * loads))


def host_stencil_residual(ke: np.ndarray, dims, fixed: np.ndarray, loads: np.ndarray, u: np.ndarray) -> float:
    """The true relative residual ||F (f - K u)|| / ||F f|| of a voxel box
    of ``dims`` elements in NumPy f64, K u by the host's exact stencil
    (``native.stencil_apply_host``), which shares no code with the kernels."""
    from ..native import stencil_apply_host

    nx, ny, nz = dims
    Ku = stencil_apply_host(ke, u.reshape(nz + 1, ny + 1, nx + 1, 3), dims).reshape(-1, 3)
    F = 1.0 - fixed.astype(np.float64)
    return float(np.linalg.norm(F * (loads - Ku)) / np.linalg.norm(F * loads))


def region_field(table: torch.Tensor, Z: int, Y: int, X: int) -> torch.Tensor:
    """The (27, 3, 3, Z, Y, X) weight field of a voxel region table
    (27 regions, 27 offsets, 3, 3): K1/K2's operator in K4/K5's form."""
    def cls(n):
        i = torch.arange(n, device=table.device)
        return torch.where(i == 0, 0, torch.where(i == n - 1, 2, 1))

    region = (cls(Z)[:, None, None] * 3 + cls(Y)[None, :, None]) * 3 + cls(X)[None, None, :]
    return table[region].permute(3, 4, 5, 0, 1, 2).contiguous()


def stencil_csr(w: torch.Tensor) -> torch.Tensor:
    """The (3N, 3N) CSR matrix of a (27, 3, 3, Z, Y, X) block stencil
    (neighbours outside the grid dropped), built on w's device with int32
    indices, rows in order so that no sort is needed."""
    from ..ops.curvilinear import _OFFSETS

    Z, Y, X = w.shape[3:]
    N = Z * Y * X
    dev = w.device
    z, y, x = torch.meshgrid(*(torch.arange(n, device=dev) for n in (Z, Y, X)), indexing="ij")
    valid = torch.stack([
        (z + dz >= 0) & (z + dz < Z) & (y + dy >= 0) & (y + dy < Y) & (x + dx >= 0) & (x + dx < X)
        for dz, dy, dx in _OFFSETS
    ], dim=-1).reshape(N, 27)
    off = torch.tensor([(dz * Y + dy) * X + dx for dz, dy, dx in _OFFSETS], device=dev)
    n = torch.arange(N, device=dev)
    # entry (row 3n + r, column 3(n + off_d) + c), ordered (n, r, d, c)
    col = 3 * (n[:, None, None, None] + off[None, None, :, None]) + torch.arange(3, device=dev)
    col = col.expand(N, 3, 27, 3)
    val = w.reshape(27, 3, 3, N).permute(3, 1, 0, 2)
    keep = valid[:, None, :, None].expand(N, 3, 27, 3)
    per_row = (3 * valid.sum(dim=1)).repeat_interleave(3)
    crow = torch.zeros(3 * N + 1, dtype=torch.int64, device=dev)
    crow[1:] = torch.cumsum(per_row, 0)
    return torch.sparse_csr_tensor(
        crow.to(torch.int32), col[keep].to(torch.int32), val[keep], size=(3 * N, 3 * N), check_invariants=False
    )


def graph_ms(fn, calls: int = 20, runs: int = 10) -> float:
    """The card's time of one call of ``fn``: ``calls`` calls captured in one
    CUDA graph, the median over ``runs`` replays of the CUDA-event time of a
    replay, over ``calls``. A replay costs the host one launch, so this is
    the kernels' own time, not the host's pace."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    del graph
    return statistics.median(times)
