#!/usr/bin/env python3
"""Benchmark of fea_tpu_torch on one CUDA card: assemble and solve the
~1M-DOF hex8 voxel cantilever with matrix-free multigrid FCG, report
end-to-end DOF/s against the reference baseline, then run the family
benches, each in a child process of its own.

    python3 bench_torch.py                              # the card: flagship and families
    python bench_torch.py --device cpu --nx 8 --ny 8 --nz 64 --no-families

Counterpart of bench.py, the JAX package's benchmark. The metric is the
same end-to-end quantity: element integration, supports, multigrid
hierarchy and the solve to a true relative residual of ``--tol``, timed
together after one warm-up solve, the best of ``--repeats`` reported
beside the first solve's wall and the spread. Baseline (BASELINE.md):
the reference's dense path assembles and solves its 3,750-DOF cubebeam in
17.2 s on a CPU, 218 DOF/s.

``relative_residual`` is the true residual of the reported solution,
recomputed on the host in NumPy f64 (``fea_tpu_torch.native``), not the
solver's own figure. The run fails loudly (``"converged": false``, no
DOF/s, exit 1) when the solve does not converge, the true residual is
above tol, the tip deflection leaves the band (0.70, 1.30) around beam
theory, or the f64 apply misses the host's exact apply by more than
1e-12; a family that fails, times out or is skipped for the budget is
marked so and the exit code is 1.

The families (``FAMILIES``; ``fea_tpu_torch.bench``) run after the
flagship result is secured, each with its own timeout under ``--budget-s``
and ``--family-timeout-s``, so that a fault in one cannot poison the next
and each family's first solve is its process's first.

The last line of stdout is one JSON object of at most 1,500 bytes (the
flagship's fields and a ``families`` object); the full records go to
``bench_torch_out/bench_<nx>x<ny>x<nz>.json``. Heartbeats go to stderr.
Without ``--device`` the run needs a CUDA card and raises without one;
nothing falls back to the CPU or to a kernel's plain version.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from fea_tpu_torch.bench import scenes  # noqa: E402
from fea_tpu_torch.bench._family import (device_label, graph_ms, host_stencil_residual, peak_gb,  # noqa: E402
                                         reset_peak, sync)

BASELINE_DOF_PER_S = 218.0  # BASELINE.md end-to-end reference measurement
TIP_BAND = (0.70, 1.30)  # acceptable FEM/beam-theory tip-deflection ratio
NUMERICS_TOL = 1e-12  # the f64 apply against the host's exact one, relative to max |K x|
HBM_BYTES_PER_S = 3.35e12  # NVIDIA H100 SXM data sheet, at the full 700 W
FINAL_LINE_BYTES = 1500
OUT_DIR = ROOT / "bench_torch_out"

# bench.py's family list (bench.py:541-597), in its order, with the
# records of tools/many_bench.py and tools/unstructured_bench.py after
# ``arbitrary``: (name, the child's arguments after the interpreter). The
# last three are escalations and run only with more headroom.
FAMILIES = (
    ("extruded", ["-m", "fea_tpu_torch.bench.tube", "--segments", "256", "--layers", "384", "--repeats", "1"]),
    ("curvilinear", ["-m", "fea_tpu_torch.bench.curv", "--nx", "24", "--ny", "24", "--nz", "96", "--repeats", "2"]),
    ("canonicalized", ["-m", "fea_tpu_torch.bench.canon", "--nx", "24", "--ny", "24", "--nz", "96", "--repeats", "2"]),
    ("arbitrary", ["-m", "fea_tpu_torch.bench.arbitrary", "--nx", "40", "--ny", "40", "--nz", "144", "--repeats", "2"]),
    ("many", ["-m", "fea_tpu_torch.bench.many", "--nx", "32", "--ny", "32", "--nz", "320", "--cases", "8"]),
    ("unstructured", ["-m", "fea_tpu_torch.bench.unstructured", "--nx", "24", "--ny", "24", "--nz", "96",
                      "--repeats", "2"]),
    ("curvilinear_812k", ["-m", "fea_tpu_torch.bench.curv", "--nx", "40", "--ny", "40", "--nz", "160",
                          "--repeats", "2"]),
    ("unstructured_812k", ["-m", "fea_tpu_torch.bench.unstructured", "--nx", "40", "--ny", "40", "--nz", "160",
                           "--repeats", "2"]),
    ("capacity_8m", [str(ROOT / "bench_torch.py"), "--nx", "64", "--ny", "64", "--nz", "640", "--repeats", "1",
                     "--no-families", "--skip-numerics-check", "--budget-s", "400"]),
)
ESCALATIONS = ("curvilinear_812k", "unstructured_812k", "capacity_8m")
_T0 = time.perf_counter()


def hb(msg: str) -> None:
    """Heartbeat to stderr."""
    print(f"[bench +{time.perf_counter() - _T0:7.1f}s] {msg}", file=sys.stderr, flush=True)


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    # default: cubic elements (multigrid-friendly), ~1.05M DOF
    p.add_argument("--nx", type=int, default=32)
    p.add_argument("--ny", type=int, default=32)
    p.add_argument("--nz", type=int, default=320)
    p.add_argument("--tol", type=float, default=1e-8)
    p.add_argument("--solver", choices=["auto", "staged", "fpcg", "refined", "refined-host"], default="auto",
                   help="auto (default) = staged: FCG with one iteration a CUDA-graph replay; fpcg: the same "
                   "FCG in a Python loop; refined[-host]: mixed-precision refinement")
    p.add_argument("--max-iters", type=int, default=300)
    p.add_argument("--inner-tol", type=float, default=1e-4)
    p.add_argument("--inner-iters", type=int, default=200)
    p.add_argument("--max-outer", type=int, default=25)
    p.add_argument("--mg-degree", type=int, default=4)
    p.add_argument("--mg-small-level-dof", type=int, default=0,
                   help="levels under this DOF count run in f64; 0 = an all-f32 hierarchy")
    p.add_argument("--budget-s", type=float, default=1800.0,
                   help="soft wall-clock budget: repeats stop and families are skipped once it is at risk")
    p.add_argument("--flagship-budget-s", type=float, default=600.0,
                   help="sub-budget of the flagship's repeats, so that the families keep their share")
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--device", default=None, help="torch device (default: the CUDA card; 'cpu' to run on the CPU)")
    p.add_argument("--skip-numerics-check", action="store_true")
    p.add_argument("--no-families", action="store_true", help="skip the family benches")
    p.add_argument("--family-timeout-s", type=float, default=480.0, help="per-family child process timeout")
    return p.parse_args(argv)


def numerics_check(op_hi, device) -> float:
    """The f64 apply (K2 on the card) on random data from
    ``default_rng(20260817)`` against the host's exact f64 apply: max
    error relative to max |K x|."""
    from fea_tpu_torch.native import stencil_apply_host
    from fea_tpu_torch.ops.cuda_stencil import stencil_apply

    Z, Y, X = op_hi.grid_shape
    x_np = np.random.default_rng(20260817).normal(size=(Z, Y, X, 3))
    want = stencil_apply_host(op_hi.ke.cpu().numpy(), x_np, op_hi.dims)
    got = stencil_apply(op_hi.weights, torch.as_tensor(x_np, device=device)).cpu().numpy()
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300))


def f64_apply_probe(op_hi, u: torch.Tensor) -> dict:
    """The FCG's f64 apply (K2 with the free mask fused) timed on the card
    by CUDA-graph replay, beside the bytes it must move: the input, the
    mask and the output once each."""
    ms = graph_ms(lambda: op_hi.apply(u))
    gbps = 3 * u.numel() * u.element_size() / (ms * 1e-3) / 1e9
    return {"f64_apply_ms": ms, "f64_apply_gbps": gbps, "hbm_share": gbps * 1e9 / HBM_BYTES_PER_S}


def run_flagship(args, device) -> dict:
    from fea_tpu_torch.ops import cuda_stencil
    from fea_tpu_torch.ops.multigrid import build_multigrid
    from fea_tpu_torch.ops.structured import build_structured_operator
    from fea_tpu_torch.solve import (solve_operator_fpcg, solve_operator_fpcg_staged, solve_operator_refined,
                                     solve_operator_refined_host)

    dims = (args.nx, args.ny, args.nz)
    reset_peak(device)
    scene, h = scenes.cantilever(dims, device=device)
    hb(f"scene built: {scene.n_dof} DOF on {device}")
    zero = scene.prescribed_or_zero(torch.float64)
    free_np = 1.0 - h["fixed"].astype(np.float64)
    stage_s: dict[str, float] = {}

    def assemble_and_solve(solver, progress=None):
        # element integration, the f32 cast and the hierarchy are inside
        # the timed region, as in the baseline's assembly + solve
        t0 = time.perf_counter()
        op_hi = build_structured_operator(scene, dims, dtype=torch.float64)
        op_lo = op_hi.astype(torch.float32)
        sync(device)
        stage_s["operator_build"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        mg = build_multigrid(op_lo, degree=args.mg_degree, dtype=torch.float32,
                             small_level_dof=args.mg_small_level_dof, free_np=free_np)
        sync(device)
        stage_s["multigrid_build"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        if solver == "staged":
            sol = solve_operator_fpcg_staged(op_hi, scene.loads, zero, mg, tol=args.tol, max_iters=args.max_iters,
                                             progress=progress)
        elif solver == "fpcg":
            sol = solve_operator_fpcg(op_hi, scene.loads, zero, mg, tol=args.tol, max_iters=args.max_iters)
        else:
            refine_fn = solve_operator_refined if solver == "refined" else solve_operator_refined_host
            sol = refine_fn(op_hi, op_lo, scene.loads, zero, mg, tol=args.tol, max_outer=args.max_outer,
                            inner_tol=args.inner_tol, inner_iters=args.inner_iters)
        sync(device)
        stage_s["solve"] = time.perf_counter() - t0
        return sol, op_hi

    solver = "staged" if args.solver == "auto" else args.solver
    hb(f"warm-up solve [{solver}]")
    t0 = time.perf_counter()
    sol, op_hi = assemble_and_solve(solver, progress=hb)
    first_wall = time.perf_counter() - t0
    hb(f"warm-up done: {first_wall:.3f} s, {sol.stats.iterations} iterations")

    times = []
    flagship_cap = min(args.flagship_budget_s, 0.85 * args.budget_s)
    for rep in range(args.repeats):
        if times and time.perf_counter() - _T0 > flagship_cap:
            hb(f"flagship budget ({flagship_cap:.0f} s) at risk: stopping after {rep} repeats")
            break
        cuda_stencil.LAUNCHES.update(dict.fromkeys(cuda_stencil.LAUNCHES, 0))
        t0 = time.perf_counter()
        sol, op_hi = assemble_and_solve(solver)
        times.append(time.perf_counter() - t0)
        hb(f"repeat {rep + 1} [{solver}]: {times[-1]:.4f} s")
    launches = dict(cuda_stencil.LAUNCHES) if times else None
    best = min(times) if times else first_wall

    u = sol.displacements.cpu().numpy()
    rel = host_stencil_residual(op_hi.ke.cpu().numpy(), dims, h["fixed"], h["loads"], u)
    tip_fem = float(u[h["tip"], 1].mean())
    dof_per_s = scene.n_dof / best
    result = {
        "metric": "assemble_solve_dof_per_s",
        "value": dof_per_s,
        "unit": "DOF/s",
        "vs_baseline": dof_per_s / BASELINE_DOF_PER_S,
        "converged": sol.stats.converged,
        "n_dof": scene.n_dof,
        "n_elements": scene.n_elements,
        "iterations": sol.stats.iterations,
        "relative_residual": rel,
        "solver_relative_residual": sol.stats.relative_residual,
        "wall_s": best,
        "first_wall_s": first_wall,
        "spread_s": max(times) - min(times) if times else None,
        "walls_s": times,
        "stage_s": dict(stage_s),
        "tip_deflection_m": tip_fem,
        "tip_beam_theory_m": h["tip_exact"],
        "tip_ratio": tip_fem / h["tip_exact"],
        "solver": solver,
        "launches": launches,
        "peak_mem_gb": peak_gb(device),
        "device": device_label(device),
    }
    if device.type == "cuda":
        result.update(f64_apply_probe(op_hi, sol.displacements))
    if not args.skip_numerics_check:
        hb("numerics check: the f64 apply against the host's exact f64 apply")
        result["numerics_check"] = err = numerics_check(op_hi, device)
        if not err <= NUMERICS_TOL:
            return fail(result, f"f64 apply numerics check failed: relative error {err:.3e}")
    if not sol.stats.converged:
        return fail(result, f"solve did not converge (solver's residual {sol.stats.relative_residual:.3e})")
    if not rel <= args.tol:
        return fail(result, f"host true relative residual {rel:.3e} above tol {args.tol:g}")
    if not TIP_BAND[0] < result["tip_ratio"] < TIP_BAND[1]:
        return fail(result, f"tip deflection ratio {result['tip_ratio']:.4f} outside {TIP_BAND}")
    return result


def fail(result: dict, reason: str) -> dict:
    hb(f"FAILED: {reason}")
    result.update(converged=False, value=0.0, error=reason)
    return result


def family_summary(rec: dict) -> dict:
    """The final line's entry of a family's record (a tool's keys, or
    this script's own for the capacity child)."""
    if "dof_per_s" not in rec and "value" in rec:  # a bench_torch.py child
        rec = dict(rec, dof_per_s=rec["value"], t_solve=rec.get("wall_s"))
    if "worst_relative_residual" in rec:  # the many child: its worst case and its batch
        rec = dict(rec, relative_residual=rec["worst_relative_residual"], t_solve=rec.get("t_batch_warm"),
                   iterations=max(rec["iterations"], default=None))
    out = {k: rec.get(k) for k in ("n_dof", "iterations", "converged", "relative_residual")}
    out["wall_s"] = rec.get("t_solve", rec.get("solve_s_best", rec.get("value")))
    out["dof_per_s"] = rec.get("dof_per_s")
    for key in ("route", "cases", "per_case_s", "amortized_ratio", "n_aggregates"):
        if key in rec:
            out[key] = rec[key]
    return out


def run_family(name: str, argv: list, timeout_s: float, args) -> tuple[dict, dict | None]:
    """One family in a child process: (its summary, its record). The
    summary has ``error`` when the child failed (a non-zero exit, a
    partial record or none) or timed out."""
    cmd = [sys.executable, *argv]
    if name != "capacity_8m":  # bench_torch.py children carry their own --budget-s instead
        # the child's own deadline fires before the timeout, so it can print its partial record
        cmd += ["--deadline-s", str(max(60.0, timeout_s - 30.0))]
    if args.device is not None:
        cmd += ["--device", args.device]
    hb(f"family {name}: {' '.join(cmd[1:])}")
    with tempfile.TemporaryFile() as errf:
        try:
            proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=errf, timeout=timeout_s, cwd=ROOT)
            errf.seek(0)
            err = errf.read().decode(errors="replace")
        except subprocess.TimeoutExpired:
            errf.seek(0)
            err = errf.read().decode(errors="replace")
            sys.stderr.write(err)
            return {"error": f"timeout after {timeout_s:.0f} s", "stderr_tail": err.splitlines()[-8:]}, None
    sys.stderr.write(err)
    lines = proc.stdout.decode(errors="replace").strip().splitlines()
    try:
        rec = json.loads(lines[-1]) if lines else {}
    except json.JSONDecodeError:
        rec = {}
    if proc.returncode != 0 or not rec or rec.get("partial"):
        out = family_summary(rec) if rec else {}
        # the child's own error, or the last line it wrote before it died
        last = err.strip().splitlines()[-1:] if not rec else []
        out["error"] = (rec.get("error") or (last[0] if last else f"rc={proc.returncode}"))[:200]
        out["stage_reached"] = rec.get("stage_reached")
        out["stderr_tail"] = err.splitlines()[-8:]
        return out, rec
    return family_summary(rec), rec


def run_families(args) -> tuple[dict, dict]:
    """Every family of ``FAMILIES`` under the budget: (summaries, records)."""
    families, records = {}, {}
    for name, argv in FAMILIES:
        remaining = args.budget_s - (time.perf_counter() - _T0)
        need = args.family_timeout_s + (180.0 if name in ESCALATIONS else 60.0)
        if remaining < need:
            hb(f"family {name}: skipped (budget: {remaining:.0f} s left)")
            families[name] = {"skipped": f"budget ({remaining:.0f} s left)"}
            continue
        families[name], records[name] = run_family(name, argv, min(args.family_timeout_s, remaining - 60.0), args)
        hb(f"family {name}: " + (families[name].get("error") or f"{families[name]['dof_per_s']:.1f} DOF/s"))
    return families, records


def exit_code(result: dict) -> int:
    """0 for a flagship that passed its gates and families that all ran
    and passed theirs (or were left out by ``--no-families``), else 1."""
    bad = "error" in result or not result.get("converged")
    bad = bad or any("error" in f or "skipped" in f for f in result.get("families", {}).values())
    return 1 if bad else 0


# the final line's flagship keys (bench.py:387-404 and this script's own),
# and what may be dropped, in order, should the line outgrow its bytes
FINAL_KEYS = ("metric", "value", "vs_baseline", "converged", "n_dof", "n_elements", "iterations",
              "relative_residual", "wall_s", "first_wall_s", "spread_s", "stage_s", "tip_deflection_m",
              "tip_beam_theory_m", "tip_ratio", "solver", "numerics_check", "f64_apply_ms", "hbm_share",
              "peak_mem_gb", "device", "error")
# The flagship's droppables, then every family entry's (the full records
# keep them all): the route's name, the two-level aggregates, the batch's
# wall a case (its wall over its cases), DOF/s (DOF over the wall), the
# batch's cases and its amortized ratio; last the flagship's beam theory
# (its tip deflection over its tip ratio).
DROPPABLE = (*(("flagship", k) for k in ("spread_s", "stage_s", "peak_mem_gb", "first_wall_s")),
             *(("family", k) for k in ("route", "n_aggregates", "per_case_s", "dof_per_s", "cases",
                                       "amortized_ratio")),
             ("flagship", "tip_beam_theory_m"))


def _short(v):
    """A number rounded to 4 significant digits for the final line, a
    whole number from 10,000 up."""
    if isinstance(v, float):
        v = float(f"{v:.4g}")
        return int(v) if abs(v) >= 1e4 else v
    if isinstance(v, dict):
        return {k: _short(x) for k, x in v.items()}
    return v


def final_line(result: dict) -> str:
    """The last line of stdout: the flagship's ``FINAL_KEYS`` and each
    family's summary, compact JSON of at most ``FINAL_LINE_BYTES``."""
    whole = ("tip_deflection_m", "tip_beam_theory_m")  # kept to the last digit
    line = {k: (result[k] if k in whole else _short(result[k])) for k in FINAL_KEYS if k in result}
    if "families" in result:
        line["families"] = {name: {k: _short(v) for k, v in entry.items() if k not in ("stderr_tail",
                                                                                         "stage_reached")}
                            for name, entry in result["families"].items()}
    text = json.dumps(line, separators=(",", ":"))
    for scope, key in DROPPABLE:
        if len(text.encode()) <= FINAL_LINE_BYTES:
            break
        for entry in [line] if scope == "flagship" else (line.get("families") or {}).values():
            entry.pop(key, None)
        text = json.dumps(line, separators=(",", ":"))
    for width in (80, 40, 0):
        if len(text.encode()) <= FINAL_LINE_BYTES:
            break
        for entry in (line.get("families") or {}).values():
            for key in ("error", "skipped"):
                if key in entry:
                    entry[key] = entry[key][:width]
        if "error" in line:
            line["error"] = line["error"][:width]
        text = json.dumps(line, separators=(",", ":"))
    if len(text.encode()) > FINAL_LINE_BYTES:
        raise ValueError(f"final line of {len(text.encode())} bytes")
    return text


def main(argv=None) -> dict:
    """The whole benchmark: the flagship's record with its ``families``
    (unless ``--no-families``), also written to ``bench_torch_out/``."""
    global _T0
    _T0 = time.perf_counter()
    args = parse(argv)
    from fea_tpu_torch.scene import resolve_device

    device = resolve_device(args.device)
    hb(f"start: {args.nx}x{args.ny}x{args.nz}, solver={args.solver}, device {device}")
    result = run_flagship(args, device)
    records = {}
    if "error" not in result and not args.no_families:
        result["families"], records = run_families(args)
    result["first_output_s"] = time.perf_counter() - _T0
    OUT_DIR.mkdir(exist_ok=True)
    path = OUT_DIR / f"bench_{args.nx}x{args.ny}x{args.nz}.json"
    path.write_text(json.dumps({"result": result, "family_records": records}, indent=1))
    hb(f"done; full records in {path}")
    return result


if __name__ == "__main__":
    res = main()
    print(final_line(res), flush=True)
    sys.exit(exit_code(res))
