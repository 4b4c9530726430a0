#!/usr/bin/env python3
"""Smoke run of fea_tpu_torch on one CUDA card.

    python3 chip_smoke.py        # from the repository root, no flags

Phases, in order:
  1. device: the card's name and power limit (nvidia-smi), torch, CUDA
     and nvcc versions; raises without a card;
  2. build: compiles K1/K2 (fea_tpu_torch/csrc/stencil.cu, sm_90a);
  3. kernels vs plain version on the card, at small shapes and at every
     grid the flagship solve gives them, with random inputs from a NumPy
     seed: K1 within 2e-5 and K2 within 1e-12 (max error relative to
     max|K u|) of the plain version run in f64; CUDA-event times of each
     kernel and of its plain version at the flagship grid;
  4. slice: the flagship cantilever (32x32x320 voxels, 1,048,707 DOF, the
     yardstick of bench.py) through ``fea_tpu_torch.solve`` on the card,
     checked by a true residual recomputed on the host in NumPy f64
     (independent of the kernels), the tip deflection against beam
     theory, and the launch counters of K1 and K2 over that one solve;
  5. one JSON line of the kernels, then the last line
     ``{"ok": true, "device": {...}}``.

Any failure raises, and the script exits non-zero without the last line.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

K1_TOL = 2e-5  # tests/test_pallas.py's bound for the f32 stencil
K2_TOL = 1e-12
FLAGSHIP = (32, 32, 320)
SHAPES = [(1, 1, 1), (3, 2, 5), (4, 4, 8), (4, 4, 40), (8, 8, 80), (16, 16, 160), FLAGSHIP]
TIP_BAND = (0.70, 1.30)  # bench.py's band for the FEM / beam-theory tip ratio
MAX_ITERS = 16
KERNELS = {
    "f32": dict(name="K1 stencil_apply_f32", replaces="fea_tpu/ops/pallas_stencil.py:540",
                dtype=torch.float32, tol=K1_TOL),
    "f64": dict(name="K2 stencil_apply_f64", replaces="fea_tpu/ops/pallas_stencil.py:756",
                dtype=torch.float64, tol=K2_TOL),
}


def say(msg: str) -> None:
    print(msg, flush=True)


def event_ms(fn, runs: int = 20, reps: int = 5) -> float:
    """Median over ``runs`` of the CUDA-event time of one call of ``fn``,
    each run timing ``reps`` back-to-back calls."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def flagship_ke(ftt):
    from fea_tpu_torch.elements.hex8 import stiffness_matrix_np

    nx, ny, nz = FLAGSHIP
    h = np.array([0.1 / nx, 0.1 / ny, 1.0 / nz])
    corners = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                        [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]], np.float64) * h
    return stiffness_matrix_np(corners, ftt.Material(E=10_000_000 * ftt.units.psi, nu=0.3))


def check_kernels(ftt, cuda_stencil) -> dict:
    from fea_tpu_torch.ops.structured import stencil_apply_grid

    dev = torch.device("cuda")
    ke = flagship_ke(ftt)
    ke64 = torch.as_tensor(ke, device=dev)
    weights = {k: cuda_stencil.stencil_weights(ke, v["dtype"], dev) for k, v in KERNELS.items()}
    rng = np.random.default_rng(20261016)
    report = {k: dict(max_abs_err=0.0, max_rel_err=0.0) for k in KERNELS}
    for dims in SHAPES:
        nx, ny, nz = dims
        g64 = torch.as_tensor(rng.normal(size=(nz + 1, ny + 1, nx + 1, 3)), device=dev)
        want = stencil_apply_grid(ke64, g64, dims)
        scale = float(want.abs().max())
        for key, spec in KERNELS.items():
            got = cuda_stencil.stencil_apply(weights[key], g64.to(spec["dtype"]).contiguous())
            torch.cuda.synchronize()
            err = float((got.double() - want).abs().max())
            rel = err / scale
            say(f"  {spec['name']} {dims}: max abs err {err:.3e}, rel {rel:.3e} (tol {spec['tol']:g})")
            if not rel <= spec["tol"]:
                raise AssertionError(f"{spec['name']} at {dims}: rel err {rel:.3e} > {spec['tol']:g}")
            report[key]["max_abs_err"] = max(report[key]["max_abs_err"], err)
            report[key]["max_rel_err"] = max(report[key]["max_rel_err"], rel)
        if dims == FLAGSHIP:
            nodes = g64.shape[0] * g64.shape[1] * g64.shape[2]
            for key, spec in KERNELS.items():
                g = g64.to(spec["dtype"]).contiguous()
                w = weights[key]
                ms = event_ms(lambda: cuda_stencil.stencil_apply(w, g))
                plain_ms = event_ms(lambda: stencil_apply_grid(w.ke, g, dims))
                # ideal-reuse traffic: 3 values in and 3 out per node
                gbs = nodes * 6 * g.element_size() / (ms * 1e-3) / 1e9
                say(f"  {spec['name']} {dims} ({3 * nodes} DOF): kernel {ms:.4f} ms "
                    f"({gbs:.1f} GB/s at ideal reuse), plain version {plain_ms:.4f} ms")
                report[key].update(ms=ms, plain_ms=plain_ms, gb_per_s=gbs)
    return report


def flagship_scene(ftt):
    nx, ny, nz = FLAGSHIP
    lx = ly = 0.1
    lz = 1.0
    nodes, elements = ftt.mesh.box_hex_mesh(nx, ny, nz, lx, ly, lz)
    fixed = ftt.fix_where(nodes, lambda p: p[:, 2] == 0.0, 3)
    loads = np.zeros_like(nodes)
    tip = nodes[:, 2] == lz
    total_load = 100.0 * ftt.units.lbf / ftt.units.ft * lz
    loads[tip, 1] = total_load / tip.sum()
    mat = ftt.Material(E=10_000_000 * ftt.units.psi, nu=0.3)
    scene = ftt.make_scene(nodes, elements, fixed, loads, mat, dtype=torch.float64, device="cuda")
    I = lx * ly**3 / 12.0
    tip_exact = total_load * lz**3 / (3 * mat.E * I)
    return scene, (nodes, elements, fixed, loads, tip, tip_exact)


def run_slice(ftt, cuda_stencil) -> dict:
    from fea_tpu_torch.ops.multigrid import build_multigrid
    from fea_tpu_torch.ops.structured import build_structured_operator, stencil_apply_np
    from fea_tpu_torch.solve import solve_operator_fpcg

    scene, (nodes, elements, fixed, loads, tip, tip_exact) = flagship_scene(ftt)
    say(f"  scene: {FLAGSHIP} voxels, {scene.n_dof} DOF on {scene.device}")

    for key in cuda_stencil.LAUNCHES:
        cuda_stencil.LAUNCHES[key] = 0
    t0 = time.perf_counter()
    sol = ftt.solve(scene, tol=1e-8)
    torch.cuda.synchronize()
    whole_s = time.perf_counter() - t0
    launches = dict(cuda_stencil.LAUNCHES)

    st = sol.stats
    say(f"  whole solve (fea_tpu_torch.solve): {whole_s:.3f} s")
    say(f"  iterations {st.iterations}, reported true relative residual "
        f"{st.relative_residual:.3e}, converged {st.converged}")
    say(f"  launches in that solve: K1 {launches['f32']}, K2 {launches['f64']}")

    # stage breakdown: a second solve, stage by stage (bench.py's stages)
    stage = {}
    t0 = time.perf_counter()
    dims = FLAGSHIP
    op_hi = build_structured_operator(scene, dims, dtype=torch.float64)
    torch.cuda.synchronize()
    stage["operator_build"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    mg = build_multigrid(op_hi.astype(torch.float32), dtype=torch.float32,
                         free_np=1.0 - fixed.astype(np.float64))
    torch.cuda.synchronize()
    stage["multigrid_build"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sol2 = solve_operator_fpcg(op_hi, scene.loads, scene.prescribed_or_zero(torch.float64), mg, tol=1e-8)
    torch.cuda.synchronize()
    stage["solve"] = time.perf_counter() - t0
    say("  stages (second solve): " + ", ".join(f"{k} {v:.3f} s" for k, v in stage.items())
        + f"; {sol2.stats.iterations} iterations, levels "
        + ", ".join(f"{lv.dims}:{str(lv.dtype).replace('torch.', '')}" for lv in mg.levels))

    # independent check on the host: NumPy f64, no kernel involved
    u = sol.displacements.cpu().numpy()
    if u.shape != nodes.shape or not np.all(np.isfinite(u)):
        raise AssertionError(f"displacements: shape {u.shape}, finite {np.all(np.isfinite(u))}")
    from fea_tpu_torch.elements.hex8 import stiffness_matrix_np

    ke = stiffness_matrix_np(nodes[elements[0]], scene.material)
    Z, Y, X = dims[2] + 1, dims[1] + 1, dims[0] + 1
    F = 1.0 - fixed.astype(np.float64)
    Ku = stencil_apply_np(ke, u.reshape(Z, Y, X, 3), dims).reshape(-1, 3)
    rel_host = float(np.linalg.norm(F * (loads - Ku)) / np.linalg.norm(F * loads))
    reac_err = float(np.abs(sol.reactions.cpu().numpy() - Ku).max() / np.abs(Ku).max())
    tip_ratio = float(u[tip, 1].mean()) / tip_exact
    say(f"  host f64 true relative residual {rel_host:.3e}; reactions vs host K u {reac_err:.3e}")
    say(f"  tip ratio u_tip,y / (P L^3 / 3 E I) = {tip_ratio:.5f}")

    checks = {
        "converged": st.converged,
        f"iterations <= {MAX_ITERS}": st.iterations <= MAX_ITERS,
        "host true residual <= 1e-8": rel_host <= 1e-8,
        f"tip ratio in {TIP_BAND}": TIP_BAND[0] < tip_ratio < TIP_BAND[1],
        "reactions = K u (1e-10)": reac_err <= 1e-10,
        "K1 launched": launches["f32"] > 0,
        "K2 launched": launches["f64"] > 0,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"slice checks failed: {failed}")
    return launches


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card")
    import fea_tpu_torch as ftt
    from fea_tpu_torch.ops import cuda_stencil

    say("[1] device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    say(smi)
    nvcc = subprocess.run([cuda_stencil.find_nvcc(), "--version"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[-1]
    say(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, nvcc: {nvcc}")
    say(f"  device 0: {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")

    say("[2] build")
    t0 = time.perf_counter()
    cuda_stencil.build()
    say(f"  K1/K2 built in {time.perf_counter() - t0:.2f} s")

    say("[3] kernels vs plain version (f64) on the card")
    report = check_kernels(ftt, cuda_stencil)

    say("[4] slice: flagship cantilever through fea_tpu_torch.solve")
    launches = run_slice(ftt, cuda_stencil)

    say(json.dumps({"kernels": [
        dict(name=spec["name"], route="cuda", source="fea_tpu_torch/csrc/stencil.cu",
             replaces=spec["replaces"], launches=launches[key], **report[key])
        for key, spec in KERNELS.items()
    ]}))
    say(smi)
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
