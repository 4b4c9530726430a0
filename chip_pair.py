#!/usr/bin/env python3
"""Card times of the voxel stencil wrappers (K1, K2, K1-halo, K3) of several
checkouts of this package, side by side on one CUDA card.

    python3 chip_pair.py DIR [DIR ...]     # e.g.  _parent . . _parent
    python3 chip_pair.py --solves DIR [DIR ...]
    python3 chip_pair.py --var DIR [DIR ...]

Each DIR is the root of a checkout that holds ``fea_tpu_torch`` ("." is
this one). They are measured one after the other, each in a process of its
own that imports DIR's package and builds DIR's kernels, so that two
versions of a kernel are compared within one run on one card; give a
version twice to see the spread. For each checkout and each dtype:

  * at every level grid of the flagship hierarchy and at the 8,124,675-DOF
    grid, one ``stencil_apply``: the card's time (CUDA-graph replay) and
    the time at the host's pace (CUDA events around back-to-back calls),
    raw, and masked where the checkout's wrapper takes a mask;
  * at the flagship and at 8,124,675 DOF, one apply over the four
    halo-extended shard tensors of the z-sharded solve (four
    ``stencil_apply_slab`` launches): the same two times;
  * the host's cost of one ``stencil_apply`` call: the wall time of 1,000
    calls on the 9x9x81 level issued without a synchronise, over 1,000.

With ``--solves``, each checkout's process instead times whole
``fea_tpu_torch.solve`` calls on the flagship cantilever, as a user's
process meets them: the first solve of the process and two more on the
same scene, each split into the route's detector, operator build,
hierarchy build and FCG stage (each part ended by a synchronise), and, for
a checkout with the staged loop, the FCG stage's warm-up step and graph
captures. A DIR given as ``DIR:prewarm`` first times one small f64 matmul
and one capture and replay of a one-kernel CUDA graph on a side stream,
the process's first of each, before its solves; ``DIR:profile`` runs the
first solve under torch.profiler and prints the host calls that took most
of it (self time, calls, and the slowest single call).

With ``--var``, each checkout's process times the variable-weight
stencil wrappers (K4, K5, K4-slab, K5-slab) instead, on block-symmetric
random fields (the mirror made exact, as every field of the port is): one
``var_apply`` at every level grid of the 811,923-DOF curvilinear
hierarchy, and one apply over the 4 slabs of its fine grid as
``shard_curvilinear`` cuts them; each raw, as the masked expression
``F * K(F g) + (1 - F) g`` written around the raw wrapper (what the
callers ran before the masked entry), and through ``var_apply_masked`` /
``var_apply_slab_masked`` where the checkout has them.

Prints one line a measurement, then the card's name and power limit.
"""
from __future__ import annotations

import importlib.util
import inspect
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
SHARDS = 4


def measure(root: Path) -> None:
    """Times of the checkout at ``root``, one JSON object a line."""
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    import fea_tpu_torch as ftt  # the package of ``root``: chip_smoke's helpers below then use it too
    from fea_tpu_torch.ops import cuda_stencil
    from fea_tpu_torch.parallel import shard_geometry

    # this checkout's chip_smoke.py, whatever ``root`` holds under that name
    spec = importlib.util.spec_from_file_location("chip_smoke_here", HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    CAPACITY, FLAGSHIP, event_ms, graph_ms = smoke.CAPACITY, smoke.FLAGSHIP, smoke.event_ms, smoke.graph_ms
    flagship_ke, flagship_level_grids = smoke.flagship_ke, smoke.flagship_level_grids

    if Path(ftt.__file__).resolve().parents[1] != root:
        raise SystemExit(f"imported {ftt.__file__}, not the package under {root}")
    masked = "free" in inspect.signature(cuda_stencil.stencil_apply).parameters
    ke = flagship_ke(ftt)
    rng = np.random.default_rng(20261020)

    def emit(**row):
        print(json.dumps(row), flush=True)

    def both(fn):
        return dict(card_ms=graph_ms(fn), host_pace_ms=event_ms(fn, runs=10))

    for name, dtype in (("f32", torch.float32), ("f64", torch.float64)):
        w = cuda_stencil.stencil_weights(ke, dtype, "cuda")
        for dims in flagship_level_grids() + [CAPACITY]:
            nx, ny, nz = dims
            g = torch.as_tensor(rng.normal(size=(nz + 1, ny + 1, nx + 1, 3)), device="cuda").to(dtype)
            emit(what="whole", dtype=name, dims=dims, form="raw", **both(lambda: cuda_stencil.stencil_apply(w, g)))
            if masked:
                F = torch.as_tensor((rng.random(tuple(g.shape)) < 0.8), device="cuda").to(dtype)
                emit(what="whole", dtype=name, dims=dims, form="masked",
                     **both(lambda: cuda_stencil.stencil_apply(w, g, F)))
        for dims in (FLAGSHIP, CAPACITY):
            nx, ny, nz = dims
            Z = nz + 1
            Zl = shard_geometry(Z, SHARDS, [(0, 1, 2)] * 2)[0]
            Zp = SHARDS * Zl
            full = torch.zeros((Zp + 2, ny + 1, nx + 1, 3), dtype=dtype, device="cuda")
            full[1 : Z + 1] = torch.as_tensor(rng.normal(size=(Z, ny + 1, nx + 1, 3)), device="cuda").to(dtype)
            ext = [full[i * Zl : i * Zl + Zl + 2].clone() for i in range(SHARDS)]
            emit(what=f"{SHARDS} slabs", dtype=name, dims=dims, form="raw", **both(
                lambda: [cuda_stencil.stencil_apply_slab(w, e, i * Zl, Z) for i, e in enumerate(ext)]))
            if masked:
                fext = [torch.ones_like(e) for e in ext]
                emit(what=f"{SHARDS} slabs", dtype=name, dims=dims, form="masked", **both(
                    lambda: [cuda_stencil.stencil_apply_slab(w, e, i * Zl, Z, f)
                             for i, (e, f) in enumerate(zip(ext, fext))]))
            del full, ext
        g = torch.as_tensor(rng.normal(size=(81, 9, 9, 3)), device="cuda").to(dtype)
        cuda_stencil.stencil_apply(w, g)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(1000):
            cuda_stencil.stencil_apply(w, g)
        host_us = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        emit(what="host cost of a stencil_apply call, 9x9x81 nodes", dtype=name, host_us=host_us)


def symmetric(w):
    """A (27, 3, 3, Z, Y, X) field made exactly block-symmetric in place,
    W_d[n] = W_{26-d}[n + d]^T for the 13 lower offsets d (index < 13)
    wherever n + d is inside the grid; the blocks toward the z ends
    zeroed first, as an assembled field's are. Written out here because
    an older checkout has no ``symmetrize_field``."""
    w[:9, :, :, 0] = 0.0
    w[18:, :, :, -1] = 0.0
    offsets = [(dz, dy, dx) for dz in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
    for d in range(13):
        at = tuple(slice(max(0, -o), n - max(0, o)) for o, n in zip(offsets[d], w.shape[3:]))
        nb = tuple(slice(max(0, o), n + min(0, o)) for o, n in zip(offsets[d], w.shape[3:]))
        w[(d, slice(None), slice(None)) + at] = w[(26 - d, slice(None), slice(None)) + nb].transpose(0, 1)
    return w


def measure_var(root: Path) -> None:
    """``--var``: times of K4/K5 and their slab forms of the checkout at
    ``root``, one JSON object a line."""
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    import fea_tpu_torch as ftt
    from fea_tpu_torch.ops import cuda_varstencil as vs

    spec = importlib.util.spec_from_file_location("chip_smoke_here", HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    if Path(ftt.__file__).resolve().parents[1] != root:
        raise SystemExit(f"imported {ftt.__file__}, not the package under {root}")
    masked = hasattr(vs, "var_apply_masked")
    rng = np.random.default_rng(20261030)

    def emit(**row):
        print(json.dumps(row), flush=True)

    def both(fn):
        return dict(card_ms=smoke.graph_ms(fn), host_pace_ms=smoke.event_ms(fn, runs=10))

    from fea_tpu_torch.ops.curvilinear import coarsen_dims_partial
    from fea_tpu_torch.parallel import shard_geometry

    grids = smoke.curv_level_grids()
    axes = [coarsen_dims_partial(grids[0])[1], coarsen_dims_partial(grids[1])[1]]
    zl = shard_geometry(grids[0][2] + 1, SHARDS, axes)[0]  # the slabs [18.1] times: 44 planes
    for name, dtype in (("f32", torch.float32), ("f64", torch.float64)):
        for dims in grids:
            nx, ny, nz = dims
            Z, Y, X = nz + 1, ny + 1, nx + 1
            w = symmetric(torch.as_tensor(rng.normal(size=(27, 3, 3, Z, Y, X)), device="cuda")).to(dtype)
            g = torch.as_tensor(rng.normal(size=(Z, Y, X, 3)), device="cuda").to(dtype)
            F = torch.as_tensor(rng.random((Z, Y, X, 3)) < 0.8, device="cuda").to(dtype)
            emit(what="whole", dtype=name, dims=dims, form="raw", **both(lambda: vs.var_apply(w, g)))
            emit(what="whole", dtype=name, dims=dims, form="unfused masked",
                 **both(lambda: F * vs.var_apply(w, F * g) + (1.0 - F) * g))
            if masked:
                emit(what="whole", dtype=name, dims=dims, form="masked",
                     **both(lambda: vs.var_apply_masked(w, F, g)))
            del w, g, F
        nx, ny, nz = grids[0]
        Z, Y, X = nz + 1, ny + 1, nx + 1
        w = torch.zeros((27, 3, 3, SHARDS * zl, Y, X), dtype=dtype, device="cuda")
        w[:, :, :, :Z] = symmetric(torch.as_tensor(rng.normal(size=(27, 3, 3, Z, Y, X)), device="cuda")).to(dtype)
        full = torch.zeros((SHARDS * zl + 2, Y, X, 3), dtype=dtype, device="cuda")
        full[1 : Z + 1] = torch.as_tensor(rng.normal(size=(Z, Y, X, 3)), device="cuda").to(dtype)
        ws = [w[:, :, :, i * zl : (i + 1) * zl].contiguous() for i in range(SHARDS)]
        ext = [full[i * zl : i * zl + zl + 2].clone() for i in range(SHARDS)]
        fext = [torch.as_tensor(rng.random(tuple(e.shape)) < 0.8, device="cuda").to(dtype) for e in ext]
        del w, full
        emit(what=f"{SHARDS} slabs", dtype=name, dims=grids[0], form="raw",
             **both(lambda: [vs.var_apply_slab(a, e) for a, e in zip(ws, ext)]))
        emit(what=f"{SHARDS} slabs", dtype=name, dims=grids[0], form="unfused masked",
             **both(lambda: [f[1:-1] * vs.var_apply_slab(a, f * e) + (1.0 - f[1:-1]) * e[1:-1]
                             for a, e, f in zip(ws, ext, fext)]))
        if masked:
            emit(what=f"{SHARDS} slabs", dtype=name, dims=grids[0], form="masked",
                 **both(lambda: [vs.var_apply_slab_masked(a, f, e) for a, e, f in zip(ws, ext, fext)]))
        del ws, ext, fext


def profiled(fn, emit, top: int = 14):
    """``fn()`` under torch.profiler; emits its host events with the most
    self time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
    rows: dict = {}
    for e in prof.events():
        if e.device_type != DeviceType.CPU:
            continue
        n, total, worst = rows.get(e.name, (0, 0.0, 0.0))
        rows[e.name] = (n + 1, total + e.self_cpu_time_total / 1e3, max(worst, e.self_cpu_time_total / 1e3))
    for name, (n, total, worst) in sorted(rows.items(), key=lambda kv: -kv[1][1])[:top]:
        emit(what=f"profile of solve 1: {name[:60]}", calls=n, self_ms=total, slowest_ms=worst)
    return out


def measure_solves(root: Path, option: str) -> None:
    """Whole ``solve()`` walls of the checkout at ``root``, in parts."""
    t_start = time.perf_counter()
    sys.path.insert(0, str(root))
    import torch

    import fea_tpu_torch as ftt
    from fea_tpu_torch.ops import cuda_apply, cuda_stencil, cuda_varstencil, multigrid, structured

    if Path(ftt.__file__).resolve().parents[1] != root:
        raise SystemExit(f"imported {ftt.__file__}, not the package under {root}")
    spec = importlib.util.spec_from_file_location("chip_smoke_here", HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    def emit(**row):
        print(json.dumps(row), flush=True)

    def timed(what, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        emit(what=what, s=time.perf_counter() - t0)
        return out

    emit(what="imports", s=time.perf_counter() - t_start)
    timed("CUDA context and a first allocation", lambda: torch.zeros(1, device="cuda"))
    timed("kernel builds (cached .so loaded, or nvcc)", lambda: [m.build() for m in (cuda_stencil, cuda_varstencil,
                                                                                      cuda_apply)])
    if option == "prewarm":
        a = torch.ones((64, 64), dtype=torch.float64, device="cuda")
        timed("prewarm: first f64 matmul", lambda: a @ a)
        side = torch.cuda.Stream()

        def capture():
            x = torch.zeros(1, device="cuda")
            side.wait_stream(torch.cuda.current_stream())
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.stream(side):
                x.add_(1)
                graph.capture_begin()
                x.add_(1)
                graph.capture_end()
            torch.cuda.current_stream().wait_stream(side)
            graph.replay()

        timed("prewarm: first graph capture and replay on a side stream", capture)
    scene, _ = timed("flagship scene on the card", lambda: smoke.flagship_scene(ftt))

    # the parts of a solve, each ended by a synchronise
    parts: dict = {}

    def wrap(owner, name, label):
        fn = getattr(owner, name, None)
        if fn is None:
            return

        def inner(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            parts[label] = parts.get(label, 0.0) + time.perf_counter() - t0
            return out

        setattr(owner, name, inner)

    solve_mod = sys.modules["fea_tpu_torch.solve"]
    staged = sys.modules.get("fea_tpu_torch.solve.staged")
    wrap(structured, "infer_box_dims", "detector")
    wrap(structured, "build_structured_operator", "operator")
    wrap(multigrid, "build_multigrid", "hierarchy")
    if staged is not None:
        wrap(staged, "solve_operator_fpcg_staged", "fcg")
        wrap(staged._Plan, "_capture", "fcg: warm-up and captures")
        wrap(staged._Case, "capture", "fcg: captures")
    else:
        wrap(solve_mod, "solve_operator_fpcg", "fcg")
    for i in range(3):
        parts.clear()
        if i == 0 and option == "profile":
            sol = timed("solve 1 (profiled)", lambda: profiled(lambda: ftt.solve(scene, tol=1e-8), emit))
        else:
            sol = timed(f"solve {i + 1}", lambda: ftt.solve(scene, tol=1e-8))
        emit(what=f"solve {i + 1} parts", iterations=int(sol.stats.iterations), **parts)


def main() -> None:
    if len(sys.argv) >= 3 and sys.argv[1] == "--measure":
        measure(Path(sys.argv[2]).resolve())
        return
    if len(sys.argv) >= 3 and sys.argv[1] == "--measure-solves":
        measure_solves(Path(sys.argv[2]).resolve(), sys.argv[3] if len(sys.argv) > 3 else "")
        return
    if len(sys.argv) >= 3 and sys.argv[1] == "--measure-var":
        measure_var(Path(sys.argv[2]).resolve())
        return
    solves = sys.argv[1:2] == ["--solves"]
    var = sys.argv[1:2] == ["--var"]
    args = sys.argv[2:] if solves or var else sys.argv[1:]
    if not args:
        raise SystemExit(__doc__)
    for i, arg in enumerate(args):
        path, _, option = arg.partition(":")
        root = Path(path).resolve()
        print(f"== run {i + 1}: {root} {option}", flush=True)
        mode = "--measure-solves" if solves else "--measure-var" if var else "--measure"
        cmd = [sys.executable, str(HERE / "chip_pair.py"), mode, str(root)]
        proc = subprocess.run(cmd + ([option] if option else []), cwd=root, text=True, stdout=subprocess.PIPE,
                              timeout=900)
        if proc.returncode != 0:
            raise SystemExit(f"measuring {root} failed with exit code {proc.returncode}")
        for line in proc.stdout.splitlines():
            row = json.loads(line)
            if solves:
                what = row.pop("what")
                unit = "ms" if "self_ms" in row else "s"
                print(f"  run {i + 1} {what}: " + ", ".join(
                    f"{k} {v:.4f} {unit}" if isinstance(v, float) else f"{k} {v}" for k, v in row.items()))
                continue
            head = f"  run {i + 1} {row['dtype']} {row['what']}"
            if "host_us" in row:
                print(f"{head}: {row['host_us']:.2f} us")
            else:
                print(f"{head} {tuple(row['dims'])} {row['form']}: {row['card_ms']:.4f} ms on the card, "
                      f"{row['host_pace_ms']:.4f} ms at the host's pace")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0])


if __name__ == "__main__":
    main()
