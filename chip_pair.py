#!/usr/bin/env python3
"""Card times of the voxel stencil wrappers (K1, K2, K1-halo, K3) of several
checkouts of this package, side by side on one CUDA card.

    python3 chip_pair.py DIR [DIR ...]     # e.g.  _parent . . _parent

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
            Zl, Zp = shard_geometry(Z, SHARDS, True)
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


def main() -> None:
    if len(sys.argv) >= 3 and sys.argv[1] == "--measure":
        measure(Path(sys.argv[2]).resolve())
        return
    roots = [Path(a).resolve() for a in sys.argv[1:]]
    if not roots:
        raise SystemExit(__doc__)
    for i, root in enumerate(roots):
        print(f"== run {i + 1}: {root}", flush=True)
        proc = subprocess.run([sys.executable, str(HERE / "chip_pair.py"), "--measure", str(root)], cwd=root,
                              text=True, stdout=subprocess.PIPE, timeout=900)
        if proc.returncode != 0:
            raise SystemExit(f"measuring {root} failed with exit code {proc.returncode}")
        for line in proc.stdout.splitlines():
            row = json.loads(line)
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
