"""Build every CUDA extension of the port, then run the benchmark once:
the counterpart of tools/prewarm.py.

    python -m fea_tpu_torch.bench.prewarm [--nx 32 --ny 32 --nz 320] [--device cpu]

Step one compiles K1/K2 with their slab forms K1-halo/K3
(``csrc/stencil.cu``), K4/K5 with K4-slab/K5-slab (``csrc/varstencil.cu``)
and K6/K7 (``csrc/element_apply.cu``) through ``ops/nvcc.py``, one nvcc
each, all at once, into the git-ignored ``fea_tpu_torch/_build/``, which is
keyed by the source's hash: a later process loads them without compiling.
With ``--device cpu`` there is nothing to build (the CPU runs the plain
versions) and the step is skipped. Step two runs ``bench_torch.py
--repeats 1 --no-families`` at the given shape as a child process, whose
return code this passes on. Each step's wall goes to stderr and into the
JSON line printed last.

The tool's ``--fused`` has no counterpart: its one-jit program is a TPU
workaround (the port's FCG iteration is one CUDA graph already).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from ..scene import resolve_device

__all__ = ["main"]

ROOT = Path(__file__).resolve().parents[2]


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--nx", type=int, default=32)
    p.add_argument("--ny", type=int, default=32)
    p.add_argument("--nz", type=int, default=320)
    p.add_argument("--device", default=None, help="torch device (default: the CUDA card; 'cpu' to run on the CPU)")
    return p.parse_args(argv)


def say(msg: str) -> None:
    print(f"prewarm: {msg}", file=sys.stderr, flush=True)


def build_all() -> float:
    """Compile (or load) every kernel library, one nvcc each in parallel:
    seconds taken."""
    from ..ops import cuda_apply, cuda_stencil, cuda_varstencil

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=3) as pool:
        for fut in [pool.submit(m.build) for m in (cuda_stencil, cuda_varstencil, cuda_apply)]:
            fut.result()
    return time.perf_counter() - t0


def main(argv=None) -> dict:
    args = parse(argv)
    device = resolve_device(args.device)
    rec: dict = {"device": str(device)}
    if device.type == "cuda":
        rec["build_s"] = build_all()
        say(f"K1-K7 with their slab forms built in {rec['build_s']:.2f} s")
    cmd = [sys.executable, str(ROOT / "bench_torch.py"), "--nx", str(args.nx), "--ny", str(args.ny), "--nz",
           str(args.nz), "--repeats", "1", "--no-families"]
    if args.device is not None:
        cmd += ["--device", args.device]
    say(" ".join(cmd[1:]))
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, stdout=subprocess.PIPE, text=True)
    rec["bench_s"] = time.perf_counter() - t0
    rec["rc"] = proc.returncode
    lines = proc.stdout.strip().splitlines()
    try:
        bench = json.loads(lines[-1]) if lines else {}
    except json.JSONDecodeError:
        bench = {}
    rec["bench"] = {k: bench.get(k) for k in ("n_dof", "iterations", "converged", "relative_residual", "wall_s",
                                              "first_wall_s")}
    say(f"rc={proc.returncode} in {rec['bench_s']:.1f} s")
    return rec


if __name__ == "__main__":
    result = main()
    print(json.dumps(result), flush=True)
    sys.exit(result["rc"])
