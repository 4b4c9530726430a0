"""Per-op cost of the FCG's pieces at the flagship: tools/t_microbench.py
(the 32x32x320 voxel cantilever, 1,048,707 DOF, by default).

    python -m fea_tpu_torch.bench.microbench [--nx 32 --ny 32 --nz 320] [--k 20] [--device cpu]

The tool takes the slope of two ``fori_loop`` trip counts inside one jit,
to get under its chip's dispatch floor. On the card one CUDA-graph replay
of ``k`` back-to-back calls gives the same per-op figure: each key is
``graph_ms(fn, calls=k)``, the median replay time over ``k``. On the CPU
(the tests) it is the best of 3 host walls of ``k`` calls, over ``k``.
``timing`` says which.

Prints one JSON line with the tool's kept keys: ``f64_axpy_ms`` and
``f32_axpy_ms`` (y += a x over the (Z, Y, X, 3) grid), ``f64_dot_ms`` (the
FCG's f64 dot, ``dtypes.precise_dot``; the tool's body also scales x by
the dot, which only stops its compiler from hoisting the loop),
``f64_apply_flat_ms`` (K2, raw, on the grid), ``f32_level_apply_ms``
(level 0's masked K1 apply), ``vcycle_ms`` (one f32 V-cycle of the
hierarchy ``solve()`` builds), ``backend``, ``n_dof``, ``k``.

Dropped, as they measure what the port does not have: ``split_combine_ms``
(the f64 -> f32 pair split of the TPU's emulated f64), ``f64_apply_T_ms``,
``f64_transpose_ms`` and ``f32_transpose_ms`` (the (3, Y, X, Z) layout the
TPU's lanes asked for; the port keeps one layout), ``dd_masked_apply_ms``
and ``dd_raw_apply_ms`` (the f32-pair apply; K2 is native FP64 here, and
its masked form is in ``python -m fea_tpu_torch.bench.profile``), and
``f32_pallas_raw_ms`` (the raw Pallas kernel beside the level's apply;
the level's apply is K1 here, so ``f32_level_apply_ms`` is that kernel).
"""
from __future__ import annotations

import argparse
import math
import time

import numpy as np
import torch

from ..dtypes import precise_dot
from ..scene import resolve_device
from . import scenes
from ._family import Stages, add_common_args, cli, device_label, graph_ms, sync

__all__ = ["KEYS", "main"]

KEYS = ("f64_axpy_ms", "f32_axpy_ms", "f64_dot_ms", "f64_apply_flat_ms", "f32_level_apply_ms", "vcycle_ms")


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--nx", type=int, default=32)
    p.add_argument("--ny", type=int, default=32)
    p.add_argument("--nz", type=int, default=320)
    p.add_argument("--k", type=int, default=20, help="calls a timing (one graph on the card)")
    add_common_args(p)
    return p.parse_args(argv)


def failed(rec: dict) -> bool:
    return bool(rec.get("partial")) or not all(math.isfinite(rec.get(k, math.nan)) for k in KEYS)


def main(argv=None) -> dict:
    args = parse(argv)
    device = resolve_device(args.device)
    st = Stages("microbench", device, deadline_s=args.deadline_s)
    return st.run(lambda: run(args, st))


def per_op_ms(fn, device: torch.device, k: int) -> float:
    """ms of one call of ``fn``: a graph replay of ``k`` calls over ``k`` on
    the card, the best of 3 host walls of ``k`` calls over ``k`` elsewhere."""
    if device.type == "cuda":
        return graph_ms(fn, calls=k)
    fn()
    best = math.inf
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(k):
            fn()
        sync(device)
        best = min(best, time.perf_counter() - t0)
    return best / k * 1e3


def run(args, st: Stages) -> dict:
    from ..ops.cuda_stencil import stencil_apply
    from ..solve import _voxel_build

    dev = st.device
    dims = (args.nx, args.ny, args.nz)
    with st.stage("build"):
        scene, _ = scenes.cantilever(dims, device=dev)
        op_hi, mg = _voxel_build(scene, dims)
    Z, Y, X = op_hi.grid_shape
    st.extra.update(backend=device_label(dev), n_dof=scene.n_dof, k=args.k,
                    timing="graph replay of k calls" if dev.type == "cuda" else "host wall of k calls")
    rng = np.random.default_rng(0)
    x64 = torch.as_tensor(rng.normal(size=(Z, Y, X, 3)), device=dev)
    y64 = torch.as_tensor(rng.normal(size=(Z, Y, X, 3)), device=dev)
    x32, y32 = x64.float(), y64.float()
    level0 = mg.levels[0]
    ops = {
        "f64_axpy_ms": lambda: x64.add_(y64, alpha=1e-9),
        "f32_axpy_ms": lambda: x32.add_(y32, alpha=1e-9),
        "f64_dot_ms": lambda: precise_dot(x64, y64),
        "f64_apply_flat_ms": lambda: stencil_apply(op_hi.weights, y64),
        "f32_level_apply_ms": lambda: level0.apply(y32),
        "vcycle_ms": lambda: mg(y32.reshape(-1, 3)),
    }
    rec = {}
    for key, fn in ops.items():
        with st.stage(key):
            rec[key] = per_op_ms(fn, dev, args.k)
        st.say(f"{key} {rec[key]:.4f}")
    rec["levels"] = [lv.dims for lv in mg.levels]
    return rec


if __name__ == "__main__":
    cli(main, failed)
