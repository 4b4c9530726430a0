"""The operator shoot-out: ms per apply K x of each operator form of the
port, f32, on the voxel cantilever (tools/spmv_bench.py; the 32x32x320
flagship, 1,048,707 DOF, by default).

    python -m fea_tpu_torch.bench.spmv [--nx 32 --ny 32 --nz 320] [--device cpu]

Each mode of the tool maps to one of the port (``TOOL_MODES``):

    structured_stencil  structured_stencil  K1: the structured operator's ``apply_raw``
    uniform_xla         uniform_plain       K7's plain torch version inside the same gather/scatter
    uniform_pallas      uniform_kernel      K7: the ``uniform`` operator's ``apply_raw``
    matfree_xla         matfree             the ``hex8_matfree`` operator (torch, no kernel)
    stored_xla          stored_plain        K6's plain torch version inside the same gather/scatter
    stored_pallas       stored_kernel       K6: a prebuilt ``stored`` operator's ``apply_raw``

The stored modes run at half of each dimension (16x16x160 by default,
``stored_n_elements`` 40,960), as in the tool, so that the keys mean what
the tool's mean. Before any timing each mode's output on one random input
(``default_rng(0)``) is held against the plain f64 stencil apply of the
same input (``ops/structured.py::stencil_apply_grid``), within
``CHECK_TOL`` of max |K x|; a mode that fails makes the run exit 1.

Two times a mode: ``<mode>_ms``, the tool's own (20 chained calls, one
synchronize, over 20: the host's pace, which below ~1M DOF is not the
kernels' time), and on the card ``<mode>_graph_ms``, the median CUDA-graph
replay time of one call (``graph_ms``). ``csr_ms`` / ``csr_graph_ms``:
one cuSPARSE CSR SpMV (``torch.mv``) of the same assembled matrix, built
on the device from the stencil's region table, the library line.
``stencil_hbm_gbps_min`` is the tool's figure (one read and one write of
the (N, 3) f32 vector in ``structured_stencil_ms``), beside its share of
the card's 3.35 TB/s and the same two from the graph time. Prints one
JSON line.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from ..assembly import gather_element_dofs
from ..operator import build_operator
from ..ops.cuda_apply import batched_matvec_stored_plain, batched_matvec_uniform_plain
from ..ops.structured import build_structured_operator, stencil_apply_grid
from ..scene import resolve_device
from . import scenes
from ._family import Stages, add_common_args, cli, device_label, graph_ms, region_field, stencil_csr, sync

__all__ = ["TOOL_MODES", "main", "plain_apply_raw"]

TOOL_MODES = {"structured_stencil": "structured_stencil", "uniform_xla": "uniform_plain",
              "uniform_pallas": "uniform_kernel", "matfree_xla": "matfree", "stored_xla": "stored_plain",
              "stored_pallas": "stored_kernel"}
CHECK_TOL = 2e-5  # an f32 apply against the f64 plain apply, relative to max |K x|
HBM_BYTES_PER_S = 3.35e12  # NVIDIA H100 SXM data sheet
CHAIN = 20  # the tool's chained calls a timing


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--nx", type=int, default=32)
    p.add_argument("--ny", type=int, default=32)
    p.add_argument("--nz", type=int, default=320)
    add_common_args(p)
    return p.parse_args(argv)


def failed(rec: dict) -> bool:
    return bool(rec.get("partial")) or not rec.get("checks_passed")


def main(argv=None) -> dict:
    args = parse(argv)
    device = resolve_device(args.device)
    st = Stages("spmv", device, deadline_s=args.deadline_s)
    return st.run(lambda: run(args, st))


def plain_apply_raw(op, u: torch.Tensor) -> torch.Tensor:
    """``op.apply_raw(u)`` of a ``stored`` or ``uniform`` operator with the
    element apply's plain torch version (K6's or K7's twin) on any device:
    the same gather and incidence-plan sum around it."""
    u_e = gather_element_dofs(u, op.elements)
    E, npe, dpn = u_e.shape
    plain = batched_matvec_stored_plain if op.kind == "stored" else batched_matvec_uniform_plain
    f_e = plain(op.ke, u_e.reshape(E, npe * dpn))
    return op.plan.scatter_add(f_e.reshape(-1)).reshape(op.free.shape)


def chained_ms(fn, x: torch.Tensor, device: torch.device) -> float:
    """The tool's time: ``CHAIN`` calls each on the last one's output, one
    synchronize, over ``CHAIN`` (one call first, outside the time)."""
    fn(x)
    sync(device)
    y = x
    t0 = time.perf_counter()
    for _ in range(CHAIN):
        y = fn(y)
    sync(device)
    return (time.perf_counter() - t0) / CHAIN * 1e3


def run(args, st: Stages) -> dict:
    dev = st.device
    f32 = torch.float32
    dims = (args.nx, args.ny, args.nz)
    dims_s = (args.nx // 2, args.ny // 2, args.nz // 2)
    with st.stage("scenes"):
        scene, _ = scenes.cantilever(dims, device=dev)
        scene_s, _ = scenes.cantilever(dims_s, device=dev)
    st.extra.update(backend=device_label(dev), n_dof=scene.n_dof, n_elements=scene.n_elements,
                    stored_n_elements=scene_s.n_elements)
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(size=(scene.n_nodes, 3)), device=dev).to(f32)
    x_s = torch.as_tensor(rng.normal(size=(scene_s.n_nodes, 3)), device=dev).to(f32)

    with st.stage("build"):
        op_st = build_structured_operator(scene, dims, dtype=f32)
        op_u = build_operator(scene, dtype=f32, uniform=True)
        op_mf = build_operator(scene, dtype=f32, uniform=False)
        op_s = build_operator(scene_s, dtype=f32, uniform=False)
        op_s = dataclasses.replace(op_s, kind="stored", ke=op_s.element_matrices().contiguous(), geom=None,
                                   material=None)
        A = stencil_csr(region_field(op_st.weights.table, *op_st.grid_shape))
    modes = {  # mode -> (apply of an (N, 3) f32 x, its input)
        "structured_stencil": (op_st.apply_raw, x),
        "uniform_plain": (lambda v: plain_apply_raw(op_u, v), x),
        "uniform_kernel": (op_u.apply_raw, x),
        "matfree": (op_mf.apply_raw, x),
        "stored_plain": (lambda v: plain_apply_raw(op_s, v), x_s),
        "stored_kernel": (op_s.apply_raw, x_s),
        "csr": (lambda v: torch.mv(A, v.reshape(-1)).reshape(v.shape), x),
    }

    with st.stage("check"):
        want = {}
        for name, sc, d, v in (("full", scene, dims, x), ("half", scene_s, dims_s, x_s)):
            ke64 = build_structured_operator(sc, d, dtype=torch.float64).ke
            Z, Y, X = d[2] + 1, d[1] + 1, d[0] + 1
            want[v.shape[0]] = stencil_apply_grid(ke64, v.double().reshape(Z, Y, X, 3), d).reshape(-1, 3)
        errs = {}
        for mode, (fn, v) in modes.items():
            ref = want[v.shape[0]]
            errs[mode] = float((fn(v).double() - ref).abs().max() / ref.abs().max())
            st.say(f"{mode}: max error {errs[mode]:.3e} of max |K x|")
        del want
    passed = all(e <= CHECK_TOL for e in errs.values())

    rec = dict(checks=errs, checks_passed=passed, check_tol=CHECK_TOL)
    for mode, (fn, v) in modes.items():
        with st.stage(mode):
            rec[f"{mode}_ms"] = chained_ms(fn, v, dev)
            if dev.type == "cuda":
                rec[f"{mode}_graph_ms"] = graph_ms(lambda: fn(v))
        st.say(f"{mode}: {rec[f'{mode}_ms']:.4f} ms (host pace)"
               + (f", {rec[f'{mode}_graph_ms']:.4f} ms (graph)" if dev.type == "cuda" else ""))

    nbytes = 2 * scene.n_dof * 4
    for key, ms_key in (("stencil_hbm_gbps_min", "structured_stencil_ms"),
                        ("stencil_graph_hbm_gbps_min", "structured_stencil_graph_ms")):
        if ms_key in rec:
            rec[key] = nbytes / (rec[ms_key] * 1e-3) / 1e9
            rec[key.replace("gbps_min", "share")] = rec[key] * 1e9 / HBM_BYTES_PER_S
    return rec


if __name__ == "__main__":
    cli(main, failed)
