#!/usr/bin/env python3
"""The JAX package's mixed-precision refinement on the scenes of
``chip_smoke.py`` [19], run on the CPU in f64: the yardsticks that
``chip_smoke.py`` keeps as the constant ``REFINE_JAX``.

    JAX_PLATFORMS=cpu python refine_yardsticks.py [--history] [voxel] [box] [stored]

Each scene goes through the body of ``fea_tpu.solve_operator_refined``
(``fea_tpu.solvers.refine.pcg_refined`` on ``op_hi.rhs``, x0 = the
prescribed values, the Jacobi diagonal of ``op_lo``) with the config's
defaults (inner_tol 1e-3, inner_iters 2000, max_outer 25) and tol
1e-8. Printed, one JSON line a scene: the outer steps (counted as the
f64 applies less the first), the inner iterations in all, converged, the
reported residual and the true relative residual recomputed through the
f64 operator. ``--history`` also runs each scene with max_outer = 1, 2,
... up to its outer steps and prints, for each, the inner iterations in
all and the outer residual: where a refined solve stops is a threshold
(the outer residual against tol), so two implementations of the same
inner solve can stop one outer step apart, and the comparison that
does not depend on where the threshold falls is over the same number of
outer steps. Scenes:

  voxel:  the 16x16x160 cantilever of bench.py's geometry (139,587 DOF):
          0.1 x 0.1 x 1.0, E = 10e6 psi, nu = 0.3, z = 0 fixed, a +y tip
          shear of 100 lbf/ft x 1 ft; the structured operator;
  box:    the 12x12x96 cantilever of chip_smoke.py [9] (49,179 DOF),
          0.1 x 0.1 x 0.8, a +y tip load of 1.0; the uniform element
          operator;
  stored: the same box with its interior nodes moved by 0.25 h U(-1, 1)
          (seed 7), its element matrices stored.

This imports JAX and the JAX package; the port never does.
"""
from __future__ import annotations

import dataclasses
import json
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import fea_tpu as ft  # noqa: E402
from fea_tpu.config import DEFAULT_CONFIG  # noqa: E402
from fea_tpu.ops.structured import build_structured_operator  # noqa: E402
from fea_tpu.solvers.refine import pcg_refined  # noqa: E402

TOL = 1e-8
EBE_BOX, EBE_LZ = (12, 12, 96), 0.8


def voxel():
    nx, ny, nz = 16, 16, 160
    nodes, elements = ft.mesh.box_hex_mesh(nx, ny, nz, 0.1, 0.1, 1.0)
    fixed = ft.fix_where(nodes, lambda p: p[:, 2] == 0.0, 3)
    loads = np.zeros_like(nodes)
    tip = nodes[:, 2] == 1.0
    loads[tip, 1] = 100.0 * ft.units.lbf / ft.units.ft * 1.0 / tip.sum()
    mat = ft.Material(E=10_000_000 * ft.units.psi, nu=0.3)
    scene = ft.make_scene(nodes, elements, fixed, loads, mat, dtype=jnp.float64)
    return scene, build_structured_operator(scene, (nx, ny, nz), dtype=jnp.float64)


def box_arrays(distort: bool):
    nodes, elements = ft.mesh.box_hex_mesh(*EBE_BOX, 0.1, 0.1, EBE_LZ)
    if distort:
        rng = np.random.default_rng(7)
        h = 0.1 / EBE_BOX[0]
        interior = (nodes[:, 2] > 0) & (nodes[:, 2] < EBE_LZ)
        nodes = nodes + 0.25 * h * rng.uniform(-1, 1, nodes.shape) * interior[:, None]
    fixed = ft.fix_where(nodes, lambda q: np.isclose(q[:, 2], 0.0), 3)
    loads = np.zeros_like(nodes)
    tip = np.isclose(nodes[:, 2], EBE_LZ)
    loads[tip, 1] = 1.0 / tip.sum()
    mat = ft.Material(E=10_000_000 * ft.units.psi, nu=0.3)
    return ft.make_scene(nodes, elements, fixed, loads, mat, dtype=jnp.float64)


def box():
    scene = box_arrays(False)
    op = ft.build_operator(scene, dtype=jnp.float64)
    assert op.kind == "uniform", op.kind
    return scene, op


def stored():
    scene = box_arrays(True)
    mf = ft.build_operator(scene, dtype=jnp.float64)
    op = dataclasses.replace(mf, kind="stored", ke=mf.element_matrices(), geom=None, material=None)
    return scene, op


def run(name, make, history=False):
    scene, op_hi = make()
    op_lo = op_hi.astype(jnp.float32)
    presc = scene.prescribed_or_zero(jnp.float64)
    calls = [0]

    def tick():
        calls[0] += 1

    def apply_hi(x):  # counted by a host callback, once an execution
        jax.debug.callback(tick)
        return op_hi.apply(x)

    cfg = DEFAULT_CONFIG

    def refined(loads, presc, max_outer=cfg.max_outer):
        b = op_hi.rhs(loads, presc)
        x0 = (1.0 - op_hi.free) * presc
        return pcg_refined(apply_hi, op_lo.apply, b, x0, precond_diag_lo=op_lo.diag_masked(), tol=TOL,
                           max_outer=max_outer, inner_tol=cfg.inner_tol, inner_iters=cfg.inner_iters,
                           lo_dtype=jnp.float32, hi_dtype=jnp.float64)

    t0 = time.perf_counter()
    u, stats = jax.jit(refined)(scene.loads, presc)
    u = jax.block_until_ready(u)
    jax.effects_barrier()
    wall = time.perf_counter() - t0
    b = np.asarray(op_hi.rhs(scene.loads, presc))
    r = b - np.asarray(op_hi.apply(u))
    true_rel = float(np.linalg.norm(r) / np.linalg.norm(b))
    print(json.dumps(dict(
        scene=name, n_dof=scene.n_dof, outers=calls[0] - 1, inner_total=int(stats.iterations),
        converged=bool(stats.converged), reported=float(stats.relative_residual), true_rel=true_rel,
        max_u=float(np.abs(np.asarray(u)).max()), wall_s=round(wall, 1),
    )), flush=True)
    if history:
        outers = calls[0] - 1
        steps = []
        for k in range(1, outers + 1):
            _, st = jax.jit(lambda l, p, k=k: refined(l, p, max_outer=k))(scene.loads, presc)
            steps.append((int(st.iterations), float(st.relative_residual)))
        print(json.dumps(dict(scene=name, inner_by_outer=[n for n, _ in steps],
                              residual_by_outer=[r for _, r in steps])), flush=True)


if __name__ == "__main__":
    scenes = {"voxel": voxel, "box": box, "stored": stored}
    args = [a for a in sys.argv[1:] if a != "--history"]
    for name in args or list(scenes):
        run(name, scenes[name], history="--history" in sys.argv)
