"""The seven sharding modes of the reference's multichip dry run, over a
list of N devices, on tiny scenes.

    python -m fea_tpu_torch.dryrun N                # N shards round-robin over the visible cards
    python -m fea_tpu_torch.dryrun N --device cpu   # N shards on the CPU

Counterpart of ``__graft_entry__.py::_dryrun_impl``: the same scenes, the
same solves and the same asserts, on ``parallel.make_device_mesh(N)``
(one card repeats when fewer cards are visible). One line a mode, then a
closing line; any failure raises.

  1. element decomposition (``shard_operator``) in ``solve_operator`` CG;
  2. ``sharded_sweep`` of N scaled load cases;
  3. the voxel operator on z slabs (``shard_structured_operator``) in CG;
  4. the same in f64 flexible PCG with the unsharded V-cycle beside it
     (``replicated_precond``);
  5. the z-sharded voxel solve (``build_zsharded_solver``); 5b the same
     scene through ``solve(config=SolverConfig(sharded=True))``, which
     shards when more than one card is visible;
  6. the extruded (tube) pipeline on layer slabs (``shard_extruded``)
     through ``solve_extruded``;
  7. the curvilinear pipeline on z slabs (``shard_curvilinear``, the slab
     form of K4/K5) in f64 flexible PCG.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

__all__ = ["main", "run"]


def _check(ok: bool, what: str) -> None:
    """The reference's asserts, kept under ``python -O``."""
    if not ok:
        raise AssertionError(f"dryrun: {what}")


def _tip_loads(nodes: np.ndarray, total: float = 1.0) -> np.ndarray:
    loads = np.zeros_like(nodes)
    tip = nodes[:, 2] == nodes[:, 2].max()
    loads[tip, 1] = total / tip.sum()
    return loads


def _tiny_scene(ftt, dtype, nx, ny, nz, device):
    """``__graft_entry__.py::_tiny_scene``: a 0.1 x 0.1 x 0.4 voxel
    cantilever, E = 1e7, nu = 0.3, a unit +y load on the tip face."""
    from .ops.structured import structured_scene

    mat = ftt.Material(E=1e7, nu=0.3)
    scene, dims = structured_scene(nx, ny, nz, 0.1, 0.1, 0.4, mat, dtype=dtype, device=device)
    nodes = scene.host_nodes
    scene = ftt.make_scene(nodes, scene.host_elements, scene.fixed.cpu().numpy(), _tip_loads(nodes), mat,
                           dtype=dtype, device=device)
    return scene, dims


def run(n: int, device: Optional[str] = None) -> None:
    """Run the seven modes over ``make_device_mesh(n, device)``: scenes on
    the card (``device=None``) or on ``device``; prints one line a mode."""
    import fea_tpu_torch as ftt
    from .ops.curvilinear import build_curv_multigrid, build_curv_operator, infer_topo_dims
    from .ops.extruded import extruded_scene_tube
    from .ops.multigrid import build_multigrid
    from .ops.structured import build_structured_operator, structured_scene
    from .parallel import (build_zsharded_solver, make_device_mesh, replicated_precond, shard_curvilinear,
                           shard_extruded, shard_operator, shard_structured_operator, sharded_sweep)
    from .parallel.halo import to_device
    from .solve import solve_displacements, solve_extruded, solve_operator, solve_operator_fpcg

    devices = make_device_mesh(n, device)
    dev = devices[0]
    t0 = time.perf_counter()

    def done(mode: str, what: str) -> None:
        print(f"dryrun({n}) mode {mode}: {what} ({time.perf_counter() - t0:.2f} s)", flush=True)

    # 1) element decomposition, CG on the sharded operator
    scene, _ = _tiny_scene(ftt, torch.float32, 2, 2, 6, dev)
    op = ftt.build_operator(scene, dtype=torch.float32, uniform=False)
    sop = shard_operator(op, devices)
    zero = scene.prescribed_or_zero(torch.float32)
    sol = solve_operator(sop, scene.loads, zero, method="cg", tol=1e-5, max_iters=500)
    _check(sol.displacements.shape == scene.loads.shape, "mode 1 displacements' shape")
    done("1", f"shard_operator ({op.kind}, {op.elements.shape[0]} elements in {n} blocks of "
              f"{sop.shards[0].elements.shape[0]}), CG {sol.stats.iterations} iterations")

    # 2) a batch of load cases, one block a device
    scales = torch.arange(1.0, n + 1.0, dtype=torch.float32, device=dev)
    loads_batch = scales[:, None, None] * scene.loads[None]
    ops = {d: to_device(op, d) for d in set(devices)}

    def solve_one(loads):
        o = ops[loads.device]
        return solve_displacements(o, loads, zero.to(loads.device), tol=1e-5, max_iters=500)

    u_batch = sharded_sweep(solve_one, loads_batch, devices)
    _check(u_batch.shape[0] == n, "mode 2 batch size")
    done("2", f"sharded_sweep of {n} cases, result {tuple(u_batch.shape)} on {u_batch.device}")

    # 3) the voxel operator on z slabs, CG
    scene_s, dims_s = _tiny_scene(ftt, torch.float32, 2, 2, 2 * n - 1, dev)
    op_st = build_structured_operator(scene_s, dims_s, dtype=torch.float32)
    op_sh, constrain = shard_structured_operator(op_st, devices)
    zero_s = constrain(scene_s.prescribed_or_zero(torch.float32))
    sol_s = solve_operator(op_sh, constrain(scene_s.loads), zero_s, method="cg", tol=1e-5, max_iters=500)
    _check(op_sh.gather(sol_s.displacements).shape == scene_s.loads.shape, "mode 3 displacements' shape")
    done("3", f"shard_structured_operator ({op_sh.z_real} planes, {op_sh.z_local} a shard), CG "
              f"{sol_s.stats.iterations} iterations")

    # 4) f64 flexible PCG on the z slabs, the unsharded f32 V-cycle beside them
    scene4, dims4 = _tiny_scene(ftt, torch.float64, 2, 2, 2 * n - 1, dev)
    op4 = build_structured_operator(scene4, dims4, dtype=torch.float64)
    mg4 = build_multigrid(op4.astype(torch.float32), dtype=torch.float32)
    op4_sh, constrain4 = shard_structured_operator(op4, devices)
    sol4 = solve_operator_fpcg(op4_sh, constrain4(scene4.loads), constrain4(scene4.prescribed_or_zero(torch.float64)),
                               replicated_precond(op4_sh, mg4), tol=1e-8, max_iters=300)
    _check(sol4.stats.converged, "mode 4 converged")
    done("4", f"FCG on shard_structured_operator with the replicated V-cycle, {sol4.stats.iterations} iterations, "
              f"true residual {sol4.stats.relative_residual:.2e}")

    # 5) the z-sharded voxel solve
    mat5 = ftt.Material(E=6.9e10, nu=0.3)
    scene5, dims5 = structured_scene(4, 4, 2 * n, 0.1, 0.1, 1.0, mat5, dtype=torch.float64, device=dev)
    op5 = build_structured_operator(scene5, dims5, dtype=torch.float64)
    fixed5 = scene5.fixed.cpu().numpy()
    mg5 = build_multigrid(op5.astype(torch.float32), degree=2, dtype=torch.float32, small_level_dof=0,
                          coarse_dof_limit=300, free_np=1.0 - fixed5.astype(np.float64))
    nodes5 = scene5.host_nodes
    loads5 = _tip_loads(nodes5)
    solver5 = build_zsharded_solver(op5, mg5, devices)
    sol5 = solver5.solve(torch.as_tensor(loads5, device=dev), tol=1e-8, max_iters=100)
    _check(sol5.stats.converged, "mode 5 converged")
    done("5", f"build_zsharded_solver, {sol5.stats.iterations} iterations, true residual "
              f"{sol5.stats.relative_residual:.2e}")

    # 5b) the same scene through the public route
    scene5b = ftt.make_scene(nodes5, scene5.host_elements, fixed5, loads5, mat5, dtype=torch.float64, device=dev)
    sol5b = ftt.solve(scene5b, config=ftt.SolverConfig(sharded=True), tol=1e-8)
    _check(sol5b.stats.converged, "mode 5b converged")
    u5 = sol5.displacements.to(sol5b.displacements.device)
    _check(float((sol5b.displacements - u5).abs().max()) < 1e-9 * float(u5.abs().max()), "mode 5b agrees with 5")
    n_cards = torch.cuda.device_count() if dev.type == "cuda" else 1
    done("5b", f"solve(SolverConfig(sharded=True)) agrees with mode 5 ({n_cards} card(s) visible: it shards only "
               f"with more than one)")

    # 6) the extruded pipeline on layer slabs
    tube, det6 = extruded_scene_tube(8, 4 * n, 0.08, 0.1, 0.6, mat5, dtype=torch.float64, device=dev)
    nodes6 = tube.host_nodes
    scene6 = ftt.make_scene(nodes6, tube.host_elements, tube.fixed.cpu().numpy(), _tip_loads(nodes6), mat5,
                            dtype=torch.float64, device=dev)
    op6, mg6 = ftt.build_extruded(scene6, det6)
    op6_s, mg6_s, _ = shard_extruded(op6, mg6, devices)
    sol6 = solve_extruded(scene6, det6, tol=1e-8, max_iters=300, prebuilt=(op6_s, mg6_s))
    _check(sol6.stats.converged, "mode 6 converged")
    done("6", f"shard_extruded ({op6_s.z_real} layers, {op6_s.z_local} a shard), solve_extruded "
              f"{sol6.stats.iterations} iterations")

    # 7) the curvilinear pipeline on z slabs
    nodes7, elements7 = ftt.mesh.box_hex_mesh(3, 3, 2 * n - 1, 0.3, 0.3, 1.5)
    rng7 = np.random.default_rng(5)
    interior7 = (nodes7[:, 2] > 1e-12) & (nodes7[:, 2] < 1.5 - 1e-12)
    nodes7 = nodes7 + 0.02 * rng7.uniform(-1, 1, nodes7.shape) * interior7[:, None]
    fixed7 = np.zeros_like(nodes7)
    fixed7[np.abs(nodes7[:, 2]) < 1e-9] = 1.0
    scene7 = ftt.make_scene(nodes7, elements7, fixed7, _tip_loads(nodes7), mat5, dtype=torch.float64, device=dev)
    dims7 = infer_topo_dims(scene7)
    op7 = build_curv_operator(scene7, dims7, dtype=torch.float64)
    mg7 = build_curv_multigrid(op7.w, dims7, 1.0 - fixed7, degree=2)
    op7_s, mg7_s, con7 = shard_curvilinear(op7, mg7, devices)
    sol7 = solve_operator_fpcg(op7_s, con7(scene7.loads), con7(scene7.prescribed_or_zero(torch.float64)), mg7_s,
                               tol=1e-8, max_iters=200)
    _check(sol7.stats.converged, "mode 7 converged")
    done("7", f"shard_curvilinear ({op7_s.z_real} planes, {op7_s.z_local} a shard), FCG {sol7.stats.iterations} "
              f"iterations")
    print(f"dryrun({n}): all seven sharding modes executed on {[str(d) for d in devices]}", flush=True)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="python -m fea_tpu_torch.dryrun", description=__doc__.splitlines()[0])
    parser.add_argument("n", type=int, help="number of shards")
    parser.add_argument("--device", default=None, help="'cpu' to run on the CPU (default: the visible cards)")
    args = parser.parse_args(argv)
    run(args.n, args.device)


if __name__ == "__main__":
    main()
