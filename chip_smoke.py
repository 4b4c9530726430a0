#!/usr/bin/env python3
"""Smoke run of fea_tpu_torch on one CUDA card.

    python3 chip_smoke.py        # from the repository root, no flags

Phases, in order:
  1. device: the card's name and power limit (nvidia-smi), torch, CUDA
     and nvcc versions; raises without a card;
  2. build: compiles K1/K2 with their slab forms K1-halo/K3
     (fea_tpu_torch/csrc/stencil.cu), K4/K5
     (fea_tpu_torch/csrc/varstencil.cu) and K6/K7
     (fea_tpu_torch/csrc/element_apply.cu) for sm_90a, one nvcc each, in
     parallel; what ptxas says of the registers and spills of each kernel of
     stencil.cu, element_apply.cu and varstencil.cu;
  3. K1/K2 against their plain version on the card, at small shapes, at
     shapes that straddle the kernel's band, warp and chunk edges, at rows
     wider than a block (cut into segments), at every
     grid the flagship solve gives them and at the 8,124,675-DOF grid, with
     random inputs from a NumPy seed: K1 within 2e-5 and K2 within 1e-12
     (max error relative to max|K u|) of the plain version run in f64, raw
     and masked (a random 0/1 mask, and the flagship's own), the masked
     kernel also value for value against the unfused expression around the
     raw kernel; at every level grid of the flagship hierarchy and at
     8,124,675 DOF the CUDA-event times of each kernel raw and masked
     beside their bounds and beside the six launches the masked form
     replaces; at the flagship grid also the plain version and one
     cuSPARSE CSR SpMV of the same operator; the host's cost of one
     wrapper call;
  4. voxel slice: the flagship cantilever (32x32x320 voxels, 1,048,707
     DOF, the yardstick of bench.py) through ``fea_tpu_torch.solve``,
     checked by a true residual recomputed on the host in NumPy f64
     (independent of the kernels), the tip deflection against beam
     theory, and the launch counters of K1 and K2 over that one solve
     (credited per graph replay); then the FCG stage on one operator and
     hierarchy by the Python loop beside the staged loop of the routes
     (``loop_vs_staged``: iterations within 1, both host residuals <= tol,
     displacements within 10 tol, walls, device ms, busy share, device
     activities and host launch calls an iteration, replays, capture ms,
     iterations past convergence <= 2 a pass), and the freeze checks
     (zero rhs, exact ``max_iters``, a second solve replaying the same
     graph bit for bit the first);
  5. K4/K5 against their plain version on the card, as in phase 3, with
     symmetrized random weights (``symmetrize_field``: the kernels read 14
     of the 27 blocks and mirror the rest) and random input at small shapes
     and at every level grid of the 811,923-DOF curvilinear hierarchy, and
     on that hierarchy's real fields (each first held to be its own mirror
     exactly): K4 within 2e-5, K5 within 1e-12, raw and masked
     (``var_apply_masked`` within the same of F K(F g) + (1 - F) g, and value
     for value that expression around the raw kernel); at the fine grid the
     card's time (graph replays) and the host's pace, raw and masked, the
     plain version, a CSR SpMV, and the 27- and 14-block bounds;
  6. curvilinear slice: the distorted 40x40x160 cantilever of
     tools/curv_bench.py (811,923 DOF) through ``fea_tpu_torch.solve``,
     checked on the host by an element-by-element K u in NumPy f64 that
     shares no code with the package, the tip deflection, and the launch
     counters (K4/K5 launched, K1/K2 not), the iterations within 1 of 48,
     every weight field the solve handed to K4/K5 its own mirror exactly
     (``FieldSpy``; so in [7], [14] and [18.5]); before it, the routing
     detectors and the first torch.linalg call timed apart; after it, the
     stage times, the level grids, the peak memory, ``loop_vs_staged`` as
     in [4], the device memory the build cache keeps for the mesh once the
     solve has returned, and a second ``solve()`` of the mesh with new
     loads, which must take its build from the cache and pass the host
     check;
  7. canonicalized slice: the 24x24x96 distorted scene of
     tools/canon_bench.py (181,875 DOF) with its nodes renumbered by a
     seeded permutation, through ``fea_tpu_torch.solve``; its solution,
     permuted back, is checked against the host f64 true residual of the
     original system; ``loop_vs_staged`` on the canonical scene and a
     cached second solve, as in [6];
  8. K6/K7 against their plain version on the card: random inputs from a
     NumPy seed at E in {1, 700, 1030} and k in {4, 6, 24}, at E in
     {127, 128, 129} (around K7's tile) and k in {1, 4, 6, 24, 32}, at every
     (E, k) that phase [9] gives them (APPLY_PATH), and at the 327,680
     elements of the 32x32x320 mesh at k = 24: f32 within 2e-5 and f64
     within 1e-12 of the plain version run in f64; at 327,680 elements and
     at the 13,824 of phase [9.2]'s box, the CUDA-event times of each
     kernel, of its plain version and of one library call (torch.bmm for
     K6, torch.matmul for K7, TF32 off), beside the kernel's bound;
  9. element-by-element slice through ``fea_tpu_torch.solve``: the
     cubebeam demo by cg and dense in f64 and by cg in f32 (K7); the
     49,179-DOF voxel cantilever, auto-routed to Jacobi PCG over the
     uniform operator (K7 f64 every iteration), checked by the host f64
     true residual, max|u| and the tip deflection, with a torch.profiler
     trace of its CG loop; the same box distorted, solved by the matfree
     operator (no kernel) and by a prebuilt stored operator (K6 f64 every
     iteration), which must agree; beams and bars (K6 at k = 4 and 6, f64
     and f32) and the Newton-Krylov truss;
 10. K1's halo form (f32) and K3 (f64) against their plain version on the
     card, within 2e-5 and 1e-12 of it run in f64, raw and masked, and bit
     for bit the unchunked K1/K2 (the script fails otherwise): each shard's slab of
     small grids and of the flagship cut as [12] cuts it into 2, 3, 4 and
     8 shards (padding past a whole shard included), beside the unchunked
     K1/K2 (bit for bit?); ``stencil_apply_chunked`` on the flagship in 4
     slabs and on the 8,124,675- and 16,236,675-DOF capacity grids in the
     reference's 3 and 6 chunks (``dd_z_chunks``), within 1e-15 of the
     unchunked K1/K2; CUDA-event times of one apply over the four
     halo-extended shards that [12]'s solver runs, at the host's pace and
     on the card (graph replay), at the flagship and at 8,124,675 DOF,
     beside K1/K2 unchunked, the plain version (flagship),
     one cuSPARSE CSR SpMV (where it fits the card's free memory) and the
     bound;
 11. capacity: the 64x64x640 cantilever (8,124,675 DOF, bench.py's
     capacity_8m) through ``fea_tpu_torch.solve`` on the one card, K2
     unchunked: the host f64 true residual by ``host_ku``, the tip ratio,
     the iteration count beside the reference's, stage times, peak
     memory with [4], [6] and [7]'s builds still cached (allocated and
     reserved; without what ``clear_build_cache`` then frees of those
     meshes' entries, <= 2.0 GB),
     no slab launched, and ``loop_vs_staged``;
 12. z-sharded solve: ``build_zsharded_solver`` over four shards on the
     one card at the flagship and at 8,124,675 DOF, against the unsharded
     solves of [4] and [11]: host f64 true residual, iterations within 1,
     displacements within 10 tol, tip ratio; launches (K1-halo and K3 on
     the shards, K1/K2 only on the replicated coarse levels); wall time,
     launches an iteration and busy share (device time over the profiled
     run's wall) of both solves from a torch.profiler trace;
 13. ``solve_many``: tools/many_bench.py's 8 tip-load cases
     (``fea_tpu_torch.bench.many.tip_loads``) on the flagship grid, each
     host-checked by ``host_ku``, case 0 against a
     single ``solve()``, the batch's wall a case beside one warm solve
     (the build cache cleared before each, so both route, build and
     capture), peak memory;
 14. embedded slice: bench.py's ``arbitrary`` cell (tools/arbitrary_bench.py:
     the 40x40x144 L-domain, 554,115 DOF in a 243,745-node box, interior
     nodes moved by 0.2 h U(-1, 1), seed 7) through ``fea_tpu_torch.solve``:
     K4/K5 against their plain version on the void-masked fine field (void
     rows exactly zero), timed beside their bound, the plain version and a
     CSR SpMV; the solve (K4/K5 launched, K1/K2 not, the AMG route never
     called), host-checked by ``host_ku`` on the real mesh, its iterations
     beside the reference's, the set-up stages, the FCG stage, the peak
     memory, a second ``solve()`` from the cache, ``loop_vs_staged``, and
     ``solve_many`` of 8 tip loads, each host-checked;
 15. AMG slice: the same scene with ``FEA_TPU_NO_EMBED`` set (restored
     after), through ``solve()``: the AMG route (the embedded one never
     called), its set-up by stage, iterations beside the reference's, the
     host check, the BCSR apply in f64 and f32 timed on the card beside its
     byte bound and cuSPARSE (CSR; BSR where torch takes it), and
     ``loop_vs_staged``;
 16. two-level slice: the 20x20x72 L-domain (73,899 DOF, the tool's default
     size) with ``FEA_TPU_NO_EMBED`` and ``FEA_TPU_NO_AMG`` set: the
     two-level route, its builds, iterations and host check, the
     element-by-element (``hex8_matfree``) apply timed as in [15], and the
     block-Jacobi fallback, forced once by a failing two-level build;
 17. extruded slice: tools/tube_bench.py's tube (a 256-segment annulus of
     4 in / 3.9 in radii, 2 ft long, 384 element layers: 591,360 DOF, z = 0
     fixed, a cosine 1000 lbf tip load) through ``fea_tpu_torch.solve``: the
     route ``fpcg-extruded-multigrid`` (the curvilinear one never called),
     converged, the host f64 true residual by ``host_ku`` <= 1e-8, the y-sum
     of the reactions over the fixed ring balancing the load within 1e-6,
     no kernel launched, iterations beside the reference's 26; the set-up by
     stage (detector, operator, hierarchy, section coarse, FCG), peak
     memory, a second ``solve()`` from the cache, ``loop_vs_staged``,
     ``solve_many`` of 4 loads from ``default_rng(17)`` each host-checked;
     the card times of the f64 and f32 applies (beside cuSPARSE CSR of the
     assembled matrix), the level-0 block-Jacobi, the z-coarse Thomas solve,
     the section coarse solve, the whole preconditioner and one FCG step,
     each beside its bound;
 18. sharded modes: every decomposition of ``fea_tpu_torch.parallel`` over
     four shards of the one card (``make_device_mesh(4)`` repeats it):
     K4-slab and K5-slab on the four slabs of the 811,923-DOF field and of
     its level 1 (symmetrized random fields, zero toward the planes past
     the z ends as assembled) against their plain version (f64) and, value
     for value, the unsharded K4/K5, raw and masked, timed beside them, the
     plain version, cuSPARSE CSR of the shards' rows and both bounds;
     ``shard_operator`` on [9]'s
     box (K7 f64) and its distorted twin's stored operator (K6 f64),
     ``sharded_sweep`` of four scaled tip loads on the box,
     ``shard_structured_operator`` on the flagship with the unsharded
     V-cycle beside it, ``shard_curvilinear`` on [6]'s cantilever (with the
     memory a shard keeps, and its FCG stage's device time and busy
     share), ``shard_extruded`` on [17]'s tube through
     ``solve_extruded``: each solve host-checked by ``host_ku``, its
     iterations and displacements held against the unsharded solve, its
     wall beside the unsharded Python loop's; then
     ``python -m fea_tpu_torch.dryrun 4``, all seven modes; and the four
     K4/K5 rows side by side (``var_summary``);
 19. the rest of the reference: ``solve_operator_refined`` (the f64
     refinement loop around an f32 Jacobi PCG) on the 16x16x160 voxel
     cantilever (139,587 DOF; K2 outside, K1 inside), on [9]'s box (K7 f64 /
     f32) and on its distorted twin's stored operator (K6 f64 / f32), each
     converged, host-checked by ``host_ku``, within 1e-6 of ``solve()``'s
     displacements, its outer steps and inner iterations beside the
     reference's (``REFINE_JAX``, from refine_yardsticks.py), its launches
     exactly those of its outer and inner applies; the outer loop's guard
     against a NaN and a negated inner apply; ``solve(debug_nans=True)`` on
     the flagship (as without it, both walls) and on a NaN load (raises),
     and a K2 launch on a NaN input under the sanitizer (raises, naming the
     kernel); ``native``'s residual of [4]'s solution against ``host_ku``'s;
     ``utils`` (a Timer, a record, a trace holding K2's kernel); each demo
     of ``fea_tpu_torch.examples`` in this process, its printed anchors
     against the CPU's;
 20. the benchmark: ``python bench_torch.py --repeats 2`` as a child
     process at its default shapes, with its nine families: rc 0, its final
     line (printed here) at most 1,500 bytes, the flagship converged with
     a host f64 true residual <= 1e-8, a tip ratio in (0.70, 1.30), at
     most 13 iterations (the reference's BENCH_r04 count) and its f64 apply
     within 1e-12 of the host's exact one, and every family converged at
     its JAX tool's DOF count (``many``: every one of its 8 cases;
     ``unstructured`` at 181,875 and ``unstructured_812k`` at 811,923 DOF);
 21. the measurement tools of ``fea_tpu_torch.bench``, each a child process
     with its own timeout, each gated on rc 0: ``spmv`` at the flagship
     (every operator mode within 2e-5 of the f64 plain apply, timed at the
     host's pace and by graph replay, K1, K6 and K7 launched),
     ``microbench`` (its kept keys finite, by graph replay, K1/K2
     launched), ``profile`` (every piece timed, the staged solve converged
     with a host residual <= 1e-8 in at most 13 iterations),
     ``scipy_compare`` at 8x8x320 (78,003 DOF: the voxel route, K1/K2
     launched, within 1e-8 of SuperLU's displacements, its host true
     residual no worse than SuperLU's: tol 1e-10 lies under this bar's
     f64 floor, so the solve ends unconverged there), ``prewarm`` (the kernels
     built, the flagship converged); the kernels each child launched go
     into the kernels line as ``tools_launches``;
 22. one JSON line of the kernels (K1, K2, K6, K7 with their launches in
     [19]'s refined solves as ``refined_launches``), one of the compute with
     no TPU kernel, the card's line, then the last line
     ``{"ok": true, "device": {...}}``.

Any failure raises, and the script exits non-zero without the last line.
"""
from __future__ import annotations

import copy
import dataclasses
import gc
import json
import os
import signal
import statistics
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from fea_tpu_torch.bench import scenes  # noqa: E402
from fea_tpu_torch.bench._family import (graph_ms, host_check, host_ku, region_field,  # noqa: E402
                                         stencil_csr)

DEV = "cuda"
FLAGSHIP = (32, 32, 320)
# small shapes, shapes that straddle the kernel's band, warp and chunk edges
# (all three counts odd and unequal; two planes only; one row of elements),
# the widest row a block holds whole (256 nodes) and a wider one, which the
# kernel cuts into segments, and the flagship hierarchy's grids (2^k + 1
# nodes an axis)
SHAPES = [(1, 1, 1), (3, 2, 5), (13, 7, 29), (5, 9, 1), (40, 1, 3), (255, 1, 2), (300, 2, 3), (4, 4, 8), (2, 2, 20),
          (4, 4, 40), (8, 8, 80), (16, 16, 160), FLAGSHIP]
CURV = (40, 40, 160)  # bench.py's curvilinear_812k
CANON = (24, 24, 96)  # bench.py's canonicalized
VAR_SMALL = [(1, 1, 1), (3, 4, 6)]
TIP_BAND = (0.70, 1.30)  # bench.py's band for the FEM / beam-theory tip ratio
MAX_ITERS = 16
CURV_MAX_ITERS = 80
# the port's iteration counts on [6], [7] and [14]'s scenes (PERF.md section 5); the symmetric
# K4/K5 leave them as they were
CURV_ITERS, CANON_ITERS, EMBED_ITERS = 48, 48, 59
CANON_TOL = 2e-8
# tests/test_pallas.py's E, and E around K7's tile of 128 elements at every kind of k
APPLY_SMALL = ([(E, k) for E in (1, 700, 1030) for k in (4, 6, 24)]
               + [(E, k) for E in (127, 128, 129) for k in (1, 4, 6, 24, 32)])
APPLY_FULL = (32 * 32 * 320, 24)  # the elements of the 32x32x320 mesh, a timing size only
EBE_BOX = (12, 12, 96)  # the largest voxel cantilever the auto route sends to Jacobi PCG
CUBEBEAM_BOX = (4, 4, 49)
BEAM_ELEMENTS = (100, 40)  # examples/euler_bernoulli.py's beam, tests/test_beam.py's cg beam
TRIPOD_BARS = 3
# (E, k) of every element apply phase [9] launches: cubebeam and the box
# (hex8, k = 24; the distorted box has the same E), the beams (k = 4), the
# bar3d tripod (k = 6); the truss's Newton solve runs no element kernel
APPLY_PATH = ([(int(np.prod(CUBEBEAM_BOX)), 24), (int(np.prod(EBE_BOX)), 24)]
              + [(n, 4) for n in BEAM_ELEMENTS] + [(TRIPOD_BARS, 6)])
APPLY_TIMED = (APPLY_FULL, APPLY_PATH[1])
EBE_LZ = 0.8
EBE_JAX_ITERS = 404  # fea_tpu.solve on this scene, JAX on the CPU in f64
EBE_MAX_U = 2.968e-7  # max|u| of the same JAX solve
EBE_DISTORTED_JAX_ITERS = 1053  # fea_tpu.solve on the distorted box, JAX on the CPU in f64
CAPACITY = (64, 64, 640)  # bench.py's capacity_8m: 8,124,675 DOF
CAPACITY_16M = (64, 64, 1280)  # the 16,236,675-DOF capacity grid of ROADMAP queue 1 item 7
CAPACITY_REF_ITERS = 19  # BENCH_r05's capacity_8m (the JAX package on its TPU): a count, not a time
# (dims, shards) of the slab checks at small shapes: 2x2x12 over 8 pads past
# a whole shard (tests/test_halo_sharding.py's choice)
SLAB_SMALL = [((2, 2, 12), 8), ((2, 2, 12), 3), ((3, 2, 5), 8), ((3, 2, 5), 2), ((4, 4, 40), 3),
              ((13, 7, 29), 4),  # 30 planes over 4 shards of 8: the z-max plane falls mid-slab
              ((300, 2, 6), 2)]  # rows of 301 nodes, cut into segments
SLAB_FLAGSHIP_SHARDS = (2, 3, 4, 8)
SHARDS = 4  # [12]: four shards, all on the one card
ARBITRARY = (40, 40, 144)  # bench.py's arbitrary cell: the L-domain of 554,115 DOF in a 243,745-node box
TWO_LEVEL_L = (20, 20, 72)  # tools/arbitrary_bench.py's default size: 73,899 DOF
# iteration counts of the JAX package on its TPU, not times: BENCH_r05's
# arbitrary (embedded), docs/PERF.md:916-926 (AMG on the same scene) and
# docs/PERF.md:913-915 (the two-level scheme at 74k, "57+")
EMBED_REF_ITERS = 72
AMG_REF_ITERS = 56
TWO_LEVEL_REF_ITERS = 57
# fea_tpu.solve(tol=1e-8) of the TWO_LEVEL_L scene with FEA_TPU_NO_EMBED and
# FEA_TPU_NO_AMG set, JAX on the CPU in f64: 28 iterations, residual 1.15e-9
TWO_LEVEL_JAX_ITERS = 28
CUBEBEAM_ANCHOR = 3.0504e-4  # max|u| of the cubebeam demo (tests/test_integration.py)
# NVIDIA H100 SXM data sheet: 3.35 TB/s of HBM3; 67 TFLOP/s f32 and
# 34 TFLOP/s f64 outside the tensor cores, at the full 700 W
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}
KERNELS = {
    "f32": dict(name="K1 stencil_apply_f32", source="fea_tpu_torch/csrc/stencil.cu",
                replaces="fea_tpu/ops/pallas_stencil.py:540", dtype=torch.float32, tol=2e-5),
    "f64": dict(name="K2 stencil_apply_f64", source="fea_tpu_torch/csrc/stencil.cu",
                replaces="fea_tpu/ops/pallas_stencil.py:756", dtype=torch.float64, tol=1e-12),
    "var_f32": dict(name="K4 var_apply_f32", source="fea_tpu_torch/csrc/varstencil.cu",
                    replaces="fea_tpu/ops/pallas_varstencil.py:183", dtype=torch.float32, tol=2e-5),
    "var_f64": dict(name="K5 var_apply_f64", source="fea_tpu_torch/csrc/varstencil.cu",
                    replaces="fea_tpu/ops/pallas_varstencil.py:277", dtype=torch.float64, tol=1e-12),
    "stored_f32": dict(name="K6 batched_matvec_stored_f32", source="fea_tpu_torch/csrc/element_apply.cu",
                       replaces="fea_tpu/ops/pallas_apply.py:47", dtype=torch.float32, tol=2e-5),
    "stored_f64": dict(name="K6 batched_matvec_stored_f64", source="fea_tpu_torch/csrc/element_apply.cu",
                       replaces="fea_tpu/ops/pallas_apply.py:47", dtype=torch.float64, tol=1e-12),
    "uniform_f32": dict(name="K7 batched_matvec_uniform_f32", source="fea_tpu_torch/csrc/element_apply.cu",
                        replaces="fea_tpu/ops/pallas_apply.py:90", dtype=torch.float32, tol=2e-5),
    "uniform_f64": dict(name="K7 batched_matvec_uniform_f64", source="fea_tpu_torch/csrc/element_apply.cu",
                        replaces="fea_tpu/ops/pallas_apply.py:90", dtype=torch.float64, tol=1e-12),
    # K1's z_halo=True form on one shard (fea_tpu/parallel/halo.py::_f32_apply_shard)
    "slab_f32": dict(name="K1-halo stencil_apply_slab_f32", source="fea_tpu_torch/csrc/stencil.cu",
                     replaces="fea_tpu/ops/pallas_stencil.py:540", dtype=torch.float32, tol=2e-5),
    "slab_f64": dict(name="K3 stencil_apply_slab_f64", source="fea_tpu_torch/csrc/stencil.cu",
                     replaces="fea_tpu/ops/pallas_stencil.py:108", dtype=torch.float64, tol=1e-12),
    # K4/K5 on one z slab of a sharded curvilinear grid (parallel/curv.py)
    "var_slab_f32": dict(name="K4-slab var_apply_slab_f32", source="fea_tpu_torch/csrc/varstencil.cu",
                         replaces="fea_tpu/ops/pallas_varstencil.py:183", dtype=torch.float32, tol=2e-5),
    "var_slab_f64": dict(name="K5-slab var_apply_slab_f64", source="fea_tpu_torch/csrc/varstencil.cu",
                         replaces="fea_tpu/ops/pallas_varstencil.py:277", dtype=torch.float64, tol=1e-12),
}
STENCIL_KEYS = ("f32", "f64")
VAR_KEYS = ("var_f32", "var_f64")
APPLY_KEYS = ("stored_f32", "stored_f64", "uniform_f32", "uniform_f64")
SLAB_KEYS = ("slab_f32", "slab_f64")


T_START = time.perf_counter()


def say(msg: str) -> None:
    print(msg, flush=True)


def phase(msg: str) -> None:
    """A phase's heading, with the seconds the script has run so far."""
    say(f"{msg} (at {time.perf_counter() - T_START:.0f} s)")


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


PTXAS_SOURCES = ("stencil.cu", "element_apply.cu", "varstencil.cu")  # the redesigned sources


def ptxas_log(nvcc, name: str) -> str:
    """What ``nvcc -Xptxas -v`` prints while it compiles source ``name``."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        cmd = [nvcc.find_nvcc(), *nvcc.NVCC_FLAGS, "-Xptxas", "-v", str(nvcc.CSRC / name), "-o", f"{tmp}/x.so"]
        return subprocess.run(cmd, capture_output=True, text=True, check=True, timeout=600).stderr


def ptxas_report(logs: dict) -> None:
    """The registers and spills of each kernel in ``logs`` (source name ->
    :func:`ptxas_log`), one line a kernel."""
    import re

    for name, log in logs.items():
        lines = log.splitlines()
        for i, line in enumerate(lines):
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                parts = re.search(r"\d+((?:stencil27|uniform_tile|uniform|stored|var27_sym)_kernel)I([df])"
                                  r"(?:Li(\d+)E)?(?:Lb([01])E)?(?:Lb([01])E)?", m.group(1))
                var = parts is not None and parts.group(1) == "var27_sym_kernel"
                kernel = m.group(1)[-40:] if not parts else (
                    f"{parts.group(1)}<{'double' if parts.group(2) == 'd' else 'float'}"
                    + (f", {parts.group(3)}" if parts.group(3) else "")
                    + (("" if parts.group(4) is None else ", slab" if parts.group(4) == "1" else ", whole")
                       + (", masked" if parts.group(5) == "1" else ", raw") if var else
                       ("" if parts.group(4) is None else ", masked" if parts.group(4) == "1" else ", raw")
                       + (", segments" if parts.group(5) == "1" else "")) + ">")
                info = " ".join(lines[i + 1 : i + 4])
                regs = re.search(r"Used (\d+) registers", info)
                spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", info)
                say(f"  {name} {kernel}: {regs.group(1) if regs else '?'} registers, spills "
                    f"{spill.group(1) if spill else '?'} / {spill.group(2) if spill else '?'} bytes")


def neighbour_terms(Z: int, Y: int, X: int) -> int:
    """(node, offset) pairs with the neighbour inside the grid: each axis
    of n points has 3n - 2 of them."""
    return (3 * Z - 2) * (3 * Y - 2) * (3 * X - 2)


def bound(dtype: torch.dtype, nbytes: int, flops: int) -> tuple[float, str]:
    """Least time on the card: the larger of the bytes over the memory
    rate and the operations over the peak rate of their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def var_bytes(Z: int, Y: int, X: int, esize: int, masked: bool = False) -> tuple[int, int]:
    """Bytes of one K4/K5 apply on a (Z, Y, X) grid, (27-block, 14-block):
    the state in and out (and the mask) once, and the weights toward each
    neighbour inside the grid, 9 values for each (node, offset) pair
    (27-block, all stored blocks) or for each unordered pair of nodes and
    each node's centre (14-block: on a block-symmetric field the other
    blocks are their transposes)."""
    terms, n = neighbour_terms(Z, Y, X), Z * Y * X
    state = (3 if masked else 2) * 3 * n
    return (9 * terms + state) * esize, (9 * (terms + n) // 2 + state) * esize


def symmetric_random(rng, Z: int, Y: int, X: int, zero_z_ends: bool = False) -> torch.Tensor:
    """``symmetrize_field`` of a random f64 (27, 3, 3, Z, Y, X) field on the
    card (the kernels' input contract); with ``zero_z_ends`` its blocks
    toward the planes past the z ends are zero, as an assembled field's are
    (the slab kernels read those)."""
    from fea_tpu_torch.ops.curvilinear import symmetrize_field

    w = torch.as_tensor(rng.standard_normal((27, 3, 3, Z, Y, X)), device=DEV)
    if zero_z_ends:
        w[:9, :, :, 0] = 0.0
        w[18:, :, :, -1] = 0.0
    return symmetrize_field(w)


class FieldSpy:
    """While active, records every weight field handed to K4/K5 (whole,
    slab, raw or masked: ``cuda_varstencil._launch``); ``check`` then
    requires each to equal its mirror exactly. Recording costs no device
    work, so it runs inside graph captures too. It holds the fields it
    records, up to HOLD_BYTES; a launch on a field past that (a dtype cast
    made afresh for each apply would be one) goes unchecked, so ``check``
    fails if there was any."""

    HOLD_BYTES = 2e9

    def __init__(self, cuda_varstencil):
        self.mod, self.fields, self.unheld = cuda_varstencil, {}, 0

    def __enter__(self):
        self.orig = self.mod._launch

        def launch(name, entry, weights, *args):
            held = sum(w.numel() * w.element_size() for w in self.fields.values())
            if weights.data_ptr() in self.fields:
                pass
            elif held + weights.numel() * weights.element_size() <= self.HOLD_BYTES:
                self.fields[weights.data_ptr()] = weights
            else:
                self.unheld += 1
            return self.orig(name, entry, weights, *args)

        self.mod._launch = launch
        return self

    def __exit__(self, *exc):
        self.mod._launch = self.orig

    def check(self, what: str) -> None:
        from fea_tpu_torch.ops.curvilinear import mirror_defect

        defects = [mirror_defect(w) for w in self.fields.values()]
        shapes = sorted({(tuple(w.shape[3:]), str(w.dtype).replace("torch.", "")) for w in self.fields.values()})
        say(f"  {what}: {len(defects)} weight fields handed to K4/K5 {shapes}, largest mirror defect "
            f"{max(defects, default=float('nan'))}; {self.unheld} more launches on fields past what the check holds")
        require({"every field handed to K4/K5 equals its mirror exactly": bool(defects) and max(defects) == 0.0,
                 "every field handed to K4/K5 was held and checked": self.unheld == 0}, f"{what} fields")
        self.fields.clear()


def library_ms(w: torch.Tensor, g: torch.Tensor, want: torch.Tensor) -> float:
    """CUDA-event time of one cuSPARSE SpMV (torch.mv of a CSR matrix) of
    the operator of the field ``w`` on ``g``, the matrix built once
    outside the timed region; the product is first held against
    ``want`` (the plain version in f64)."""
    A = stencil_csr(w)
    x = g.reshape(-1)
    y = torch.mv(A, x).reshape(g.shape)
    rel = float((y.double() - want).abs().max() / want.abs().max())
    if not rel <= 1e-5:
        raise AssertionError(f"CSR SpMV disagrees with the plain version: rel err {rel:.3e}")
    ms = event_ms(lambda: torch.mv(A, x))
    del A
    return ms


def flagship_ke(ftt):
    from fea_tpu_torch.elements.hex8 import stiffness_matrix_np

    nx, ny, nz = FLAGSHIP
    h = np.array([0.1 / nx, 0.1 / ny, 1.0 / nz])
    corners = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                        [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]], np.float64) * h
    return stiffness_matrix_np(corners, ftt.Material(E=10_000_000 * ftt.units.psi, nu=0.3))


def flagship_level_grids() -> list[tuple[int, int, int]]:
    """The level grids of the voxel hierarchy under FLAGSHIP, as
    ``build_multigrid`` cuts them."""
    from fea_tpu_torch.ops.multigrid import coarsen_dims

    grids = [FLAGSHIP]
    while 3 * int(np.prod([s + 1 for s in grids[-1]])) > 3000 and coarsen_dims(grids[-1]) is not None:
        grids.append(coarsen_dims(grids[-1]))
    return grids


def unfused_masked(cuda_stencil, w, g, F):
    """The six launches the masked kernel replaces: the raw kernel between
    five elementwise passes."""
    return F * cuda_stencil.stencil_apply(w, F * g) + (1.0 - F) * g


def stencil_bound(dtype, g, table, masked: bool):
    """(bound ms, what sets it, bytes) of one apply on grid ``g``: g read
    once, the output written once, the region table and (masked) the mask
    read once; 2 x 9 operations for each neighbour inside the grid."""
    Z, Y, X, _ = g.shape
    nbytes = (3 if masked else 2) * g.numel() * g.element_size() + table.numel() * table.element_size()
    ms, by = bound(dtype, nbytes, 2 * 9 * neighbour_terms(Z, Y, X))
    return ms, by, nbytes


def check_kernels(ftt, cuda_stencil) -> dict:
    from fea_tpu_torch.ops.structured import stencil_apply_grid

    ke = flagship_ke(ftt)
    ke64 = torch.as_tensor(ke, device=DEV)
    weights = {k: cuda_stencil.stencil_weights(ke, KERNELS[k]["dtype"], DEV) for k in STENCIL_KEYS}
    rng = np.random.default_rng(20261016)
    report = {k: dict(max_abs_err=0.0, max_rel_err=0.0) for k in STENCIL_KEYS}
    timed = flagship_level_grids() + [CAPACITY]
    for dims in SHAPES + [CAPACITY]:
        nx, ny, nz = dims
        Z, Y, X = nz + 1, ny + 1, nx + 1
        g64 = torch.as_tensor(rng.normal(size=(Z, Y, X, 3)), device=DEV)
        masks = {"random mask": torch.as_tensor((rng.random((Z, Y, X, 3)) < 0.8).astype(np.float64), device=DEV)}
        if dims == FLAGSHIP:  # the flagship's own mask: the z = 0 plane fixed
            real = torch.ones_like(g64)
            real[0] = 0.0
            masks["the flagship's mask"] = real
        want = stencil_apply_grid(ke64, g64, dims)
        scale = float(want.abs().max())
        parts = []
        for key in STENCIL_KEYS:
            spec = KERNELS[key]
            w, g = weights[key], g64.to(spec["dtype"]).contiguous()
            got = cuda_stencil.stencil_apply(w, g)
            torch.cuda.synchronize()
            err = float((got.double() - want).abs().max())
            rel = err / scale
            worst = rel
            for label, F64 in masks.items():
                F = F64.to(spec["dtype"])
                got_m = cuda_stencil.stencil_apply(w, g, F)
                torch.cuda.synchronize()
                # against the unfused plain expression in f64, and value for value against the unfused kernel
                want_m = stencil_apply_grid(ke64, g64, dims, F64)
                rel_m = float((got_m.double() - want_m).abs().max()) / scale
                if not rel_m <= spec["tol"]:
                    raise AssertionError(f"{spec['name']} masked ({label}) at {dims}: rel err {rel_m:.3e} > "
                                         f"{spec['tol']:g}")
                if not torch.equal(got_m, unfused_masked(cuda_stencil, w, g, F)):
                    raise AssertionError(f"{spec['name']} masked ({label}) at {dims} differs from the unfused "
                                         "expression")
                worst = max(worst, rel_m)
            parts.append(f"{spec['name'].split()[0]} rel err {rel:.3e}, masked {worst:.3e} (tol {spec['tol']:g})")
            if not rel <= spec["tol"]:
                raise AssertionError(f"{spec['name']} at {dims}: rel err {rel:.3e} > {spec['tol']:g}")
            report[key]["max_abs_err"] = max(report[key]["max_abs_err"], err)
            report[key]["max_rel_err"] = max(report[key]["max_rel_err"], worst)
        say(f"  {dims}: " + "; ".join(parts) + "; masked == the unfused expression value for value")
        if dims in timed:
            for key in STENCIL_KEYS:
                spec = KERNELS[key]
                g = g64.to(spec["dtype"]).contiguous()
                F = masks["random mask"].to(spec["dtype"])
                w = weights[key]
                ms = event_ms(lambda: cuda_stencil.stencil_apply(w, g), runs=10)
                masked_ms = event_ms(lambda: cuda_stencil.stencil_apply(w, g, F), runs=10)
                unfused_ms = event_ms(lambda: unfused_masked(cuda_stencil, w, g, F), runs=10)
                dev_ms = graph_ms(lambda: cuda_stencil.stencil_apply(w, g))
                dev_masked_ms = graph_ms(lambda: cuda_stencil.stencil_apply(w, g, F))
                dev_unfused_ms = graph_ms(lambda: unfused_masked(cuda_stencil, w, g, F))
                bound_ms, bound_by, nbytes = stencil_bound(spec["dtype"], g, w.table, False)
                mbound_ms, mbound_by, _ = stencil_bound(spec["dtype"], g, w.table, True)
                line = (f"  {spec['name']} {dims} ({3 * Z * Y * X} DOF): kernel {ms:.4f} ms at the host's pace, "
                        f"{dev_ms:.4f} ms on the card (graph replay), bound {bound_ms:.4f} ms ({bound_by}); masked "
                        f"{masked_ms:.4f} / {dev_masked_ms:.4f} ms, bound {mbound_ms:.4f} ms ({mbound_by}), the "
                        f"unfused six launches {unfused_ms:.4f} / {dev_unfused_ms:.4f} ms")
                times = dict(ms=ms, device_ms=dev_ms, bound_ms=bound_ms, bound_by=bound_by, masked_ms=masked_ms,
                             masked_device_ms=dev_masked_ms, masked_bound_ms=mbound_ms, unfused_ms=unfused_ms,
                             unfused_device_ms=dev_unfused_ms)
                if dims == FLAGSHIP:
                    plain_ms = event_ms(lambda: stencil_apply_grid(w.ke, g, dims))
                    lib_ms = library_ms(region_field(w.table, Z, Y, X), g, want)
                    gbs = nbytes / (ms * 1e-3) / 1e9
                    line += f"; {gbs:.1f} GB/s, plain version {plain_ms:.4f} ms, CSR SpMV {lib_ms:.4f} ms"
                    report[key].update(times, plain_ms=plain_ms, library_ms=lib_ms, gb_per_s=gbs)
                else:
                    tag = "capacity" if dims == CAPACITY else "x".join(map(str, dims))
                    report[key].update({f"{tag}_{n}": v for n, v in times.items() if n != "bound_by"})
                say(line)
        del g64, masks, want
    # what one wrapper call costs the host: calls issued without a synchronise, on the 9x9x81 level
    g = torch.as_tensor(rng.normal(size=(81, 9, 9, 3)), device=DEV)
    for key in STENCIL_KEYS:
        w, gk = weights[key], g.to(KERNELS[key]["dtype"])
        F = torch.ones_like(gk)
        for label, fn in (("raw", lambda: cuda_stencil.stencil_apply(w, gk)),
                          ("masked", lambda: cuda_stencil.stencil_apply(w, gk, F))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(1000):
                fn()
            host_us = (time.perf_counter() - t0) * 1e3
            torch.cuda.synchronize()
            total_us = (time.perf_counter() - t0) * 1e3
            say(f"  host cost of one stencil_apply call ({KERNELS[key]['name'].split()[0]} {label}, 9x9x81 nodes): "
                f"{host_us:.2f} us issued unsynchronised over 1,000 calls; {total_us:.2f} us a call with the final "
                f"synchronise")
            report[key][f"host_us_{label}"] = host_us
    return report


def curv_level_grids() -> list[tuple[int, int, int]]:
    """The level grids of the curvilinear hierarchy over CURV."""
    from fea_tpu_torch.ops.curvilinear import _MAX_COARSE_DOF, coarsen_dims_partial

    grids = [CURV]
    while 3 * int(np.prod([s + 1 for s in grids[-1]])) > _MAX_COARSE_DOF:
        grids.append(coarsen_dims_partial(grids[-1])[0])
    return grids


def var_cases(ftt, rng):
    """(label, f64 field, f64 state, 0/1 mask) of phase [5]: symmetrized
    random fields and states at VAR_SMALL and every level grid of the
    CURV hierarchy (the fine one first), then the real fields of that
    hierarchy (the f64 operator and every level, as built) with their free
    masks."""
    from fea_tpu_torch.ops.curvilinear import mirror_defect

    for dims in VAR_SMALL + curv_level_grids():
        nx, ny, nz = dims
        Z, Y, X = nz + 1, ny + 1, nx + 1
        w = symmetric_random(rng, Z, Y, X)
        g = torch.as_tensor(rng.standard_normal((Z, Y, X, 3)), device=DEV)
        F = torch.as_tensor((rng.random((Z, Y, X, 3)) < 0.8).astype(np.float64), device=DEV)
        yield f"random {dims}", w, g, F
        del w, g, F
    op, mg = ftt.build_curvilinear(scenes.distorted(CURV, device=DEV)[0])
    Z, Y, X = op.grid_shape
    real = [(f"operator {CURV} f64", op.w, op.free.reshape(Z, Y, X, 3))]
    real += [(f"level {i} {lv.dims} {str(lv.dtype).replace('torch.', '')}", lv.w, lv.free)
             for i, lv in enumerate(mg.levels)]
    del op, mg
    for label, w, F in real:
        if mirror_defect(w) != 0.0:
            raise AssertionError(f"the real field {label} is not exactly block-symmetric")
        g = torch.as_tensor(rng.standard_normal(tuple(F.shape)), device=DEV)
        yield f"real {label}", w.double(), g, F.double()


def check_var_kernels(ftt, cuda_varstencil) -> dict:
    """Phase [5]: K4/K5, raw and masked, against their plain version in f64
    on symmetrized random fields and on the real fields of the 811,923-DOF
    hierarchy (``var_cases``): raw within 2e-5 / 1e-12 of max|K u|, masked
    within that of the masked expression's max and value for value the
    unfused expression around the raw kernel. At the fine grid: card ms
    (graph replays) and host pace raw and masked, the plain version, a CSR
    SpMV, the 27- and 14-block bounds and GB/s on the 14-block bytes."""
    from fea_tpu_torch.ops.curvilinear import curv_apply_grid

    rng = np.random.default_rng(20261017)
    report = {k: dict(max_abs_err=0.0, max_rel_err=0.0) for k in VAR_KEYS}
    for label, w64, g64, F64 in var_cases(ftt, rng):
        Z, Y, X = w64.shape[3:]
        want = curv_apply_grid(w64, g64)
        want_m = F64 * curv_apply_grid(w64, F64 * g64) + (1.0 - F64) * g64
        scale, scale_m = float(want.abs().max()), float(want_m.abs().max())
        for key in VAR_KEYS:
            spec = KERNELS[key]
            w = w64.to(spec["dtype"]).contiguous()
            g = g64.to(spec["dtype"]).contiguous()
            F = F64.to(spec["dtype"]).contiguous()
            got = cuda_varstencil.var_apply(w, g)
            got_m = cuda_varstencil.var_apply_masked(w, F, g)
            same = bool(torch.equal(got_m, F * cuda_varstencil.var_apply(w, F * g) + (1.0 - F) * g))
            torch.cuda.synchronize()
            err = float((got.double() - want).abs().max())
            rel, rel_m = err / scale, float((got_m.double() - want_m).abs().max()) / scale_m
            say(f"  {spec['name']} {label}: max abs err {err:.3e}, rel {rel:.3e}; masked rel {rel_m:.3e} (tol "
                f"{spec['tol']:g}), value for value the unfused expression: {same}")
            require({f"{spec['name']} within {spec['tol']:g}": rel <= spec["tol"],
                     f"{spec['name']} masked within {spec['tol']:g}": rel_m <= spec["tol"],
                     f"{spec['name']} masked = F K(F g) + (1 - F) g value for value": same}, f"[5] {label}")
            report[key]["max_abs_err"] = max(report[key]["max_abs_err"], err)
            report[key]["max_rel_err"] = max(report[key]["max_rel_err"], rel, rel_m)
            if label == f"random {CURV}":
                # ms, bound_ms and gb_per_s keep the meaning they have on every
                # row (host pace; all 27 blocks); the card's time and the
                # 14-block bound of a block-symmetric field stand beside them
                ms = event_ms(lambda: cuda_varstencil.var_apply(w, g))
                dev_ms = graph_ms(lambda: cuda_varstencil.var_apply(w, g))
                dev_masked_ms = graph_ms(lambda: cuda_varstencil.var_apply_masked(w, F, g))
                dev_unfused_ms = graph_ms(lambda: F * cuda_varstencil.var_apply(w, F * g) + (1.0 - F) * g)
                plain_ms = event_ms(lambda: curv_apply_grid(w, g))
                lib_ms = library_ms(w, g, want)
                b27, b14 = var_bytes(Z, Y, X, g.element_size())
                flops = 2 * 9 * neighbour_terms(Z, Y, X)
                bound_ms, bound_by = bound(spec["dtype"], b27, flops)
                bound14, _ = bound(spec["dtype"], b14, flops)
                bound14_m, _ = bound(spec["dtype"], var_bytes(Z, Y, X, g.element_size(), masked=True)[1], flops)
                gbs, gbs14 = b27 / (ms * 1e-3) / 1e9, b14 / (dev_ms * 1e-3) / 1e9
                say(f"  {spec['name']} {CURV} ({3 * Z * Y * X} DOF): host pace {ms:.4f} ms, card {dev_ms:.4f} ms "
                    f"({gbs14:.1f} GB/s on the 14-block bytes, {bound14 / dev_ms * 100:.0f}% of the 14-block bound); "
                    f"masked card {dev_masked_ms:.4f} ms (the unfused expression {dev_unfused_ms:.4f} ms); plain "
                    f"version {plain_ms:.4f} ms, CSR SpMV {lib_ms:.4f} ms; bound {bound_ms:.4f} ms on 27 blocks "
                    f"({bound_by}), {bound14:.4f} ms on 14 (masked {bound14_m:.4f})")
                report[key].update(ms=ms, device_ms=dev_ms, masked_device_ms=dev_masked_ms,
                                   unfused_device_ms=dev_unfused_ms, plain_ms=plain_ms, library_ms=lib_ms,
                                   bound_ms=bound_ms, bound_by=bound_by, bound_14_ms=bound14,
                                   masked_bound_14_ms=bound14_m, gb_per_s=gbs, gb_per_s_14=gbs14)
            del w, g, F, got, got_m
        del want, want_m
    return report


def var_summary(report: dict, launches: dict) -> None:
    """K4, K5, K4-slab and K5-slab side by side at the 811,923-DOF grid
    (the slab rows one apply over SHARDS slabs): host pace, card ms, the
    masked form, CSR, both bounds, GB/s and share of the 14-block bound,
    launches a solve ([6] for K4/K5, [18.5] for the slab forms)."""
    say("  K4/K5 at the 811,923-DOF grid (card: graph replays; bounds at 3.35 TB/s; launches in one solve):")
    for key in VAR_KEYS + VAR_SLAB_KEYS:
        r = report[key]
        lib = "not built" if r.get("library_ms") is None else f"{r['library_ms']:.4f}"
        say(f"    {KERNELS[key]['name']}: host pace {r['ms']:.4f} ms, card {r['device_ms']:.4f} ms, masked card "
            f"{r['masked_device_ms']:.4f} ms, CSR {lib} ms, bound {r['bound_ms']:.4f} ms (27 blocks) / "
            f"{r['bound_14_ms']:.4f} ms (14 blocks), {r['gb_per_s_14']:.1f} GB/s on the card, "
            f"{r['bound_14_ms'] / r['device_ms'] * 100:.0f}% of the 14-block bound, {launches[key]} launches a solve")


def flagship_scene(dims=None):
    """bench.py's cantilever at ``dims`` voxels (the flagship when None) on
    the card (``scenes.cantilever``): the scene and (nodes, elements,
    fixed, loads, tip, tip_exact)."""
    scene, h = scenes.cantilever(dims or FLAGSHIP, device=DEV)
    return scene, tuple(h[k] for k in ("nodes", "elements", "fixed", "loads", "tip", "tip_exact"))


def kept_gb(before: int, sol) -> float:
    """GB of device memory allocated since ``before`` that a solve left
    behind, its own result aside."""
    result = sum(t.numel() * t.element_size() for t in (sol.displacements, sol.reactions))
    return (torch.cuda.memory_allocated() - before - result) / 1e9


def zero_counts(*counters) -> None:
    for c in counters:
        for key in c:
            c[key] = 0


def freeze_checks(op, mg, loads, presc) -> None:
    """The staged loop's freezing on the card, on one captured graph: a
    zero rhs takes 0 iterations and returns u == 0; tol 1e-30 with
    max_iters 5 takes exactly 5 iterations and does not converge; after
    those two passes have left the static buffers in other states, two
    solves give the same iterations and displacements bit for bit (every
    pass restarts the whole state)."""
    from fea_tpu_torch.solve import solve_operator_fpcg_staged

    first = solve_operator_fpcg_staged(op, loads, presc, mg, tol=1e-8)
    zero = solve_operator_fpcg_staged(op, torch.zeros_like(loads), presc, mg, tol=1e-8)
    five = solve_operator_fpcg_staged(op, loads, presc, mg, tol=1e-30, max_iters=5)
    again = solve_operator_fpcg_staged(op, loads, presc, mg, tol=1e-8)
    same = first.stats.iterations == again.stats.iterations and bool(torch.equal(first.displacements,
                                                                                  again.displacements))
    say(f"  freeze checks: zero rhs {zero.stats.iterations} iterations, max|u| "
        f"{float(zero.displacements.abs().max()):g}; tol 1e-30 max_iters 5: {five.stats.iterations} iterations, "
        f"converged {five.stats.converged}; a solve before and after them: {first.stats.iterations} / "
        f"{again.stats.iterations} iterations, bit for bit {same}")
    require({
        "zero rhs: 0 iterations": zero.stats.iterations == 0 and zero.stats.converged,
        "zero rhs: u == 0": float(zero.displacements.abs().max()) == 0.0,
        "max_iters 5: exactly 5 iterations, not converged": five.stats.iterations == 5 and not five.stats.converged,
        "a solve replaying the graph again: bit for bit": same,
    }, "freeze")


def run_slice(ftt, cuda_stencil, cuda_varstencil) -> tuple[dict, dict]:
    from fea_tpu_torch.ops.multigrid import build_multigrid
    from fea_tpu_torch.ops.structured import build_structured_operator, stencil_apply_np
    from fea_tpu_torch.solve import solve_operator_fpcg_staged

    scene, (nodes, elements, fixed, loads, tip, tip_exact) = flagship_scene()
    say(f"  scene: {FLAGSHIP} voxels, {scene.n_dof} DOF on {scene.device}")

    zero_counts(cuda_stencil.LAUNCHES, cuda_varstencil.LAUNCHES)
    t0 = time.perf_counter()
    sol = ftt.solve(scene, tol=1e-8)
    torch.cuda.synchronize()
    whole_s = time.perf_counter() - t0
    launches = {**cuda_stencil.LAUNCHES, **cuda_varstencil.LAUNCHES}

    st = sol.stats
    say(f"  whole solve (fea_tpu_torch.solve): {whole_s:.3f} s")
    say(f"  iterations {st.iterations}, reported true relative residual "
        f"{st.relative_residual:.3e}, converged {st.converged}")
    say(f"  launches in that solve: K1 {launches['f32']}, K2 {launches['f64']}, "
        f"K4 {launches['var_f32']}, K5 {launches['var_f64']}")

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
    sol2 = solve_operator_fpcg_staged(op_hi, scene.loads, scene.prescribed_or_zero(torch.float64), mg, tol=1e-8)
    torch.cuda.synchronize()
    stage["solve (staged, capture included)"] = time.perf_counter() - t0
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
    require(checks, "slice")

    def host_rel(v):
        Kv = stencil_apply_np(ke, v.reshape(Z, Y, X, 3), dims).reshape(-1, 3)
        return float(np.linalg.norm(F * (loads - Kv)) / np.linalg.norm(F * loads))

    say("  FCG stage with certification, the Python loop beside the staged loop (one operator and hierarchy):")
    loop_vs_staged(op_hi, mg, scene.loads, scene.prescribed_or_zero(torch.float64), host_rel)
    freeze_checks(op_hi, mg, scene.loads, scene.prescribed_or_zero(torch.float64))
    return launches, dict(scene=scene, op_hi=op_hi, mg=mg, u=u, iterations=st.iterations, tip=tip,
                          tip_exact=tip_exact, dims=dims, ke=ke)


# the runtime calls by which the host puts work on the card
LAUNCH_CALLS = {"cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx", "cudaGraphLaunch",
                "cudaMemcpyAsync", "cudaMemsetAsync"}


def profile_fcg(solve_fn) -> dict:
    """torch.profiler over one call of ``solve_fn``: device time, the
    number of device activities (kernels and copies) and the host's launch
    calls (``LAUNCH_CALLS``; a graph launch is one)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sol = solve_fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.events()
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    by_name: dict[str, float] = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    host_launches = sum(1 for e in events if e.device_type == DeviceType.CPU and e.name in LAUNCH_CALLS)
    return dict(sol=sol, wall_s=wall, device_ms=sum(by_name.values()), n_device=len(dev),
                host_launches=host_launches, top=sorted(by_name.items(), key=lambda kv: -kv[1])[:6])


def loop_vs_staged(op, mg, loads, presc, host_rel, tol: float = 1e-8, check_tol: float = 1e-8) -> dict:
    """The FCG stage with certification on one operator and hierarchy, by
    the Python loop (``solve_operator_fpcg``) and by the staged loop
    (``solve_operator_fpcg_staged``, which the routes of ``solve()`` run),
    side by side: iterations, the true residual recomputed on the host by
    ``host_rel(u)``, the displacements' difference, walls (the staged one
    once with its capture, once warm), and a profiled run of each (device
    ms, activities and host launch calls an iteration, busy share of the
    unprofiled warm wall). The staged loop's first run captures its
    graph afresh. Fails unless the two agree within 1 iteration
    and 10 tol, both meet ``check_tol`` on the host, and no pass ran more
    than 2 iterations past convergence."""
    from fea_tpu_torch.solve import solve_operator_fpcg, solve_operator_fpcg_staged, staged

    fresh = copy.copy(mg)  # the same levels in a hierarchy with no plan: the staged loop's first run captures
    fns = {"loop": lambda: solve_operator_fpcg(op, loads, presc, mg, tol=tol),
           "staged": lambda: solve_operator_fpcg_staged(op, loads, presc, fresh, tol=tol)}
    runs = {}
    for name, fn in fns.items():
        run = {}
        zero_counts(staged.COUNTS)
        for key in ("first", "warm"):
            t0 = time.perf_counter()
            run["sol"] = fn()
            torch.cuda.synchronize()
            run[key] = time.perf_counter() - t0
        run["counts"] = dict(staged.COUNTS)
        run["prof"] = profile_fcg(fn)
        run["rel"] = host_rel(run["sol"].displacements.cpu().numpy())
        runs[name] = run
    for name, run in runs.items():
        st, prof, c = run["sol"].stats, run["prof"], run["counts"]
        it = max(st.iterations, 1)
        line = (f"    {name:6s}: {st.iterations} iterations, host true residual {run['rel']:.3e}, wall "
                f"{run['first']:.4f} s first, {run['warm']:.4f} s warm; profiled: device {prof['device_ms']:.2f} ms in "
                f"{prof['n_device']} activities ({prof['n_device'] / it:.1f} an iteration), host launch calls "
                f"{prof['host_launches'] / it:.1f} an iteration, busy share {prof['device_ms'] / 1e3 / run['warm']:.3f} "
                f"of the warm wall")
        if name == "staged":
            line += (f"; replays {c['steps']} for {c['live']} iterations in 2 solves, at most {c['past']} past "
                     f"convergence a pass, captures {c['captures']} in {c['capture_ms']:.1f} ms")
        say(line)
    u_loop = runs["loop"]["sol"].displacements
    du = float((runs["staged"]["sol"].displacements - u_loop).abs().max() / u_loop.abs().max())
    say(f"    max|u_staged - u_loop| / max|u| = {du:.3e}")
    require({
        "iterations within 1": abs(runs["staged"]["sol"].stats.iterations - runs["loop"]["sol"].stats.iterations) <= 1,
        f"both host true residuals <= {check_tol:g}": max(runs["loop"]["rel"], runs["staged"]["rel"]) <= check_tol,
        "displacements within 10 tol": du <= 10 * tol,
        "<= 2 iterations past convergence a pass": runs["staged"]["counts"]["past"] <= 2,
    }, "staged vs loop")
    return runs


def time_detectors(scene, renumbered: bool = False) -> list[str]:
    """Host times of the detectors that solve() runs before the route of
    ``scene`` (and, for a renumbered scene, the canonicalization), on a
    copy of the scene whose host mesh is not yet pulled."""
    from fea_tpu_torch.ops.canonical import canonicalize_scene, infer_renumbered_grid
    from fea_tpu_torch.ops.curvilinear import infer_topo_dims
    from fea_tpu_torch.ops.extruded import infer_extruded
    from fea_tpu_torch.ops.structured import infer_box_dims

    fresh = dataclasses.replace(scene)
    steps = [(fn.__name__, fn) for fn in (infer_box_dims, infer_extruded, infer_topo_dims)]
    if renumbered:
        steps += [
            ("infer_renumbered_grid", infer_renumbered_grid),
            ("canonicalize_scene", lambda s: canonicalize_scene(s, *found)),
        ]
    parts = []
    for name, fn in steps:
        t0 = time.perf_counter()
        found = fn(fresh)
        parts.append(f"{name} {time.perf_counter() - t0:.4f} s")
    return parts


def run_curvilinear(ftt, cuda_stencil, cuda_varstencil) -> dict:
    from fea_tpu_torch.ops.curvilinear import infer_topo_dims

    scene, h = scenes.distorted(CURV, device=DEV)
    nodes, elements, fixed, loads, tip, mat = (h[k] for k in ("nodes", "elements", "fixed", "loads", "tip", "mat"))
    if scene.device.type != DEV or infer_topo_dims(scene) != CURV:
        raise AssertionError(f"scene on {scene.device}, topology {infer_topo_dims(scene)}")
    say(f"  scene: {CURV} distorted grid, {scene.n_dof} DOF on {scene.device}")

    # the first solve's set-up, in parts: the detectors, and the first
    # batched torch.linalg call on the card
    parts = time_detectors(scene)
    t0 = time.perf_counter()
    J = torch.eye(3, dtype=torch.float64, device=DEV).repeat(8, 1, 1)
    torch.linalg.det(J)
    torch.linalg.solve(J, J)
    torch.cuda.synchronize()
    parts.append(f"first torch.linalg det + solve {time.perf_counter() - t0:.4f} s")
    say("  set-up before the first solve: " + ", ".join(parts))

    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    zero_counts(cuda_stencil.LAUNCHES, cuda_varstencil.LAUNCHES)
    with FieldSpy(cuda_varstencil) as fields:
        t0 = time.perf_counter()
        sol = ftt.solve(scene, tol=1e-8)
        torch.cuda.synchronize()
        whole_s = time.perf_counter() - t0
    launches = {**cuda_stencil.LAUNCHES, **cuda_varstencil.LAUNCHES}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    st = sol.stats
    say(f"  whole solve (fea_tpu_torch.solve): {whole_s:.3f} s, peak device memory {peak_gb:.3f} GB; "
        f"{kept_gb(before, sol):.3f} GB kept by the build cache once it returned (operator, hierarchy, "
        f"captured graph)")
    say(f"  iterations {st.iterations}, reported true relative residual "
        f"{st.relative_residual:.3e}, converged {st.converged}")
    say(f"  launches in that solve: K1 {launches['f32']}, K2 {launches['f64']}, "
        f"K4 {launches['var_f32']}, K5 {launches['var_f64']}")

    # stage breakdown: a second solve, stage by stage
    t0 = time.perf_counter()
    op, mg = ftt.build_curvilinear(scene)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    sol2 = ftt.solve_curvilinear(scene, CURV, tol=1e-8, prebuilt=(op, mg))
    torch.cuda.synchronize()
    t_fcg = time.perf_counter() - t0
    say(f"  stages (second solve): operator + multigrid build {t_build:.3f} s, FCG with "
        f"certification {t_fcg:.3f} s; {sol2.stats.iterations} iterations, levels "
        + ", ".join(f"{lv.dims}:{str(lv.dtype).replace('torch.', '')}" for lv in mg.levels))
    t0 = time.perf_counter()
    from fea_tpu_torch.ops.curvilinear import build_curv_operator

    build_curv_operator(scene, CURV)
    torch.cuda.synchronize()
    say(f"  of which operator build {time.perf_counter() - t0:.3f} s")

    say("  FCG stage with certification, the Python loop beside the staged loop (one operator and hierarchy):")
    loop_vs_staged(op, mg, scene.loads, scene.prescribed_or_zero(torch.float64),
                   lambda v: host_check(nodes, elements, mat, fixed, loads, v)[1])
    del op, mg

    u = sol.displacements.cpu().numpy()
    if u.shape != nodes.shape or not np.all(np.isfinite(u)):
        raise AssertionError(f"displacements: shape {u.shape}, finite {np.all(np.isfinite(u))}")
    t0 = time.perf_counter()
    Ku, rel_host = host_check(nodes, elements, mat, fixed, loads, u)
    reac_err = float(np.abs(sol.reactions.cpu().numpy() - Ku).max() / np.abs(Ku).max())
    I = 0.1 * 0.1**3 / 12.0
    tip_ratio = float(u[tip, 1].mean()) / (1.0 * 1.0**3 / (3 * mat.E * I))
    say(f"  host f64 true relative residual {rel_host:.3e} (host element-by-element K u "
        f"{time.perf_counter() - t0:.1f} s); reactions vs host K u {reac_err:.3e}")
    say(f"  tip ratio u_tip,y / (P L^3 / 3 E I) = {tip_ratio:.5f}")
    checks = {
        "converged": st.converged,
        f"iterations <= {CURV_MAX_ITERS}": st.iterations <= CURV_MAX_ITERS,
        f"iterations within 1 of {CURV_ITERS}": abs(st.iterations - CURV_ITERS) <= 1,
        "host true residual <= 1e-8": rel_host <= 1e-8,
        "reactions = K u (1e-10)": reac_err <= 1e-10,
        f"tip ratio in {TIP_BAND}": TIP_BAND[0] < tip_ratio < TIP_BAND[1],
        "K4 launched": launches["var_f32"] > 0,
        "K5 launched": launches["var_f64"] > 0,
        "K1/K2 not launched": launches["f32"] == 0 and launches["f64"] == 0,
    }
    require(checks, "curvilinear")
    fields.check("[6] the curvilinear solve")
    new_loads = np.zeros_like(loads)
    new_loads[tip, 0] = -2.0 / tip.sum()
    new_loads[tip, 2] = 0.5 / tip.sum()
    cached_second_solve(ftt, scene, new_loads, whole_s,
                        lambda v: host_check(nodes, elements, mat, fixed, new_loads, v)[1])
    return launches, dict(scene=scene, nodes=nodes, elements=elements, fixed=fixed, loads=loads, mat=mat, u=u,
                          iterations=st.iterations)


def cached_second_solve(ftt, scene, new_loads, first_wall: float, host_rel, check_tol: float = 1e-8) -> None:
    """A second ``solve(tol=1e-8)`` of ``scene``'s mesh with ``new_loads``:
    it must take its build from the cache (no call of ``build_curvilinear``,
    ``canonicalize_scene``, ``build_subgrid_embedded`` or ``build_extruded``)
    and pass the host check ``host_rel(u) <= check_tol``."""
    curv = sys.modules["fea_tpu_torch.solve.curv"]
    canonical = sys.modules["fea_tpu_torch.ops.canonical"]
    embed = sys.modules["fea_tpu_torch.solve.embed"]
    extruded = sys.modules["fea_tpu_torch.solve.extruded"]
    build_fns = {"build_curvilinear": curv, "canonicalize_scene": canonical, "build_subgrid_embedded": embed,
                 "build_extruded": extruded}
    calls = []
    with patched({(mod, name): spy(calls, name, getattr(mod, name)) for name, mod in build_fns.items()}):
        second = dataclasses.replace(scene, loads=torch.as_tensor(new_loads, dtype=scene.loads.dtype, device=DEV))
        sol, wall = timed(lambda: ftt.solve(second, tol=1e-8))
    rel = host_rel(sol.displacements.cpu().numpy())
    say(f"  second solve() of the mesh with new loads: {wall:.3f} s (the first {first_wall:.3f} s), build functions called "
        f"{calls or 'none'}; {sol.stats.iterations} iterations, host f64 true relative residual {rel:.3e}")
    require({"cache hit (no build call)": not calls, "converged": sol.stats.converged,
             f"host true residual <= {check_tol:g}": rel <= check_tol}, "cached second solve")


def run_canonical(ftt, cuda_stencil, cuda_varstencil) -> None:
    scene, h = scenes.renumbered(CANON, device=DEV)
    # the original mesh; its node k is node pi[k] of the renumbered scene
    nodes, elements, pi = h["orig_nodes"], h["orig_elements"], h["pi"]
    nodes_r, fixed_r, loads_r, mat = h["nodes"], h["fixed"], h["loads"], h["mat"]
    say(f"  scene: {CANON} distorted grid renumbered, {scene.n_dof} DOF on {scene.device}")
    say("  set-up before the solve: " + ", ".join(time_detectors(scene, renumbered=True)))
    zero_counts(cuda_stencil.LAUNCHES, cuda_varstencil.LAUNCHES)
    before = torch.cuda.memory_allocated()
    with FieldSpy(cuda_varstencil) as fields:
        t0 = time.perf_counter()
        sol = ftt.solve(scene, tol=1e-8)
        torch.cuda.synchronize()
        whole_s = time.perf_counter() - t0
    launches = {**cuda_stencil.LAUNCHES, **cuda_varstencil.LAUNCHES}
    st = sol.stats
    say(f"  whole solve (fea_tpu_torch.solve, canonicalization included): {whole_s:.3f} s; "
        f"{st.iterations} iterations, reported {st.relative_residual:.3e}, converged {st.converged}; "
        f"{kept_gb(before, sol):.3f} GB kept by the build cache once it returned (canonical scene, operator, "
        f"hierarchy, captured graph)")
    say(f"  launches: K1 {launches['f32']}, K2 {launches['f64']}, "
        f"K4 {launches['var_f32']}, K5 {launches['var_f64']}")

    # stage breakdown: a second solve of the canonical scene, stage by stage
    from fea_tpu_torch.ops.canonical import canonicalize_scene, infer_renumbered_grid
    from fea_tpu_torch.ops.curvilinear import build_curv_multigrid, build_curv_operator

    cdims, perm = infer_renumbered_grid(scene)
    canon = canonicalize_scene(scene, cdims, perm)
    stage = {}
    t0 = time.perf_counter()
    op = build_curv_operator(canon, CANON)
    torch.cuda.synchronize()
    stage["operator build"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    mg = build_curv_multigrid(op.w, CANON, 1.0 - canon.fixed.cpu().numpy().astype(np.float64))
    torch.cuda.synchronize()
    stage["multigrid build"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ftt.solve_curvilinear(canon, CANON, tol=1e-8, prebuilt=(op, mg))
    torch.cuda.synchronize()
    stage["FCG with certification"] = time.perf_counter() - t0
    n = mg.coarse_inv.shape[0]
    t0 = time.perf_counter()
    np.linalg.inv(np.random.default_rng(0).standard_normal((n, n)) + n * np.eye(n))
    # what the multigrid build's dense coarsest inverse costs on the host
    stage[f"np.linalg.inv of a random {n}x{n} matrix"] = time.perf_counter() - t0
    say("  stages (second solve): " + ", ".join(f"{k} {v:.3f} s" for k, v in stage.items()))
    say("  FCG stage with certification, the Python loop beside the staged loop (one operator and hierarchy):")
    loop_vs_staged(op, mg, canon.loads, canon.prescribed_or_zero(torch.float64),
                   lambda v: host_check(nodes, elements, mat, fixed_r[pi], loads_r[pi], v[perm][pi])[1],
                   check_tol=CANON_TOL)
    del op, mg, canon

    u = sol.displacements.cpu().numpy()[pi]  # back to the original numbering
    _, rel_host = host_check(nodes, elements, mat, fixed_r[pi], loads_r[pi], u)
    say(f"  host f64 true relative residual of the original system {rel_host:.3e}")
    checks = {
        "converged": st.converged,
        f"iterations within 1 of {CANON_ITERS}": abs(st.iterations - CANON_ITERS) <= 1,
        f"host true residual <= {CANON_TOL:g}": rel_host <= CANON_TOL,
        "K4 launched": launches["var_f32"] > 0,
        "K5 launched": launches["var_f64"] > 0,
    }
    require(checks, "canonicalized")
    fields.check("[7] the canonicalized solve")
    new_loads_r = np.zeros_like(loads_r)
    tip_r = np.isclose(nodes_r[:, 2], 1.0)
    new_loads_r[tip_r, 0] = 1.5 / tip_r.sum()
    cached_second_solve(ftt, scene, new_loads_r, whole_s,
                        lambda v: host_check(nodes, elements, mat, fixed_r[pi], new_loads_r[pi], v[pi])[1],
                        check_tol=CANON_TOL)


def apply_bound(key: str, E: int, k: int) -> tuple[float, str, int]:
    """K6/K7's bound (ms, what sets it) and the bytes it counts: each input
    read once and the output written once (K6: the (E, k, k) batch, u and
    out; K7: u, out and the one Ke), 2 E k^2 operations."""
    dtype = KERNELS[key]["dtype"]
    size = torch.empty((), dtype=dtype).element_size()
    values = E * k * k + 2 * E * k if key.startswith("stored") else 2 * E * k + k * k
    ms, by = bound(dtype, values * size, 2 * E * k * k)
    return ms, by, values * size


def check_apply_kernels(cuda_apply) -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False  # the library calls in full f32
    fns = {
        "stored": (cuda_apply.batched_matvec_stored, cuda_apply.batched_matvec_stored_plain,
                   lambda ke, u: torch.bmm(ke, u[..., None])[..., 0], "torch.bmm"),
        "uniform": (cuda_apply.batched_matvec_uniform, cuda_apply.batched_matvec_uniform_plain,
                    lambda ke, u: torch.matmul(u, ke.T), "torch.matmul"),
    }
    rng = np.random.default_rng(20261018)
    report = {k: dict(max_abs_err=0.0, max_rel_err=0.0) for k in APPLY_KEYS}
    for E, k in APPLY_SMALL + APPLY_PATH + [APPLY_FULL]:
        u64 = torch.as_tensor(rng.standard_normal((E, k)), device=DEV)
        for kind, (kernel, plain, library, lib_name) in fns.items():
            ke64 = torch.as_tensor(rng.standard_normal((E, k, k) if kind == "stored" else (k, k)), device=DEV)
            want = plain(ke64, u64)
            scale = float(want.abs().max())
            for key in (f"{kind}_f32", f"{kind}_f64"):
                spec = KERNELS[key]
                ke, u = ke64.to(spec["dtype"]), u64.to(spec["dtype"])
                got = kernel(ke, u)
                torch.cuda.synchronize()
                err = float((got.double() - want).abs().max())
                rel = err / scale
                if (E, k) in APPLY_PATH + [APPLY_FULL]:
                    say(f"  {spec['name']} E={E} k={k}: max abs err {err:.3e}, rel {rel:.3e} (tol {spec['tol']:g})")
                if not rel <= spec["tol"]:
                    raise AssertionError(f"{spec['name']} at E={E}, k={k}: rel err {rel:.3e} > {spec['tol']:g}")
                report[key]["max_abs_err"] = max(report[key]["max_abs_err"], err)
                report[key]["max_rel_err"] = max(report[key]["max_rel_err"], rel)
                if (E, k) in APPLY_TIMED:
                    lib_rel = float((library(ke, u).double() - want).abs().max()) / scale
                    if not lib_rel <= 1e-5:
                        raise AssertionError(f"{lib_name} disagrees with the plain version: rel err {lib_rel:.3e}")
                    ms = event_ms(lambda: kernel(ke, u))
                    plain_ms = event_ms(lambda: plain(ke, u))
                    lib_ms = event_ms(lambda: library(ke, u))
                    dev_ms = graph_ms(lambda: kernel(ke, u))
                    dev_lib_ms = graph_ms(lambda: library(ke, u))
                    bound_ms, bound_by, nbytes = apply_bound(key, E, k)
                    gbs = nbytes / (ms * 1e-3) / 1e9
                    say(f"  {spec['name']} E={E} k={k}: kernel {ms:.4f} ms ({gbs:.1f} GB/s), plain version "
                        f"{plain_ms:.4f} ms, {lib_name} {lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); on the "
                        f"card (graph replay) kernel {dev_ms:.4f} ms, {lib_name} {dev_lib_ms:.4f} ms")
                    times = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by,
                                 gb_per_s=gbs, device_ms=dev_ms, library_device_ms=dev_lib_ms)
                    if (E, k) == APPLY_FULL:
                        report[key].update(times)
                    else:  # the same at the size phase [9.2] runs, under path_*
                        report[key].update(path_E=E, **{f"path_{n}": v for n, v in times.items()})
                del ke, u, got
            del ke64, want
    say("  every shape: " + ", ".join(f"{KERNELS[k]['name'].split()[0]} {k[-3:]} rel err <= "
                                      f"{report[k]['max_rel_err']:.2e}" for k in APPLY_KEYS))
    return report


def counted(counters, fn):
    """``fn()`` with every launch count set to 0 just before it, and the
    counts read just after: (result, counts, wall seconds)."""
    zero_counts(*counters)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {}
    for c in counters:
        counts.update(c)
    return out, counts, wall


def require(checks: dict, what: str) -> None:
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"{what} checks failed: {failed}")


def cubebeam_arrays(ftt):
    """The reference cubebeam demo (tests/test_integration.py:15-33): a
    0.1 x 0.1 x 1.0 cantilever of 4x4x49 hex8, E = 10e6 psi, nu = 0.3,
    100 lbf/ft along its y = 0 face."""
    nodes, elements = ftt.mesh.box_hex_mesh(*CUBEBEAM_BOX, 0.1, 0.1, 1.0)
    loads = np.zeros_like(nodes)
    loads[nodes[:, 1] == 0.0, 1] += 100.0 * ftt.units.lbf / ftt.units.ft / (5 * 51)
    fixed = ftt.fix_where(nodes, lambda p: p[:, 2] == 0.0, 3)
    return nodes, elements, fixed, loads, ftt.Material(E=10_000_000 * ftt.units.psi, nu=0.3)


def run_cubebeam(ftt, counters) -> dict:
    nodes, elements, fixed, loads, mat = cubebeam_arrays(ftt)
    root = nodes[:, 2] == 0.0
    checks = {"(E, k) held against the plain version in [8]": (elements.shape[0], 24) in APPLY_PATH}
    launches = {}
    scene64 = ftt.make_scene(nodes, elements, fixed, loads, mat, dtype=torch.float64)
    # f32 node coordinates are not congruent to build_operator's 1e-9, so
    # an f32 scene would get the matfree kind (as in the reference): the
    # f32 solve takes the uniform operator of the f64 mesh, cast to f32
    op32 = ftt.build_operator(scene64, dtype=torch.float32)
    for label, dtype, kw in (("cg f64", torch.float64, dict(method="cg", tol=1e-8)),
                             ("dense f64", torch.float64, dict(method="dense")),
                             ("cg f32", torch.float32, dict(method="cg", tol=1e-5, on_nonconverged="ignore",
                                                            operator=op32))):
        scene = ftt.make_scene(nodes, elements, fixed, loads, mat, dtype=dtype)
        sol, counts, wall = counted(counters, lambda: ftt.solve(scene, **kw))
        launches[f"cubebeam {label}"] = counts
        u = sol.displacements.cpu().numpy()
        r = sol.reactions.cpu().double().numpy()
        max_u = float(np.abs(u).max())
        balance = abs(r[root, 1].sum() + loads[~root, 1].sum()) / np.abs(loads).sum()
        st = sol.stats
        say(f"  cubebeam {label} ({scene.n_dof} DOF): {wall:.3f} s, {st.iterations} iterations, reported true "
            f"residual {st.relative_residual:.3e}, converged {st.converged}; max|u| {max_u:.5e} "
            f"(anchor {CUBEBEAM_ANCHOR:g}); root reactions + load {balance:.2e} of the load; launches K7 f32 "
            f"{counts['uniform_f32']}, K7 f64 {counts['uniform_f64']}")
        checks[f"{label}: max|u| within 1e-3 of the anchor"] = abs(max_u / CUBEBEAM_ANCHOR - 1) <= 1e-3
        if dtype == torch.float64:
            checks[f"{label}: converged"] = st.converged
            checks[f"{label}: root reactions balance the load (1e-8)"] = balance <= 1e-8
            checks[f"{label}: K7 f64 launched, not f32"] = counts["uniform_f64"] > 0 and counts["uniform_f32"] == 0
        else:
            checks[f"{label}: K7 f32 launched, not f64"] = counts["uniform_f32"] > 0 and counts["uniform_f64"] == 0
    require(checks, "cubebeam")
    return launches


def run_voxel_ebe(ftt, counters) -> dict:
    nodes, elements = ftt.mesh.box_hex_mesh(*EBE_BOX, 0.1, 0.1, EBE_LZ)
    fixed, loads, tip = scenes.cantilever_bcs(nodes, EBE_LZ)
    mat = ftt.Material(E=10_000_000 * ftt.units.psi, nu=0.3)
    scene = ftt.make_scene(nodes, elements, fixed, loads, mat, dtype=torch.float64)
    say(f"  scene: {EBE_BOX} voxels, 0.1 x 0.1 x {EBE_LZ}, {scene.n_dof} DOF on {scene.device}")
    sol, counts, wall = counted(counters, lambda: ftt.solve(scene, tol=1e-8))
    st = sol.stats
    say(f"  whole solve (fea_tpu_torch.solve): {wall:.3f} s, {st.iterations} iterations "
        f"({wall / max(st.iterations, 1) * 1e3:.3f} ms an iteration), reported true residual "
        f"{st.relative_residual:.3e}, converged {st.converged}")
    say("  launches in that solve: " + ", ".join(f"{KERNELS[k]['name'].split()[0]} {k} {counts[k]}"
                                                 for k in KERNELS))

    # stage breakdown: a second solve, stage by stage, then the CG loop profiled
    t0 = time.perf_counter()
    op = ftt.build_operator(scene, dtype=torch.float64)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    presc = scene.prescribed_or_zero(torch.float64)
    budget = min(max(1000, 10 * scene.n_dof), 100_000)
    t0 = time.perf_counter()
    sol2 = ftt.solve_operator(op, scene.loads, presc, tol=1e-8, max_iters=budget)
    torch.cuda.synchronize()
    t_cg = time.perf_counter() - t0
    say(f"  stages (second solve): build_operator ({op.kind}) {t_build:.3f} s, Jacobi PCG with the true "
        f"residual {t_cg:.3f} s; {sol2.stats.iterations} iterations")
    prof = profile_fcg(lambda: ftt.solve_operator(op, scene.loads, presc, tol=1e-8, max_iters=budget))
    it = prof["sol"].stats.iterations
    say(f"  profiled CG stage: wall {prof['wall_s']:.3f} s under the profiler, device time "
        f"{prof['device_ms']:.1f} ms in {prof['n_device']} device activities "
        f"({prof['n_device'] / max(it, 1):.1f} an iteration over {it} iterations); "
        f"busy share {prof['device_ms'] / 1e3 / t_cg:.3f} of the unprofiled CG stage")
    for name, ms in prof["top"]:
        say(f"    {ms:9.2f} ms  {name[:90]}")
    del op

    u = sol.displacements.cpu().numpy()
    if u.shape != nodes.shape or not np.all(np.isfinite(u)):
        raise AssertionError(f"displacements: shape {u.shape}, finite {np.all(np.isfinite(u))}")
    _, rel_host = host_check(nodes, elements, mat, fixed, loads, u)
    max_u = float(np.abs(u).max())
    I = 0.1 * 0.1**3 / 12.0
    tip_ratio = float(u[tip, 1].mean()) / (EBE_LZ**3 / (3 * mat.E * I))
    say(f"  host f64 true relative residual {rel_host:.3e}; max|u| {max_u:.6e} (JAX {EBE_MAX_U:g}); "
        f"tip ratio {tip_ratio:.5f}; iterations {st.iterations} (JAX {EBE_JAX_ITERS})")
    require({
        "converged": st.converged,
        f"iterations within 5% of {EBE_JAX_ITERS}": abs(st.iterations - EBE_JAX_ITERS) <= 0.05 * EBE_JAX_ITERS,
        "host true residual <= 1e-8": rel_host <= 1e-8,
        "max|u| within 5e-4": abs(max_u / EBE_MAX_U - 1) <= 5e-4,
        f"tip ratio in {TIP_BAND}": TIP_BAND[0] < tip_ratio < TIP_BAND[1],
        "K7 f64 launches >= iterations": counts["uniform_f64"] >= st.iterations,
        "K1/K2/K4/K5 not launched": all(counts[k] == 0 for k in STENCIL_KEYS + VAR_KEYS),
        "(E, k) held against the plain version in [8]": (elements.shape[0], 24) in APPLY_PATH,
    }, "voxel element-by-element")
    return {"voxel": counts}


def run_distorted_ebe(ftt, counters) -> dict:
    nodes, elements, _ = scenes.distorted_arrays(EBE_BOX, EBE_LZ)
    fixed, loads, _ = scenes.cantilever_bcs(nodes, EBE_LZ)
    mat = ftt.Material(E=10_000_000 * ftt.units.psi, nu=0.3)
    scene = ftt.make_scene(nodes, elements, fixed, loads, mat, dtype=torch.float64)
    say(f"  scene: {EBE_BOX} distorted, {scene.n_dof} DOF")
    sol_m, c_m, wall_m = counted(counters, lambda: ftt.solve(scene, tol=1e-8))
    mf = ftt.build_operator(scene, dtype=torch.float64)
    stored = dataclasses.replace(mf, kind="stored", ke=mf.element_matrices().contiguous(), geom=None, material=None)
    del mf
    sol_s, c_s, wall_s = counted(counters, lambda: ftt.solve(scene, method="cg", operator=stored, tol=1e-8))
    del stored
    results = {}
    for label, sol, counts, wall in (("matfree", sol_m, c_m, wall_m), ("stored", sol_s, c_s, wall_s)):
        u = sol.displacements.cpu().numpy()
        _, rel_host = host_check(nodes, elements, mat, fixed, loads, u)
        st = sol.stats
        results[label] = (u, rel_host, st)
        say(f"  {label} solve: {wall:.3f} s, {st.iterations} iterations "
            f"({wall / max(st.iterations, 1) * 1e3:.3f} ms an iteration), reported {st.relative_residual:.3e}, "
            f"host f64 true residual {rel_host:.3e}; launches K6 f64 {counts['stored_f64']}, "
            f"K7 f64 {counts['uniform_f64']}")
    (u_m, r_m, st_m), (u_s, r_s, st_s) = results["matfree"], results["stored"]
    diff = float(np.abs(u_m - u_s).max() / np.abs(u_m).max())
    say(f"  matfree vs stored displacements: {diff:.3e} of max|u|; iterations {st_m.iterations} and "
        f"{st_s.iterations} (JAX {EBE_DISTORTED_JAX_ITERS})")
    require({
        "both converged": st_m.converged and st_s.converged,
        "both host true residuals <= 1e-8": r_m <= 1e-8 and r_s <= 1e-8,
        "displacements agree within 1e-4 of max|u|": diff <= 1e-4,
        "iterations within 5% of each other": abs(st_m.iterations - st_s.iterations) <= 0.05 * st_m.iterations,
        f"matfree iterations within 5% of {EBE_DISTORTED_JAX_ITERS}":
            abs(st_m.iterations - EBE_DISTORTED_JAX_ITERS) <= 0.05 * EBE_DISTORTED_JAX_ITERS,
        "matfree: no kernel launched": all(v == 0 for v in c_m.values()),
        "stored: K6 f64 launches >= iterations": c_s["stored_f64"] >= st_s.iterations,
        "(E, k) held against the plain version in [8]": (elements.shape[0], 24) in APPLY_PATH,
    }, "distorted element-by-element")
    return {"distorted matfree": c_m, "distorted stored": c_s}


def run_beams_bars(ftt, counters) -> dict:
    E, I, L, q = 210e9, 1e-6, 1.0, 1000.0  # examples/euler_bernoulli.py

    def beam(n):
        x = np.linspace(0.0, L, n + 1)[:, None]
        el = np.stack([np.arange(n), np.arange(n) + 1], axis=1)
        fe = ftt.elements.beam.uniform_load_vector(torch.as_tensor(x), torch.as_tensor(el), q).numpy()
        loads = np.zeros((n + 1, 2))
        np.add.at(loads.reshape(-1), (el[:, :, None] * 2 + np.arange(2)).reshape(-1), fe.reshape(-1))
        fixed = np.zeros((n + 1, 2), bool)
        fixed[0] = fixed[-1] = True
        return ftt.make_scene(x, el, fixed, loads, ftt.Material(E, 0.0), family="eb_beam", section=np.float64(I),
                              dtype=torch.float64)

    s32 = np.sqrt(3.0) / 2.0
    tripod_nodes = np.array([[1.0, 0.0, 0.0], [-0.5, s32, 0.0], [-0.5, -s32, 0.0], [0.0, 0.0, 1.0]])
    tripod_fixed = np.zeros((4, 3), bool)
    tripod_fixed[:3] = True
    tripod_loads = np.zeros((4, 3))
    tripod_loads[3, 2] = -50.0

    tripod_el = np.array([[0, 3], [1, 3], [2, 3]])

    def tripod(dtype):
        return ftt.make_scene(tripod_nodes, tripod_el, tripod_fixed, tripod_loads,
                              ftt.Material(1.0, 0.0), family="bar3d", section=np.full(3, 1000.0), dtype=dtype)

    truss_fixed = np.zeros((3, 2), bool)
    truss_fixed[:2] = True
    truss_loads = np.zeros((3, 2))
    truss_loads[2] = [0.0, -100.0]
    truss = ftt.make_scene(np.array([[0.0, 0.0], [0.0, 1.0], [1.0, 0.5]]), np.array([[0, 2], [1, 2]]), truss_fixed,
                           truss_loads, ftt.Material(1.0, 0.0), family="bar2d", section=np.full(2, 1000.0),
                           dtype=torch.float64)
    runs = {
        "beam 100 dense": lambda: ftt.solve(beam(BEAM_ELEMENTS[0]), method="dense"),
        "beam 40 dense": lambda: ftt.solve(beam(BEAM_ELEMENTS[1]), method="dense"),
        "beam 40 cg": lambda: ftt.solve(beam(BEAM_ELEMENTS[1]), method="cg", tol=1e-12, on_nonconverged="ignore"),
        "tripod f64 dense": lambda: ftt.solve(tripod(torch.float64), method="dense"),
        "tripod f32 cg": lambda: ftt.solve(tripod(torch.float32), method="cg", tol=1e-6),
        "truss newton": lambda: ftt.solve_nonlinear(truss, tol=1e-12),
    }
    out, launches = {}, {}
    for label, fn in runs.items():
        out[label], launches[label], wall = counted(counters, fn)
        say(f"  {label}: {wall:.3f} s; launches K6 f32 {launches[label]['stored_f32']}, "
            f"K6 f64 {launches[label]['stored_f64']}")
    w = out["beam 100 dense"].displacements.cpu().numpy()[:, 0]
    mid_err = abs(w[50] / (q * L**4 / (384 * E * I)) - 1)
    ud, uc = (out[k].displacements.cpu().numpy() for k in ("beam 40 dense", "beam 40 cg"))
    cg_err = float(np.abs(ud - uc).max() / np.abs(ud).max())
    ut = out["tripod f64 dense"].displacements.cpu().numpy()
    ut32 = out["tripod f32 cg"].displacements.cpu().numpy()
    uz = -50.0 / 1500.0
    u_nl, nst = out["truss newton"]
    say(f"  beam midspan vs qL^4/384EI: {mid_err:.2e}; 40-element cg ({out['beam 40 cg'].stats.iterations} "
        f"iterations, reported {out['beam 40 cg'].stats.relative_residual:.2e}) vs dense {cg_err:.2e}; tripod "
        f"u_z {ut[3, 2]:.12f} (f32 {ut32[3, 2]:.8f}, exact {uz:.12f}); truss Newton {nst.iterations} steps, "
        f"|R| {nst.residual_norm:.2e}, apex {u_nl[2].cpu().numpy()}")
    require({
        "beam midspan within 1e-9": mid_err <= 1e-9,
        "beam cg within 1e-9 of dense": cg_err <= 1e-9,
        "tripod f64 within 1e-9": abs(ut[3, 2] / uz - 1) <= 1e-9 and np.abs(ut[3, :2]).max() < 1e-9,
        "tripod f32 within 1e-5": abs(ut32[3, 2] / uz - 1) <= 1e-5,
        "truss Newton converged (1e-12) within 10 steps": nst.converged and nst.iterations <= 10,
        "K6 f64 launched at k = 4": launches["beam 100 dense"]["stored_f64"] > 0
        and launches["beam 40 cg"]["stored_f64"] > 0,
        "K6 f64 launched at k = 6": launches["tripod f64 dense"]["stored_f64"] > 0,
        "K6 f32 launched at k = 6": launches["tripod f32 cg"]["stored_f32"] > 0,
        "tripod (E, k) held against the plain version in [8]": (len(tripod_el), 6) in APPLY_PATH,
    }, "beams and bars")
    return launches


# The one solve of phase [9] whose launches the kernels line reports for each key
PER_SOLVE = {"stored_f32": "tripod f32 cg", "stored_f64": "distorted stored",
             "uniform_f32": "cubebeam cg f32", "uniform_f64": "voxel"}


def run_ebe(ftt, counters) -> dict:
    """Phase [9]: every element-by-element path, each solve counted from
    0. Returns each K6/K7 key's launches in its solve of ``PER_SOLVE``."""
    solves = {}
    say("  [9.1] cubebeam")
    solves.update(run_cubebeam(ftt, counters))
    say("  [9.2] 49,179-DOF voxel cantilever, auto-routed")
    solves.update(run_voxel_ebe(ftt, counters))
    say("  [9.3] the same box distorted: matfree and stored")
    solves.update(run_distorted_ebe(ftt, counters))
    say("  [9.4] beams and bars")
    solves.update(run_beams_bars(ftt, counters))
    per_solve = {k: solves[label][k] for k, label in PER_SOLVE.items()}
    say("  K6/K7 launches in one solve each: " + ", ".join(f"{k} {per_solve[k]} ({PER_SOLVE[k]})"
                                                         for k in APPLY_KEYS))
    say("  K6/K7 launches over phase [9]: " + ", ".join(f"{k} {sum(c[k] for c in solves.values())}"
                                                       for k in APPLY_KEYS))
    require({f"{k} launched in {PER_SOLVE[k]}": v > 0 for k, v in per_solve.items()}, "element-by-element launches")
    return per_solve


def shard_bytes(ext: list, table: torch.Tensor) -> int:
    """Bytes of one slab apply a shard: each halo-extended input (Zl + 2
    planes) read once, its Zl output planes written once, the region
    table read once."""
    g = ext[0]
    plane = g[0].numel()
    return sum(2 * e.numel() - 2 * plane for e in ext) * g.element_size() + table.numel() * table.element_size()


def csr_fits(N: int, dtype: torch.dtype) -> tuple[bool, str]:
    """Whether ``stencil_csr`` of an N-node grid and its weight field fit
    the card's free memory: the field, the int64 column grid, the kept
    columns (int64, then int32) and values, at 243 entries a node."""
    torch.cuda.empty_cache()
    need = 243 * N * (torch.empty((), dtype=dtype).element_size() * 2 + 8 * 2 + 4)
    free = torch.cuda.mem_get_info()[0]
    return need < 0.9 * free, f"needs ~{need / 1e9:.1f} GB, {free / 1e9:.1f} GB free"


def check_slab_kernels(ftt, cuda_stencil) -> dict:
    """Phase [10]: K1's halo form and K3 against their plain versions."""
    from fea_tpu_torch.ops.structured import stencil_apply_chunked_grid, stencil_apply_slab_grid
    from fea_tpu_torch.parallel import shard_geometry

    ke = flagship_ke(ftt)
    ke64 = torch.as_tensor(ke, device=DEV)
    weights = {k: cuda_stencil.stencil_weights(ke, KERNELS[k]["dtype"], DEV) for k in SLAB_KEYS}
    whole_name = {"slab_f32": "K1", "slab_f64": "K2"}
    rng = np.random.default_rng(20261019)
    report = {k: dict(max_abs_err=0.0, max_rel_err=0.0) for k in SLAB_KEYS}

    def hold(key, got, want, what):
        spec = KERNELS[key]
        err = float((got.double() - want).abs().max())
        rel = err / float(want.abs().max())
        if not rel <= spec["tol"]:
            raise AssertionError(f"{spec['name']} at {what}: rel err {rel:.3e} > {spec['tol']:g}")
        report[key]["max_abs_err"] = max(report[key]["max_abs_err"], err)
        report[key]["max_rel_err"] = max(report[key]["max_rel_err"], rel)
        return rel

    # the shards of [12]'s decomposition, each slab on its halo-extended
    # input, raw and masked (a random 0/1 mask, 0 on the padding)
    for dims, n in SLAB_SMALL + [(FLAGSHIP, n) for n in SLAB_FLAGSHIP_SHARDS]:
        nx, ny, nz = dims
        Z, Y, X = nz + 1, ny + 1, nx + 1
        Zl = shard_geometry(Z, n, [(0, 1, 2)] * (2 if dims == FLAGSHIP else 1))[0]
        Zp = n * Zl
        g64 = torch.zeros((Zp + 2, Y, X, 3), dtype=torch.float64, device=DEV)
        g64[1 : Z + 1] = torch.as_tensor(rng.normal(size=(Z, Y, X, 3)), device=DEV)
        F64 = torch.zeros_like(g64)
        F64[1 : Z + 1] = torch.as_tensor((rng.random((Z, Y, X, 3)) < 0.8).astype(np.float64), device=DEV)
        slabs = [slice(i * Zl, i * Zl + Zl + 2) for i in range(n)]
        want = torch.cat([stencil_apply_slab_grid(ke64, g64[sl], i * Zl, Z) for i, sl in enumerate(slabs)])
        want_m = torch.cat([stencil_apply_slab_grid(ke64, g64[sl], i * Zl, Z, F64[sl]) for i, sl in enumerate(slabs)])
        parts = []
        for key in SLAB_KEYS:
            w, g, F = weights[key], g64.to(KERNELS[key]["dtype"]), F64.to(KERNELS[key]["dtype"])
            got = torch.cat([cuda_stencil.stencil_apply_slab(w, g[sl], i * Zl, Z) for i, sl in enumerate(slabs)])
            got_m = torch.cat([cuda_stencil.stencil_apply_slab(w, g[sl], i * Zl, Z, F[sl])
                               for i, sl in enumerate(slabs)])
            torch.cuda.synchronize()
            rel = hold(key, got, want, f"{dims} in {n} shards")
            rel_m = float((got_m.double() - want_m).abs().max() / want.abs().max())
            if not rel_m <= KERNELS[key]["tol"]:
                raise AssertionError(f"{KERNELS[key]['name']} masked at {dims} in {n} shards: rel err {rel_m:.3e}")
            whole = g[1 : Z + 1].contiguous()
            same = torch.equal(got[:Z], cuda_stencil.stencil_apply(w, whole))
            same_m = (torch.equal(got_m[:Z], cuda_stencil.stencil_apply(w, whole, F[1 : Z + 1].contiguous()))
                      and int(torch.count_nonzero(got_m[Z:])) == 0)
            if not (same and same_m):
                raise AssertionError(f"{KERNELS[key]['name']} at {dims} in {n} shards: slabs differ from "
                                     f"{whole_name[key]} (raw equal {same}, masked equal {same_m})")
            parts.append(f"{KERNELS[key]['name'].split()[0]} rel err {rel:.3e}, masked {rel_m:.3e}, bitwise "
                         f"{whole_name[key]} raw {same} masked {same_m}")
        say(f"  {dims} in {n} shards of {Zl} planes ({Zp - Z} padded): " + "; ".join(parts))

    # the whole grid in slabs over views, against the plain version and the unchunked kernel
    for dims, n in [((13, 7, 29), 4), (FLAGSHIP, SHARDS), (CAPACITY, None), (CAPACITY_16M, None)]:
        nx, ny, nz = dims
        Z, Y, X = nz + 1, ny + 1, nx + 1
        n = n or cuda_stencil.dd_z_chunks(Y, X, Z)
        g64 = torch.as_tensor(rng.normal(size=(Z, Y, X, 3)), device=DEV)
        F64 = torch.as_tensor((rng.random((Z, Y, X, 3)) < 0.8).astype(np.float64), device=DEV)
        want = stencil_apply_chunked_grid(ke64, g64, n)
        for key in SLAB_KEYS:
            spec = KERNELS[key]
            w, g, F = weights[key], g64.to(spec["dtype"]).contiguous(), F64.to(spec["dtype"])
            got = cuda_stencil.stencil_apply_chunked(w, g, n)
            whole = cuda_stencil.stencil_apply(w, g)
            same_m = torch.equal(cuda_stencil.stencil_apply_chunked(w, g, n, F), cuda_stencil.stencil_apply(w, g, F))
            torch.cuda.synchronize()
            rel = hold(key, got, want, f"{dims} in {n} chunks")
            if not (torch.equal(got, whole) and same_m):
                raise AssertionError(f"{spec['name']} chunked vs {whole_name[key]} at {dims}: raw equal "
                                     f"{torch.equal(got, whole)}, masked equal {same_m}")
            say(f"  {spec['name']} {dims} ({3 * Z * Y * X} DOF) in {n} chunks: rel err {rel:.3e}; bitwise "
                f"{whole_name[key]} unchunked raw True, masked True")
        del g64, F64, want, g, F, got, whole

    # times on the shards [12]'s solver applies: SHARDS halo-extended slabs,
    # each its own tensor, at the flagship and the capacity grid
    for dims in (FLAGSHIP, CAPACITY):
        nx, ny, nz = dims
        Z, Y, X = nz + 1, ny + 1, nx + 1
        Zl = shard_geometry(Z, SHARDS, [(0, 1, 2)] * 2)[0]
        Zp = SHARDS * Zl
        g64 = torch.zeros((Zp + 2, Y, X, 3), dtype=torch.float64, device=DEV)
        g64[1 : Z + 1] = torch.as_tensor(rng.normal(size=(Z, Y, X, 3)), device=DEV)
        ext64 = [g64[i * Zl : i * Zl + Zl + 2].clone() for i in range(SHARDS)]
        want = torch.cat([stencil_apply_slab_grid(ke64, e, i * Zl, Z) for i, e in enumerate(ext64)])[:Z]
        for key in SLAB_KEYS:
            spec = KERNELS[key]
            w, ext = weights[key], [e.to(spec["dtype"]) for e in ext64]
            g = g64[1 : Z + 1].to(spec["dtype"]).contiguous()

            def shards():
                return [cuda_stencil.stencil_apply_slab(w, e, i * Zl, Z) for i, e in enumerate(ext)]

            fext = [torch.ones_like(e) for e in ext]

            def shards_masked():
                return [cuda_stencil.stencil_apply_slab(w, e, i * Zl, Z, f) for i, (e, f) in enumerate(zip(ext, fext))]

            got = torch.cat(shards())[:Z]
            torch.cuda.synchronize()
            rel = hold(key, got, want, f"{dims} on {SHARDS} shards")
            ms = event_ms(shards)
            masked_ms = event_ms(shards_masked)
            dev_ms, dev_masked_ms = graph_ms(shards), graph_ms(shards_masked)
            whole_ms = event_ms(lambda: cuda_stencil.stencil_apply(w, g))
            nbytes = shard_bytes(ext, w.table)
            bound_ms, bound_by = bound(spec["dtype"], nbytes, 2 * 9 * neighbour_terms(Z, Y, X))
            fits, why = csr_fits(Z * Y * X, spec["dtype"])
            lib_ms = library_ms(region_field(w.table, Z, Y, X), g, want) if fits else None
            line = (f"  {spec['name']} {dims} ({3 * Z * Y * X} DOF) on {SHARDS} shards of {Zl} + 2 planes: rel err "
                    f"{rel:.3e}; kernel {ms:.4f} ms at the host's pace ({nbytes / (ms * 1e-3) / 1e9:.1f} GB/s), "
                    f"{dev_ms:.4f} ms on the card (graph replay), masked {masked_ms:.4f} / {dev_masked_ms:.4f} ms, "
                    f"{whole_name[key]} "
                    f"unchunked {whole_ms:.4f} ms, CSR SpMV " + (f"{lib_ms:.4f} ms" if fits else f"not built ({why})")
                    + f", bound {bound_ms:.4f} ms ({bound_by})")
            if dims == FLAGSHIP:
                plain_ms = event_ms(lambda: [stencil_apply_slab_grid(w.ke, e, i * Zl, Z) for i, e in enumerate(ext)])
                say(line + f", plain version {plain_ms:.4f} ms")
                report[key].update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by,
                                   whole_ms=whole_ms, masked_ms=masked_ms, device_ms=dev_ms,
                                   masked_device_ms=dev_masked_ms, shards=SHARDS, shard_planes=Zl)
            else:
                say(line)
                report[key].update(capacity_ms=ms, capacity_masked_ms=masked_ms, capacity_device_ms=dev_ms,
                                   capacity_masked_device_ms=dev_masked_ms, capacity_whole_ms=whole_ms,
                                   capacity_bound_ms=bound_ms, capacity_library_ms=lib_ms)
        del g64, ext64, ext, fext, want, g, got
    return report


def run_capacity(ftt, counters) -> dict:
    """Phase [11]: the 8,124,675-DOF cantilever through fea_tpu_torch.solve
    on one card, unchunked."""
    from fea_tpu_torch.elements.hex8 import stiffness_matrix_np
    from fea_tpu_torch.ops.multigrid import build_multigrid
    from fea_tpu_torch.ops.structured import build_structured_operator, stencil_apply_np
    from fea_tpu_torch.solve import solve_operator_fpcg_staged

    t0 = time.perf_counter()
    scene, (nodes, elements, fixed, loads, tip, tip_exact) = flagship_scene(CAPACITY)
    say(f"  scene: {CAPACITY} voxels, {scene.n_dof} DOF on {scene.device} (mesh and scene "
        f"{time.perf_counter() - t0:.2f} s)")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    held_gb = held / 1e9
    sol, counts, wall = counted(counters, lambda: ftt.solve(scene, tol=1e-8))
    own_gb = kept_gb(held, sol)  # this mesh's own entry in the build cache, a part of the solve's peak
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    reserved_gb = torch.cuda.max_memory_reserved() / 1e9
    st = sol.stats
    say(f"  whole solve (fea_tpu_torch.solve): {wall:.3f} s, peak device memory {peak_gb:.3f} GB allocated, "
        f"{reserved_gb:.3f} GB reserved ({held_gb:.3f} GB held before the solve: the scene, the earlier phases' "
        f"references and the build cache's [4]/[6]/[7] builds)")
    say(f"  iterations {st.iterations} (the JAX package on its TPU: {CAPACITY_REF_ITERS}), reported true "
        f"relative residual {st.relative_residual:.3e}, converged {st.converged}")
    say(f"  launches in that solve: K1 {counts['f32']}, K2 {counts['f64']}, K1-halo {counts['slab_f32']}, "
        f"K3 {counts['slab_f64']}")

    stage = {}
    t0 = time.perf_counter()
    op_hi = build_structured_operator(scene, CAPACITY, dtype=torch.float64)
    torch.cuda.synchronize()
    stage["operator_build"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    mg = build_multigrid(op_hi.astype(torch.float32), dtype=torch.float32, free_np=1.0 - fixed.astype(np.float64))
    torch.cuda.synchronize()
    stage["multigrid_build"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sol2 = solve_operator_fpcg_staged(op_hi, scene.loads, scene.prescribed_or_zero(torch.float64), mg, tol=1e-8)
    torch.cuda.synchronize()
    stage["solve (staged, capture included)"] = time.perf_counter() - t0
    say("  stages (second solve): " + ", ".join(f"{k} {v:.3f} s" for k, v in stage.items())
        + f"; {sol2.stats.iterations} iterations, levels "
        + ", ".join(f"{lv.dims}:{str(lv.dtype).replace('torch.', '')}" for lv in mg.levels))
    del sol2

    u = sol.displacements.cpu().numpy()
    if u.shape != nodes.shape or not np.all(np.isfinite(u)):
        raise AssertionError(f"displacements: shape {u.shape}, finite {np.all(np.isfinite(u))}")
    t0 = time.perf_counter()
    _, rel_host = host_check(nodes, elements, scene.material, fixed, loads, u)
    tip_ratio = float(u[tip, 1].mean()) / tip_exact
    say(f"  host f64 true relative residual {rel_host:.3e} (host element-by-element K u "
        f"{time.perf_counter() - t0:.1f} s); tip ratio {tip_ratio:.5f}")
    require({
        "converged": st.converged,
        "host true residual <= 1e-8": rel_host <= 1e-8,
        f"tip ratio in {TIP_BAND}": TIP_BAND[0] < tip_ratio < TIP_BAND[1],
        "K2 launched unchunked": counts["f64"] > 0,
        "no slab launched": counts["slab_f64"] == 0 and counts["slab_f32"] == 0,
    }, "capacity")
    ke = stiffness_matrix_np(nodes[elements[0]], scene.material)
    Z, Y, X = CAPACITY[2] + 1, CAPACITY[1] + 1, CAPACITY[0] + 1
    F = 1.0 - fixed.astype(np.float64)

    def host_rel(v):
        Kv = stencil_apply_np(ke, v.reshape(Z, Y, X, 3), CAPACITY).reshape(-1, 3)
        return float(np.linalg.norm(F * (loads - Kv)) / np.linalg.norm(F * loads))

    say("  FCG stage with certification, the Python loop beside the staged loop (one operator and hierarchy):")
    loop_vs_staged(op_hi, mg, scene.loads, scene.prescribed_or_zero(torch.float64), host_rel)

    # what the cache held through the solve for the other meshes: what the
    # public call frees, less this mesh's own entry
    cached = torch.cuda.memory_allocated()
    ftt.clear_build_cache()
    gc.collect()
    cache_gb = (cached - torch.cuda.memory_allocated()) / 1e9 - own_gb
    say(f"  clear_build_cache() freed {cache_gb + own_gb:.3f} GB, {own_gb:.3f} GB of it this mesh's own entry; "
        f"the solve's peak without the other meshes' entries {peak_gb - cache_gb:.3f} GB")
    require({"peak device memory, the build cache's aside, <= 2.0 GB": peak_gb - cache_gb <= 2.0}, "capacity")
    return dict(scene=scene, op_hi=op_hi, mg=mg, u=u, iterations=st.iterations, tip=tip, tip_exact=tip_exact,
                dims=CAPACITY, ke=ke)


def run_sharded(ftt, counters, refs: dict) -> dict:
    """Phase [12]: the z-sharded solve, SHARDS shards on the one card, at
    the flagship and the capacity grid, against the unsharded solves of
    [4] and [11]. Returns the flagship solve's launches."""
    from fea_tpu_torch.ops.structured import stencil_apply_np
    from fea_tpu_torch.parallel import build_zsharded_solver
    from fea_tpu_torch.solve import solve_operator_fpcg

    flagship_counts = None
    for label, ref in refs.items():
        scene, op_hi, mg = ref["scene"], ref["op_hi"], ref["mg"]
        presc = scene.prescribed_or_zero(torch.float64)
        t0 = time.perf_counter()
        solver = build_zsharded_solver(op_hi, mg, [torch.device(DEV, 0)] * SHARDS)
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
        Z = solver.grid_shape[0]
        say(f"  {label} ({scene.n_dof} DOF): Z = {Z}, Zl = {solver.z_local}, Zp = {SHARDS * solver.z_local}; "
            f"sharded levels {'0-1' if len(solver.mg.levels) == 2 else '0'}, replicated "
            + ", ".join(f"{lv.dims}:{str(lv.dtype).replace('torch.', '')}" for lv in solver.mg.rest.levels)
            + f"; solver build {t_build:.3f} s")
        vcycles = []
        precondition = solver.precondition
        solver.precondition = lambda r: vcycles.append(1) or precondition(r)
        sol, counts, wall = counted(counters, lambda: solver.solve(scene.loads, presc, tol=1e-8))
        n_vc = len(vcycles)
        # the replicated remainder's launches in one V-cycle, counted apart
        rest0 = solver.mg.rest.levels[0]
        _, rest, _ = counted(counters, lambda: solver.mg.rest._vcycle(0, torch.zeros_like(rest0.free)))
        st = sol.stats
        say(f"  sharded solve: {wall:.3f} s, {st.iterations} iterations (unsharded {ref['iterations']}), reported "
            f"true residual {st.relative_residual:.3e}, converged {st.converged}; {n_vc} V-cycles")
        say(f"  launches: K1-halo {counts['slab_f32']}, K3 {counts['slab_f64']}, K1 {counts['f32']}, K2 "
            f"{counts['f64']} (the replicated levels: K1 {rest['f32']}, K2 {rest['f64']} a V-cycle)")

        t0 = time.perf_counter()
        solve_operator_fpcg(op_hi, scene.loads, presc, mg, tol=1e-8)
        torch.cuda.synchronize()
        wall_one = time.perf_counter() - t0
        for name, fn, w in (("unsharded", lambda: solve_operator_fpcg(op_hi, scene.loads, presc, mg, tol=1e-8),
                             wall_one),
                            ("sharded", lambda: solver.solve(scene.loads, presc, tol=1e-8), wall)):
            prof = profile_fcg(fn)
            it = prof["sol"].stats.iterations
            say(f"  profiled {name} FCG with certification: wall {w:.3f} s unprofiled, {prof['wall_s']:.3f} s "
                f"profiled; device time {prof['device_ms']:.1f} ms in {prof['n_device']} device activities "
                f"({prof['n_device'] / max(it, 1):.0f} an iteration over {it}); busy share "
                f"{prof['device_ms'] / 1e3 / prof['wall_s']:.3f} of the profiled wall")
            for kname, ms in prof["top"][:4]:
                say(f"    {ms:9.2f} ms  {kname[:90]}")

        u = sol.displacements.cpu().numpy()
        if u.shape != ref["u"].shape or not np.all(np.isfinite(u)):
            raise AssertionError(f"displacements: shape {u.shape}, finite {np.all(np.isfinite(u))}")
        nx, ny, nz = ref["dims"]
        Ku = stencil_apply_np(ref["ke"], u.reshape(nz + 1, ny + 1, nx + 1, 3), ref["dims"]).reshape(-1, 3)
        F = scene.free_mask(torch.float64).cpu().numpy()
        loads = scene.loads.cpu().numpy()
        rel_host = float(np.linalg.norm(F * (loads - Ku)) / np.linalg.norm(F * loads))
        du = float(np.abs(u - ref["u"]).max() / np.abs(ref["u"]).max())
        tip_ratio = float(u[ref["tip"], 1].mean()) / ref["tip_exact"]
        say(f"  host f64 true relative residual {rel_host:.3e}; displacements vs the unsharded solve {du:.3e} of "
            f"max|u|; tip ratio {tip_ratio:.5f}")
        require({
            "converged": st.converged,
            "host true residual <= 1e-8": rel_host <= 1e-8,
            "iterations within 1 of the unsharded solve": abs(st.iterations - ref["iterations"]) <= 1,
            "displacements within 10 tol of the unsharded solve": du <= 1e-7,
            f"tip ratio in {TIP_BAND}": TIP_BAND[0] < tip_ratio < TIP_BAND[1],
            "K3 launched on every shard of every FCG apply": counts["slab_f64"] >= SHARDS * (st.iterations + 1),
            "K1-halo launched": counts["slab_f32"] > 0,
            "level 1 sharded (the shard shape [10] timed)": len(solver.mg.levels) == 2,
            "K1/K2 only on the replicated levels": counts["f32"] == n_vc * rest["f32"]
            and counts["f64"] == n_vc * rest["f64"],
        }, f"sharded {label}")
        if label == "flagship":
            flagship_counts = counts
        del solver, sol
    return flagship_counts


MANY_CASES = 8  # tools/many_bench.py's batch


def run_many(ftt, counters) -> dict:
    """Phase [13]: ``solve_many`` on the flagship grid with
    tools/many_bench.py's 8 tip-load cases (``default_rng(17)``: y U(0.5, 2),
    x U(-1, 1), each times 100 / tip nodes). Every case must converge with a
    host f64 true residual (``host_ku``) <= 1e-8, and case 0 must agree with
    a single ``solve()`` of it within 10 tol. Returns the batch's launches."""
    from fea_tpu_torch.bench.many import tip_loads

    scene, (nodes, elements, fixed, _, tip, _) = flagship_scene()
    batch = tip_loads(nodes, tip, MANY_CASES)
    one = dataclasses.replace(scene, loads=torch.as_tensor(batch[0], device=DEV))
    ftt.solve(one, tol=1e-8)  # warm
    # the cache cleared before each timed call, so that both route, build
    # and capture as a solve on a new mesh does
    ftt.clear_build_cache()
    single, _, single_wall = counted(counters, lambda: ftt.solve(one, tol=1e-8))
    ftt.clear_build_cache()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    sol, counts, wall = counted(counters, lambda: ftt.solve_many(scene, batch, tol=1e-8))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    st = sol.stats
    say(f"  solve_many of {MANY_CASES} cases ({scene.n_dof} DOF): {wall:.3f} s, {wall / MANY_CASES:.3f} s a case "
        f"against {single_wall:.3f} s for one warm solve() (ratio {wall / MANY_CASES / single_wall:.3f}); peak "
        f"device memory {peak_gb:.3f} GB")
    say(f"  iterations per case {st.iterations.tolist()} (single solve {single.stats.iterations}); launches K1 "
        f"{counts['f32']}, K2 {counts['f64']}")
    rels = []
    t0 = time.perf_counter()
    for i in range(MANY_CASES):
        _, rel = host_check(nodes, elements, scene.material, fixed, batch[i], sol.displacements[i].cpu().numpy())
        rels.append(rel)
    u0 = single.displacements
    du = float((sol.displacements[0] - u0).abs().max() / u0.abs().max())
    say(f"  host f64 true relative residuals {', '.join(f'{r:.2e}' for r in rels)} ({time.perf_counter() - t0:.1f} s); "
        f"case 0 vs the single solve {du:.3e} of max|u|")
    require({
        "every case converged": bool(st.converged.all()),
        "every host true residual <= 1e-8": max(rels) <= 1e-8,
        "case 0 within 10 tol of a single solve()": du <= 1e-7,
        "K1 launched": counts["f32"] > 0,
        "K2 launched": counts["f64"] > 0,
    }, "solve_many")
    return counts


def timed(fn):
    """(fn(), host seconds ending in a synchronize)."""
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


class patched:
    """Attributes of modules replaced for the length of a ``with`` block,
    and environment variables set: ``patched({(module, name): value},
    env={name: value})``."""

    def __init__(self, attrs: dict, env: Optional[dict] = None):
        self.attrs, self.env = attrs, env or {}

    def __enter__(self):
        self.saved = {key: getattr(*key) for key in self.attrs}
        self.saved_env = {k: os.environ.get(k) for k in self.env}
        for (mod, name), value in self.attrs.items():
            setattr(mod, name, value)
        os.environ.update(self.env)
        return self

    def __exit__(self, *exc):
        for (mod, name), value in self.saved.items():
            setattr(mod, name, value)
        for k, v in self.saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        return False


def must_not_run(route: str):
    def fail(*args, **kwargs):
        raise AssertionError(f"the {route} route was taken")

    return fail


def spy(calls: list, label: str, fn):
    return lambda *a, **kw: calls.append(label) or fn(*a, **kw)


def check_embedded_field(cuda_varstencil, op) -> dict:
    """K4/K5 against their plain version (f64) on the embedded operator's
    fine weight field, whose void cells carry zero weights: within the
    tolerances of [5], and exactly zero on every void node's row; timed
    beside the plain version, a CSR SpMV of the field and the bound (the
    nonzero weight blocks, each read once, and the grid in and out)."""
    from fea_tpu_torch.ops.curvilinear import _OFFSETS, curv_apply_grid

    w64 = op.w
    Z, Y, X = op.grid_shape
    g64 = torch.as_tensor(np.random.default_rng(20261018).standard_normal((Z, Y, X, 3)), device=DEV)
    want = curv_apply_grid(w64, g64)
    scale = float(want.abs().max())
    void = (w64.abs().sum(dim=(0, 1, 2)) == 0)  # nodes no cell of the mesh touches
    nnz_blocks = int((w64.abs().sum(dim=(1, 2)) != 0).sum())
    # a block-symmetric field's least blocks: each nonzero pair once, and the centres
    least_blocks = (nnz_blocks + int((w64[13].abs().sum(dim=(0, 1)) != 0).sum())) // 2
    report = {}
    for key in VAR_KEYS:
        spec = KERNELS[key]
        w = w64.to(spec["dtype"]).contiguous()
        g = g64.to(spec["dtype"]).contiguous()
        got = cuda_varstencil.var_apply(w, g)
        torch.cuda.synchronize()
        err = float((got.double() - want).abs().max())
        rel = err / scale
        void_zero = bool((got[void] == 0).all())
        ms = graph_ms(lambda: cuda_varstencil.var_apply(w, g))
        host_ms = event_ms(lambda: cuda_varstencil.var_apply(w, g))
        plain_ms = event_ms(lambda: curv_apply_grid(w, g))
        lib_ms = library_ms(w, g, want)
        nbytes = (9 * nnz_blocks + 2 * g.numel()) * g.element_size()
        bound_ms, bound_by = bound(spec["dtype"], nbytes, 2 * 9 * nnz_blocks)
        bound14, _ = bound(spec["dtype"], (9 * least_blocks + 2 * g.numel()) * g.element_size(), 2 * 9 * nnz_blocks)
        say(f"  {spec['name']} on the void-masked {(X - 1, Y - 1, Z - 1)} field ({int(void.sum())} void nodes of "
            f"{Z * Y * X}, {nnz_blocks} nonzero blocks of {27 * Z * Y * X}): max abs err {err:.3e}, rel {rel:.3e} "
            f"(tol {spec['tol']:g}), void rows exactly 0: {void_zero}; card {ms:.4f} ms, host pace {host_ms:.4f} ms, "
            f"plain version {plain_ms:.4f} ms, CSR SpMV {lib_ms:.4f} ms, bound {bound_ms:.4f} ms on every nonzero block "
            f"({bound_by}), {bound14:.4f} ms on the nonzero blocks a symmetric field stores once")
        require({f"{spec['name']} within {spec['tol']:g}": rel <= spec["tol"], "void rows exactly 0": void_zero},
                "K4/K5 on the void-masked field")
        report[key] = dict(max_abs_err=err, ms=ms, host_ms=host_ms, plain_ms=plain_ms, library_ms=lib_ms,
                           bound_ms=bound_ms, bound_by=bound_by, bound_14_ms=bound14)
        del w, g, got
    return report


def run_embedded(ftt, counters) -> dict:
    """Phase [14]: the arbitrary cell through the embedded route. Returns
    the K4/K5 report on its field and the solve's launches."""
    from fea_tpu_torch.ops import cuda_varstencil
    from fea_tpu_torch.ops.canonical import infer_subgrid_embedding
    from fea_tpu_torch.ops.curvilinear import assemble_curv_weights, build_curv_multigrid
    from fea_tpu_torch.solve import embed, staged

    solve_mod = sys.modules["fea_tpu_torch.solve"]
    scene, a = scenes.l_domain(ARBITRARY, device=DEV)
    nodes, elements, fixed, mat = a["nodes"], a["elements"], a["fixed"], a["mat"]
    say(f"  scene: {ARBITRARY} L-domain, {scene.n_dof} DOF, {scene.n_elements} elements on {scene.device}")
    ftt.clear_build_cache()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    taken = []
    with patched({(solve_mod, "_solve_unstructured_amg"): must_not_run("AMG"),
                  (solve_mod, "solve_subgrid_embedded"): spy(taken, "embedded", solve_mod.solve_subgrid_embedded)}):
        zero_counts(staged.COUNTS)
        with FieldSpy(cuda_varstencil) as fields:
            sol, launches, whole_s = counted(counters, lambda: ftt.solve(scene, tol=1e-8))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    st = sol.stats
    say(f"  whole solve (fea_tpu_torch.solve, detection and build included): {whole_s:.3f} s, peak device memory "
        f"{peak_gb:.3f} GB; {st.iterations} iterations (the reference on its TPU: {EMBED_REF_ITERS}), reported "
        f"{st.relative_residual:.3e}, converged {st.converged}; replays {staged.COUNTS['steps']}")
    say(f"  launches in that solve: K1 {launches['f32']}, K2 {launches['f64']}, K4 {launches['var_f32']}, "
        f"K5 {launches['var_f64']}")
    u = sol.displacements.cpu().numpy()
    (Ku, rel_host), host_s = timed(lambda: host_check(nodes, elements, mat, fixed, a["loads"], u))
    reac_err = float(np.abs(sol.reactions.cpu().numpy() - Ku).max() / np.abs(Ku).max())
    say(f"  host f64 true relative residual {rel_host:.3e} ({host_s:.1f} s); reactions vs host K u {reac_err:.3e}")
    require({
        "the embedded route ran": taken == ["embedded"],
        "converged": st.converged,
        f"iterations within 1 of {EMBED_ITERS}": abs(st.iterations - EMBED_ITERS) <= 1,
        "host true residual <= 1e-8": rel_host <= 1e-8,
        "reactions = K u (1e-10)": reac_err <= 1e-10,
        "K4 launched": launches["var_f32"] > 0,
        "K5 launched": launches["var_f64"] > 0,
        "K1/K2 not launched": launches["f32"] == 0 and launches["f64"] == 0,
    }, "embedded")
    fields.check("[14] the embedded solve")

    # the set-up by stage, on the same scene afresh
    det, t_detect = timed(lambda: infer_subgrid_embedding(scene))
    dims, lat, valid = det
    carrier, op, mg, _ = embed._cached_embedding(scene)
    emb_nodes = carrier.nodes
    (w, _), t_w = timed(lambda: assemble_curv_weights(emb_nodes, dims, mat, valid=valid))
    free_np = 1.0 - carrier.fixed.cpu().numpy().astype(np.float64)
    _, t_mg = timed(lambda: build_curv_multigrid(w, dims, free_np))
    del w
    built = embed._cached_embedding(scene)
    _, t_fcg = timed(lambda: embed.solve_subgrid_embedded(scene, built, tol=1e-8))
    say(f"  stages: detector (infer_subgrid_embedding) {t_detect:.3f} s, weights on the void-masked box {t_w:.3f} s, "
        f"multigrid {t_mg:.3f} s, FCG with certification (warm, from the cached build) {t_fcg:.3f} s; box {dims}, "
        f"{int(valid.sum())} of {valid.size} cells, levels "
        + ", ".join(f"{lv.dims}:{str(lv.dtype).replace('torch.', '')}" for lv in mg.levels))

    report = check_embedded_field(cuda_varstencil, op)

    new_loads = np.zeros_like(a["loads"])
    new_loads[a["tip"], 0] = -2.0 / a["tip"].sum()
    new_loads[a["tip"], 2] = 0.5 / a["tip"].sum()
    cached_second_solve(ftt, scene, new_loads, whole_s,
                        lambda v: host_check(nodes, elements, mat, fixed, new_loads, v)[1])

    say("  FCG stage with certification, the Python loop beside the staged loop (one operator and hierarchy):")
    idx = torch.as_tensor(lat, device=DEV)
    loads_lat = torch.zeros((carrier.n_nodes, 3), dtype=torch.float64, device=DEV)
    loads_lat[idx] = scene.loads
    loop_vs_staged(op, mg, loads_lat, torch.zeros_like(loads_lat),
                   lambda v: host_check(nodes, elements, mat, fixed, a["loads"], v[lat])[1])

    rng = np.random.default_rng(17)
    batch = np.zeros((MANY_CASES,) + nodes.shape)
    for i in range(MANY_CASES):
        batch[i, a["tip"], 1] = rng.uniform(0.5, 2.0) / a["tip"].sum()
        batch[i, a["tip"], 0] = rng.uniform(-1.0, 1.0) / a["tip"].sum()
    many, counts, wall = counted(counters, lambda: ftt.solve_many(scene, batch, tol=1e-8))
    rels = [host_check(nodes, elements, mat, fixed, batch[i], many.displacements[i].cpu().numpy())[1]
            for i in range(MANY_CASES)]
    say(f"  solve_many of {MANY_CASES} tip loads: {wall:.3f} s ({wall / MANY_CASES:.3f} s a case, against "
        f"{t_fcg:.3f} s for one warm FCG stage); iterations {many.stats.iterations.tolist()}; host f64 true "
        f"residuals {', '.join(f'{r:.2e}' for r in rels)}; launches K4 {counts['var_f32']}, K5 {counts['var_f64']}")
    require({"every case converged": bool(many.stats.converged.all()),
             "every host true residual <= 1e-8": max(rels) <= 1e-8,
             "K4/K5 launched": counts["var_f32"] > 0 and counts["var_f64"] > 0,
             "K1/K2 not launched": counts["f32"] == 0 and counts["f64"] == 0}, "embedded solve_many")
    ftt.clear_build_cache()
    return dict(report=report, launches={k: launches[k] for k in VAR_KEYS}, iterations=st.iterations)


def bcsr_csr(op) -> torch.Tensor:
    """The (3N, 3N) CSR matrix of a BCSR operator's raw blocks (the zero
    padding dropped), on its device, int32 indices, rows in order."""
    N, b, V, _ = op.Wt.shape
    keep = op.Wt.abs().sum(dim=(1, 3)) != 0  # (N, V) nonzero blocks
    vals = op.Wt  # (N, i, V, j): row 3n + i, column 3 nbr[n, v] + j
    cols = (op.nbr[:, None, :, None] * b + torch.arange(b, device=op.nbr.device)).expand(N, b, V, b)
    mask = keep[:, None, :, None].expand(N, b, V, b)
    per_row = (b * keep.sum(dim=1)).repeat_interleave(b)
    crow = torch.zeros(N * b + 1, dtype=torch.int64, device=op.nbr.device)
    crow[1:] = torch.cumsum(per_row, 0)
    return torch.sparse_csr_tensor(crow.to(torch.int32), cols[mask].to(torch.int32), vals[mask],
                                   size=(N * b, N * b), check_invariants=False)


def no_kernel_timing(label: str, apply_fn, u: torch.Tensor, want: torch.Tensor, nbytes: int, flops: int,
                     csr: torch.Tensor) -> dict:
    """Card and host-pace times of ``apply_fn(u)``, checked against
    ``want`` (``host_ku``'s K u, which shares no code with the apply), its
    bound, and one cuSPARSE CSR SpMV of the same product."""
    got = apply_fn(u)
    torch.cuda.synchronize()
    rel = float((got.double() - want).abs().max() / want.abs().max())
    tol = 1e-12 if u.dtype == torch.float64 else 2e-5
    x = u.reshape(-1)
    y = torch.mv(csr, x).reshape(want.shape)
    lib_rel = float((y.double() - want).abs().max() / want.abs().max())
    ms = graph_ms(lambda: apply_fn(u))
    host_ms = event_ms(lambda: apply_fn(u))
    lib_ms = event_ms(lambda: torch.mv(csr, x))
    bound_ms, bound_by = bound(u.dtype, nbytes, flops)
    say(f"  {label}: rel err {rel:.3e} (tol {tol:g}); card {ms:.4f} ms, host pace {host_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}, {nbytes / 1e6:.1f} MB), CSR SpMV {lib_ms:.4f} ms (rel {lib_rel:.1e})")
    require({f"{label} within {tol:g}": rel <= tol, "CSR agrees (1e-5)": lib_rel <= 1e-5}, label)
    return dict(ms=ms, host_ms=host_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms, max_rel_err=rel)


def run_amg(ftt, counters) -> dict:
    """Phase [15]: the arbitrary cell through the AMG route; the BCSR apply
    timed. Returns the apply times."""
    from fea_tpu_torch.solve import cache, staged

    solve_mod = sys.modules["fea_tpu_torch.solve"]
    scene, a = scenes.l_domain(ARBITRARY, device=DEV)
    nodes, elements, fixed, mat = a["nodes"], a["elements"], a["fixed"], a["mat"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_start = [time.perf_counter()]

    def stamp(msg):
        now = time.perf_counter()
        torch.cuda.synchronize()
        say(f"    set-up +{now - t_start[0]:.3f} s: {msg}")

    real_setup = solve_mod.build_amg_setup
    taken = []

    def staged_setup(sc, **kw):
        t_start[0] = time.perf_counter()
        return real_setup(sc, progress=stamp, **kw)

    with patched({(solve_mod, "solve_subgrid_embedded"): must_not_run("embedded"),
                  (solve_mod, "build_amg_setup"): staged_setup,
                  (solve_mod, "_solve_unstructured_amg"): spy(taken, "amg", solve_mod._solve_unstructured_amg)},
                 env={"FEA_TPU_NO_EMBED": "1"}):
        zero_counts(staged.COUNTS)
        sol, launches, whole_s = counted(counters, lambda: ftt.solve(scene, tol=1e-8))
        steps = staged.COUNTS["steps"]
    if "FEA_TPU_NO_EMBED" in os.environ:
        raise AssertionError("FEA_TPU_NO_EMBED was not restored")
    setup = cache._cached_build(("amg", True), scene, must_not_run("a second AMG build"))
    _, t_fcg = timed(lambda: solve_mod._solve_unstructured_amg(scene, setup, tol=1e-8, max_iters=1000))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    st = sol.stats
    op, amg = setup
    say(f"  whole solve (fea_tpu_torch.solve, build included): {whole_s:.3f} s, peak device memory {peak_gb:.3f} GB; "
        f"{st.iterations} iterations (the reference on its TPU: {AMG_REF_ITERS}), reported {st.relative_residual:.3e}, "
        f"converged {st.converged}; replays {steps}; FCG with certification alone (warm) {t_fcg:.3f} s; levels "
        + ", ".join(f"{lv.op.n_nodes}x{lv.op.dofs_per_node} V={lv.op.nbr.shape[1]}" for lv in amg.levels)
        + f", coarsest inverse {amg.coarse_inv.shape[0]}^2")
    u = sol.displacements.cpu().numpy()
    (Ku, rel_host), host_s = timed(lambda: host_check(nodes, elements, mat, fixed, a["loads"], u))
    reac_err = float(np.abs(sol.reactions.cpu().numpy() - Ku).max() / np.abs(Ku).max())
    say(f"  host f64 true relative residual {rel_host:.3e} ({host_s:.1f} s); reactions vs host K u {reac_err:.3e}")
    require({"the AMG route ran": taken == ["amg"], "converged": st.converged,
             "host true residual <= 1e-8": rel_host <= 1e-8, "reactions = K u (1e-10)": reac_err <= 1e-10,
             "no kernel launched": not any(launches.values())}, "AMG")

    # the BCSR apply, f64 (the FCG apply) and f32 (the V-cycle's level 0)
    N, b, V, _ = op.Wt.shape
    nnz = int((op.Wt.abs().sum(dim=(1, 3)) != 0).sum())
    csr = bcsr_csr(op)
    u_np = np.random.default_rng(20261019).standard_normal((N, 3))
    u64 = torch.as_tensor(u_np, device=DEV)
    want = torch.as_tensor(host_ku(nodes, elements, float(mat.E), float(mat.nu), u_np), device=DEV)
    out = {}
    for key, o in (("bcsr_f64", op), ("bcsr_f32", amg.levels[0].op)):
        uu = u64.to(o.dtype)
        esize = uu.element_size()
        nbytes = nnz * (9 * esize + 4) + 2 * uu.numel() * esize
        out[key] = no_kernel_timing(f"BCSR apply {str(o.dtype).replace('torch.', '')} ({N} nodes, {nnz} blocks)",
                                    o.apply_raw, uu, want, nbytes, 18 * nnz, csr if o is op else csr.to(o.dtype))
    keep = op.Wt.abs().sum(dim=(1, 3)) != 0  # (N, V) nonzero blocks, columns in order within a row
    try:
        crow = torch.cat([torch.zeros(1, dtype=torch.int64, device=DEV), torch.cumsum(keep.sum(dim=1), 0)])
        bsr = torch.sparse_bsr_tensor(crow.to(torch.int32), op.nbr[keep].to(torch.int32),
                                      op.Wt.permute(0, 2, 1, 3)[keep], size=(3 * N, 3 * N))
        y = (bsr @ u64.reshape(-1, 1)).reshape(N, 3)
        bsr_rel = float((y - want).abs().max() / want.abs().max())
        bsr_ms = event_ms(lambda: bsr @ u64.reshape(-1, 1))
        say(f"  torch.sparse BSR (3x3 blocks) product f64: {bsr_ms:.4f} ms (rel {bsr_rel:.1e})")
        out["bcsr_f64"]["bsr_ms"] = bsr_ms
        del bsr
    except (RuntimeError, NotImplementedError) as exc:  # a library comparison, not a path of the port
        say(f"  torch.sparse BSR product f64: not taken by this torch ({type(exc).__name__}: {str(exc)[:120]})")
    out["bcsr_f64"]["applies"] = f"{steps} replays x 1 + certification"
    out["bcsr_f32"]["applies"] = f"{steps} replays x {2 * amg.degree + 1} (level 0)"
    del csr

    say("  FCG stage with certification, the Python loop beside the staged loop (one operator and hierarchy):")
    loop_vs_staged(op, amg, scene.loads, scene.prescribed_or_zero(torch.float64),
                   lambda v: host_check(nodes, elements, mat, fixed, a["loads"], v)[1])
    del setup, op, amg
    ftt.clear_build_cache()
    return out


def run_two_level(ftt, counters) -> dict:
    """Phase [16]: the 73,899-DOF L-domain through the two-level route, the
    element-by-element apply timed, and the block-Jacobi fallback forced
    once. Returns the apply times."""
    from fea_tpu_torch.assembly import assemble_bcoo
    from fea_tpu_torch.ops import twolevel
    from fea_tpu_torch.solve import staged

    solve_mod = sys.modules["fea_tpu_torch.solve"]
    scene, a = scenes.l_domain(TWO_LEVEL_L, device=DEV)
    nodes, elements, fixed, mat = a["nodes"], a["elements"], a["fixed"], a["mat"]
    say(f"  scene: {TWO_LEVEL_L} L-domain, {scene.n_dof} DOF, {scene.n_elements} elements")
    ftt.clear_build_cache()
    off = {"FEA_TPU_NO_EMBED": "1", "FEA_TPU_NO_AMG": "1"}
    taken = []
    with patched({(solve_mod, "_solve_unstructured_two_level"):
                  spy(taken, "two-level", solve_mod._solve_unstructured_two_level)}, env=off):
        op64, t_op = timed(lambda: solve_mod._operator_f64(scene, True))
        tl, t_tl = timed(lambda: solve_mod._two_level(scene, op64))
        zero_counts(staged.COUNTS)
        sol, launches, t_solve = counted(counters, lambda: ftt.solve(scene, tol=1e-8))
        steps = staged.COUNTS["steps"]
    st = sol.stats
    say(f"  stages: f64 operator {t_op:.3f} s, two-level build ({tl.n_aggs} aggregates, coarse "
        f"{tl.ac_inv.shape[0]}^2 inverted on the card) {t_tl:.3f} s, solve() from those builds {t_solve:.3f} s; "
        f"{st.iterations} iterations (the reference on its TPU: {TWO_LEVEL_REF_ITERS}+), reported "
        f"{st.relative_residual:.3e}, replays {steps}; launches K6 {launches['stored_f64']}, K7 {launches['uniform_f64']}")
    u = sol.displacements.cpu().numpy()
    _, rel_host = host_check(nodes, elements, mat, fixed, a["loads"], u)
    say(f"  host f64 true relative residual {rel_host:.3e} (the JAX package on the CPU: {TWO_LEVEL_JAX_ITERS} "
        f"iterations)")
    require({"the two-level route ran": taken == ["two-level"], "converged": st.converged,
             "host true residual <= 1e-8": rel_host <= 1e-8, "fixed rows exactly 0": not u[fixed].any(),
             f"iterations <= {TWO_LEVEL_JAX_ITERS} + 3": st.iterations <= TWO_LEVEL_JAX_ITERS + 3}, "two-level")

    # the element-by-element (hex8_matfree) apply, f64 (the FCG apply) and f32 (the smoother's)
    E = elements.shape[0]
    csr = assemble_bcoo(op64.element_matrices(), op64.elements, 3, scene.n_dof).to_sparse_csr()
    u_np = np.random.default_rng(20261020).standard_normal(nodes.shape)
    u64 = torch.as_tensor(u_np, device=DEV)
    want = torch.as_tensor(host_ku(nodes, elements, float(mat.E), float(mat.nu), u_np), device=DEV)
    out = {}
    for key, o in (("matfree_f64", op64), ("matfree_f32", tl.op32)):
        uu = u64.to(o.dtype)
        esize = uu.element_size()
        # gradients (E, 8, 3, 8) and weights (E, 8), the connectivity (int64)
        # and the incidence plan (positions int64 + mask), u in, K u out
        plan = o.plan.positions.numel() * (8 + esize)
        nbytes = E * (8 * 24 + 8) * esize + E * 8 * 8 + plan + 2 * uu.numel() * esize
        flops = E * 8 * (2 * 3 * 8 * 3 * 2 + 30)  # H = G u and G^T sigma, 144 flops each, and the stress
        out[key] = no_kernel_timing(f"hex8_matfree apply {str(o.dtype).replace('torch.', '')} ({E} elements)",
                                    o.apply_raw, uu, want, nbytes, flops, csr if o is op64 else csr.to(o.dtype))
    out["matfree_f64"]["applies"] = f"{steps} replays x 1 + certification"
    out["matfree_f32"]["applies"] = f"{steps} replays x {2 * tl.degree + 1}"
    del csr, op64, tl

    # the block-Jacobi fallback, forced by a two-level build that fails
    def boom(*args, **kwargs):
        raise RuntimeError("forced two-level build failure")

    ftt.clear_build_cache()
    with patched({(twolevel, "build_two_level_cheb"): boom}, env=off), warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        sol_b, _, t_b = counted(counters, lambda: ftt.solve(scene, tol=1e-8))
    msgs = [str(w.message) for w in seen if issubclass(w.category, RuntimeWarning)]
    _, rel_b = host_check(nodes, elements, mat, fixed, a["loads"], sol_b.displacements.cpu().numpy())
    say(f"  block-Jacobi fallback: warned {msgs[:1]}; {sol_b.stats.iterations} iterations in {t_b:.3f} s, host f64 "
        f"true relative residual {rel_b:.3e}")
    require({"warned": any("two-level preconditioner build failed" in m for m in msgs),
             "converged": sol_b.stats.converged, "host true residual <= 1e-8": rel_b <= 1e-8}, "block-Jacobi fallback")
    ftt.clear_build_cache()
    return out


TUBE = (256, 384)  # tools/tube_bench.py's defaults: 591,360 DOF, 512 nodes and 256 quads a layer
# iterations of the JAX package on its TPU on that scene (As = 64, degree 3), a
# count, not a time: docs/PERF.md:617-630, 889
TUBE_REF_ITERS = 26
TUBE_LOAD = scenes.TUBE_LOAD  # lbf, tools/tube_bench.py's cosine tip load
TUBE_CASES = 4


def tensor_bytes(*objs) -> int:
    """Bytes of every tensor held by ``objs`` (dataclasses, tuples of them),
    each counted once: what a function that reads all of them reads."""
    seen, total = set(), 0
    stack = list(objs)
    while stack:
        o = stack.pop()
        if isinstance(o, torch.Tensor):
            if o.data_ptr() not in seen:
                seen.add(o.data_ptr())
                total += o.numel() * o.element_size()
        elif dataclasses.is_dataclass(o):
            stack.extend(getattr(o, f.name) for f in dataclasses.fields(o))
        elif isinstance(o, (tuple, list)):
            stack.extend(o)
    return total


def extruded_flops(pc) -> dict:
    """Operations of one application of each piece of the composed
    preconditioner ``pc`` (multiply and add counted apart), from its shapes;
    ``apply_f32`` is also the count of any apply of the fine operator."""
    mgz, sc = pc.mg, pc.sc

    def apply_flops(op):  # the batched Ke product and the incidence sums
        return 2 * 576 * (op.n_layers - 1) * op.kes.shape[0] + 2 * 24 * (op.n_layers - 1) * op.kes.shape[0]

    def thomas_flops(uinv):
        L, b, _ = uinv.shape
        return 2 * (3 * L - 2) * b * b

    out = {"z_thomas": thomas_flops(mgz.thomas_uinv), "section": thomas_flops(sc.thomas_uinv)}
    levels = 0
    for i, lv in enumerate(mgz.levels):
        L, b = lv.op.n_layers, 3 * lv.op.n2
        jacobi = 2 * L * b * b
        if i == 0:
            out["block_jacobi"], out["apply_f32"] = jacobi, apply_flops(lv.op)
        # two smoothings of `degree` block solves and applies, one residual apply
        levels += 2 * mgz.degree * (jacobi + apply_flops(lv.op)) + apply_flops(lv.op)
    # f32 work, and the f64 residual update of the composition
    out["precond_f32"], out["compose_f64"] = levels + out["z_thomas"] + out["section"], apply_flops(pc.op)
    return out


def run_extruded(ftt, counters) -> dict:
    """Phase [17]: the 591,360-DOF tube of tools/tube_bench.py through the
    extruded route. Returns the times of its compute, which has no TPU kernel."""
    from fea_tpu_torch.assembly import assemble_bcoo
    from fea_tpu_torch.ops.extruded import build_extruded_operator, infer_extruded
    from fea_tpu_torch.ops.extruded_mg import (ComposedExtrudedPrecond, build_extruded_multigrid,
                                               build_section_coarse)
    from fea_tpu_torch.solve import staged

    solve_mod = sys.modules["fea_tpu_torch.solve"]
    scene, _, a = scenes.tube(*TUBE, device=DEV)
    nodes, elements, fixed, mat, loads = a["nodes"], a["elements"], a["fixed"], a["mat"], a["loads"]
    say(f"  scene: {TUBE[0]}-segment annulus x {TUBE[1]} layers, {scene.n_dof} DOF, {scene.n_elements} elements "
        f"on {scene.device}; TF32 for matmul {torch.backends.cuda.matmul.allow_tf32}")
    require({"591,360 DOF": scene.n_dof == 591_360,
             "f32 products in full f32 (TF32 off)": not torch.backends.cuda.matmul.allow_tf32}, "tube scene")
    ftt.clear_build_cache()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    say("  set-up before the first solve: " + ", ".join(time_detectors(scene)))
    routes = []
    real_large = solve_mod._solve_large_hex8

    def record(*args, **kwargs):
        out = real_large(*args, **kwargs)
        routes.append(None if out is None else out[1])
        return out

    with patched({(solve_mod, "_solve_large_hex8"): record,
                  (solve_mod, "solve_curvilinear"): must_not_run("curvilinear")}):
        zero_counts(staged.COUNTS)
        sol, launches, whole_s = counted(counters, lambda: ftt.solve(scene, tol=1e-8))
        steps = staged.COUNTS["steps"]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    st = sol.stats
    say(f"  whole solve (fea_tpu_torch.solve, detection and build included): {whole_s:.3f} s, peak device memory "
        f"{peak_gb:.3f} GB; route {routes}; {st.iterations} iterations (the reference on its TPU: {TUBE_REF_ITERS}), "
        f"reported {st.relative_residual:.3e}, converged {st.converged}; replays {steps}")
    u = sol.displacements.cpu().numpy()
    (Ku, rel_host), host_s = timed(lambda: host_check(nodes, elements, mat, fixed, loads, u))
    reac = sol.reactions.cpu().numpy()
    reac_err = float(np.abs(reac - Ku).max() / np.abs(Ku).max())
    ring = fixed.any(axis=1)
    ring_y, load_y = float(reac[ring, 1].sum()), float(loads[:, 1].sum())
    balance = abs(ring_y + load_y) / abs(load_y)
    say(f"  host f64 true relative residual {rel_host:.3e} ({host_s:.1f} s); reactions vs host K u {reac_err:.3e}; "
        f"y-sum of the reactions over the fixed ring {ring_y:.9f} lbf against the load's {load_y:.9f} lbf "
        f"(balance {balance:.2e}); tip deflection min u_y {float(u[:, 1].min()):.6e} m")
    if st.iterations > TUBE_REF_ITERS:
        say(f"  iterations {st.iterations} above the reference's {TUBE_REF_ITERS}: a fault to log in ROADMAP queue 3")
    require({
        "the extruded route ran": routes == ["fpcg-extruded-multigrid"],
        "converged": st.converged,
        "host true residual <= 1e-8": rel_host <= 1e-8,
        "reactions = K u (1e-10)": reac_err <= 1e-10,
        "reactions balance the load (1e-6)": balance <= 1e-6,
        "fixed ring exactly 0": not u[fixed].any(),
        "no kernel launched": not any(launches.values()),
    }, "extruded")

    # the set-up by stage, on the same scene afresh
    det, t_det = timed(lambda: infer_extruded(dataclasses.replace(scene)))
    op, t_op = timed(lambda: build_extruded_operator(scene, det, dtype=torch.float64))
    mgz, t_mg = timed(lambda: build_extruded_multigrid(scene, det, degree=3))
    sc, t_sc = timed(lambda: build_section_coarse(scene, det, target_section_aggregates=64))
    pc = ComposedExtrudedPrecond(mg=mgz, sc=sc, op=op)
    _, t_first = timed(lambda: ftt.solve_extruded(scene, det, tol=1e-8, prebuilt=(op, pc)))
    _, t_fcg = timed(lambda: ftt.solve_extruded(scene, det, tol=1e-8, prebuilt=(op, pc)))
    # the reference's composition: r - A z with the V-cycle's f32 level-0 operator
    pc_ref = ComposedExtrudedPrecond(mg=mgz, sc=sc, op=mgz.levels[0].op)
    ftt.solve_extruded(scene, det, tol=1e-8, prebuilt=(op, pc_ref))
    ref, t_ref = timed(lambda: ftt.solve_extruded(scene, det, tol=1e-8, prebuilt=(op, pc_ref)))
    rel_ref = host_check(nodes, elements, mat, fixed, loads, ref.displacements.cpu().numpy())[1]
    say(f"  the reference's composition (r - A z by the f32 level-0 operator) on the same factors: "
        f"{ref.stats.iterations} iterations, FCG with certification {t_ref:.3f} s warm, host f64 true residual "
        f"{rel_ref:.3e}, converged {ref.stats.converged}")
    del ref, pc_ref
    say(f"  stages: detector {t_det:.3f} s, operator {t_op:.3f} s, hierarchy {t_mg:.3f} s, section coarse "
        f"{t_sc:.3f} s, FCG with certification {t_first:.3f} s first (captures), {t_fcg:.3f} s warm; levels "
        + ", ".join(f"{lv.op.n_layers} layers (lambda_max {lv.lam_max:.4f}, special {list(lv.special_idx)})"
                    for lv in mgz.levels)
        + f", Thomas {mgz.thomas_uinv.shape[0]} layers of {mgz.thomas_uinv.shape[1]}; section coarse "
        f"{sc.n_aggs} aggregates, {sc.n_layers} layers of {sc.thomas_uinv.shape[1]}; stored "
        f"{tensor_bytes(op, pc) / 1e9:.3f} GB")

    new_loads = np.zeros_like(loads)
    new_loads[:, 0] = 0.5 * TUBE_LOAD * a["w"]
    new_loads[:, 1] = -2.0 * TUBE_LOAD * a["w"]
    cached_second_solve(ftt, scene, new_loads, whole_s,
                        lambda v: host_check(nodes, elements, mat, fixed, new_loads, v)[1])

    say("  FCG stage with certification, the Python loop beside the staged loop (one operator and hierarchy):")
    loop_vs_staged(op, pc, scene.loads, scene.prescribed_or_zero(torch.float64),
                   lambda v: host_check(nodes, elements, mat, fixed, loads, v)[1])

    rng = np.random.default_rng(17)
    batch = np.zeros((TUBE_CASES,) + nodes.shape)
    for i in range(TUBE_CASES):
        batch[i, :, 1] = -rng.uniform(0.5, 2.0) * TUBE_LOAD * a["w"]
        batch[i, :, 0] = rng.uniform(-1.0, 1.0) * TUBE_LOAD * a["w"]
    many, counts, wall = counted(counters, lambda: ftt.solve_many(scene, batch, tol=1e-8))
    rels = [host_check(nodes, elements, mat, fixed, batch[i], many.displacements[i].cpu().numpy())[1]
            for i in range(TUBE_CASES)]
    say(f"  solve_many of {TUBE_CASES} tip loads: {wall:.3f} s ({wall / TUBE_CASES:.3f} s a case, against "
        f"{t_fcg:.3f} s for one warm FCG stage); iterations {many.stats.iterations.tolist()}; host f64 true residuals "
        f"{', '.join(f'{r:.2e}' for r in rels)}")
    require({"every case converged": bool(many.stats.converged.all()),
             "every host true residual <= 1e-8": max(rels) <= 1e-8,
             "no kernel launched": not any(counts.values())}, "extruded solve_many")

    # the compute of the route, timed on the card beside its bound
    u_np = np.random.default_rng(20261021).standard_normal(nodes.shape)
    u64 = torch.as_tensor(u_np, device=DEV)
    want = torch.as_tensor(host_ku(nodes, elements, float(mat.E), float(mat.nu), u_np), device=DEV)
    L, n2, Q2 = op.n_layers, op.n2, op.kes.shape[0]
    ke_all = op.kes.expand(L - 1, Q2, 24, 24).reshape(-1, 24, 24)
    csr = assemble_bcoo(ke_all, scene.elements, 3, scene.n_dof).to_sparse_csr()
    del ke_all
    flops = extruded_flops(pc)
    lv0 = mgz.levels[0]
    out = {}
    for key, o in (("extruded_apply_f64", op), ("extruded_apply_f32", lv0.op)):
        uu = u64.to(o.dtype)
        nbytes = tensor_bytes(o.kes, o.quads, o.inc_q, o.inc_c, o.inc_m) + 2 * uu.numel() * uu.element_size()
        out[key] = no_kernel_timing(f"extruded apply {str(o.dtype).replace('torch.', '')} ({scene.n_elements} "
                                    f"elements, {Q2} section Ke)", o.apply_raw, uu, want,
                                    nbytes, flops["apply_f32"], csr if o is op else csr.to(o.dtype))
    degree = mgz.degree
    out["extruded_apply_f64"]["applies"] = f"{steps} replays x 2 (FCG and the composition) + certification"
    out["extruded_apply_f32"]["applies"] = f"{steps} replays x {2 * degree + 1} (level 0)"
    del csr

    r32 = (torch.as_tensor(np.random.default_rng(20261022).standard_normal(nodes.shape), device=DEV)
           * op.free).to(torch.float32)
    Lc, b = mgz.thomas_uinv.shape[0], mgz.thomas_uinv.shape[1]
    rc = torch.as_tensor(np.random.default_rng(20261023).standard_normal((Lc, n2, 3)), device=DEV).to(torch.float32)
    rc = rc * mgz.coarse_free
    sc64 = dataclasses.replace(sc, thomas_uinv=sc.thomas_uinv.double(), thomas_g=sc.thomas_g.double())
    z64 = dataclasses.replace(mgz, thomas_uinv=mgz.thomas_uinv.double(), thomas_g=mgz.thomas_g.double())

    def jacobi64(r):
        rf = r.double().reshape(L, -1)
        z = rf @ lv0.minv_interior.double().T
        z[lv0.special] = torch.bmm(lv0.minv_special.double(), rf[lv0.special].unsqueeze(-1))[..., 0]
        return z.reshape(r.shape)

    r3 = r32.reshape(L, n2, 3)
    # (name, function, its f64 twin on the same stored factors or None, tolerance, bytes, f32 flops, f64 flops, count)
    pieces = [
        ("extruded_block_jacobi_f32", "level-0 block-Jacobi", lambda: lv0.block_jacobi(r3), lambda: jacobi64(r3), 2e-5,
         tensor_bytes(lv0.minv_interior, lv0.minv_special) + 2 * r3.numel() * 4, flops["block_jacobi"], 0,
         f"{steps} replays x {2 * degree}"),
        ("extruded_thomas_z_f32", f"z-coarse Thomas solve ({Lc} layers of {b})", lambda: mgz._coarse_solve(rc),
         lambda: z64._coarse_solve(rc.double()), 1e-4,
         tensor_bytes(mgz.thomas_uinv, mgz.thomas_g) + 2 * rc.numel() * 4, flops["z_thomas"], 0,
         f"{steps} replays x 1"),
        ("extruded_section_coarse_f32", f"section coarse solve ({sc.n_layers} layers of {sc.thomas_uinv.shape[1]})",
         lambda: sc(r32), lambda: sc64(r32.double()), 1e-3,
         tensor_bytes(sc) + 2 * r32.numel() * 4, flops["section"], 0, f"{steps} replays x 1"),
        ("extruded_precond_f32", "whole preconditioner (section coarse, then the V-cycle)", lambda: pc(r32), None, None,
         tensor_bytes(pc) + 2 * r32.numel() * 4, flops["precond_f32"], flops["compose_f64"], f"{steps} replays x 1"),
    ]
    case = staged._Case(0, op.free.shape, op.free.device, torch.zeros(5, dtype=torch.float64, device=DEV))
    # a zero budget: the step is frozen, and does the same work
    case.start(op.free, op.rhs(scene.loads, scene.prescribed_or_zero(torch.float64)), None, 1e-8, 0)
    pieces.append(("extruded_fcg_step", "FCG step (preconditioner, f64 apply, dots, updates)",
                   lambda: case.step(op.apply, pc), None, None,
                   tensor_bytes(op, pc) + 12 * op.free.numel() * 8, flops["precond_f32"],
                   flops["compose_f64"] + flops["apply_f32"],
                   f"{steps} replays"))
    for key, label, fn, twin, tol, nbytes, f32_flops, f64_flops, count in pieces:
        got = fn()
        torch.cuda.synchronize()
        finite = bool(torch.isfinite(got).all()) if got is not None else True
        err = None if twin is None else float((got.double() - twin()).abs().max() / twin().abs().max())
        ms = graph_ms(fn, calls=5)
        host_ms = event_ms(fn, runs=5, reps=2)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = (f32_flops / PEAK_FLOPS[torch.float32] + f64_flops / PEAK_FLOPS[torch.float64]) * 1e3
        bound_ms, bound_by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
        say(f"  {label}: card {ms:.4f} ms, host pace {host_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}, "
            f"{nbytes / 1e6:.1f} MB, {(f32_flops + f64_flops) / 1e9:.2f} GFLOP)"
            + ("" if err is None else f", against the same factors in f64 {err:.2e} (tol {tol:g})"))
        require({f"{label} finite": finite, f"{label} within {tol}": err is None or err <= tol}, label)
        out[key] = dict(ms=ms, host_ms=host_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                        max_rel_err=err, applies=count)
    del case, op, mgz, sc, pc, sol, many
    ftt.clear_build_cache()
    return out


# -- [18] the sharded modes of fea_tpu_torch.parallel, four shards on the one card

VAR_SLAB_KEYS = ("var_slab_f32", "var_slab_f64")


def slab_csr(w: torch.Tensor) -> torch.Tensor:
    """The (3 Zl Y X, 3 (Zl + 2) Y X) CSR matrix of one slab's weights
    (27, 3, 3, Zl, Y, X) acting on its halo-extended state: ``stencil_csr``
    of the weights between two zero planes, the two halo planes' rows
    dropped."""
    A = stencil_csr(torch.nn.functional.pad(w, (0, 0, 0, 0, 1, 1)))
    Zl, Y, X = w.shape[3:]
    plane = 3 * Y * X
    crow, col, val = A.crow_indices(), A.col_indices(), A.values()
    s, e = int(crow[plane]), int(crow[plane * (Zl + 1)])
    return torch.sparse_csr_tensor(crow[plane : plane * (Zl + 1) + 1] - s, col[s:e], val[s:e],
                                   size=(plane * Zl, plane * (Zl + 2)), check_invariants=False)


def check_var_slab_kernels(cuda_varstencil) -> dict:
    """[18.1]: K4-slab and K5-slab on the SHARDS slabs of the curvilinear
    fine grid and of its level 1, as ``shard_curvilinear`` cuts them, with
    symmetrized random weights (zero toward the planes past the z ends, as
    assembled) and random state from a NumPy seed: within 2e-5 / 1e-12 of
    the plain slab version run in f64, value for value the unsharded K4/K5
    on the real planes, padding planes 0; the masked slab form within the
    same of its plain version and value for value the unfused expression
    around the raw slab kernel; at the fine grid the times of one apply over
    the four shards (raw and masked) beside the unsharded kernel, the plain
    version, cuSPARSE CSR of the shards' rows and the 27- and 14-block
    bounds."""
    from fea_tpu_torch.ops.curvilinear import coarsen_dims_partial, curv_apply_slab_grid
    from fea_tpu_torch.parallel import shard_geometry

    rng = np.random.default_rng(20261024)
    report = {k: dict(max_abs_err=0.0, max_rel_err=0.0) for k in VAR_SLAB_KEYS}
    fine, axes = CURV, []
    grids = [CURV]
    for _ in range(2):
        nxt, ax = coarsen_dims_partial(grids[-1])
        grids.append(nxt)
        axes.append(ax)
    zls = shard_geometry(CURV[2] + 1, SHARDS, axes)
    for dims, zl in zip(grids[:2], zls):
        nx, ny, nz = dims
        Z, Y, X = nz + 1, ny + 1, nx + 1
        w64 = torch.zeros((27, 3, 3, SHARDS * zl, Y, X), dtype=torch.float64, device=DEV)
        w64[:, :, :, :Z] = symmetric_random(rng, Z, Y, X, zero_z_ends=True)
        g64 = torch.zeros((SHARDS * zl + 2, Y, X, 3), dtype=torch.float64, device=DEV)
        g64[1 : Z + 1] = torch.as_tensor(rng.standard_normal((Z, Y, X, 3)), device=DEV)
        f64 = torch.as_tensor((rng.random(tuple(g64.shape)) < 0.8).astype(np.float64), device=DEV)
        w_sh = [w64[:, :, :, i * zl : (i + 1) * zl].contiguous() for i in range(SHARDS)]
        ext64 = [g64[i * zl : i * zl + zl + 2].clone() for i in range(SHARDS)]
        fext64 = [f64[i * zl : i * zl + zl + 2].clone() for i in range(SHARDS)]
        want = [curv_apply_slab_grid(w, e) for w, e in zip(w_sh, ext64)]
        want_m = [f[1:-1] * curv_apply_slab_grid(w, f * e) + (1.0 - f[1:-1]) * e[1:-1]
                  for w, e, f in zip(w_sh, ext64, fext64)]
        scale = max(float(x.abs().max()) for x in want)
        scale_m = max(float(x.abs().max()) for x in want_m)
        for key in VAR_SLAB_KEYS:
            spec = KERNELS[key]
            dt = spec["dtype"]
            ws, ext = [w.to(dt) for w in w_sh], [e.to(dt) for e in ext64]
            fext = [f.to(dt) for f in fext64]

            def shards():
                return [cuda_varstencil.var_apply_slab(w, e) for w, e in zip(ws, ext)]

            def shards_masked():
                return [cuda_varstencil.var_apply_slab_masked(w, f, e) for w, f, e in zip(ws, fext, ext)]

            got = shards()
            got_m = shards_masked()
            unfused = [f[1:-1] * cuda_varstencil.var_apply_slab(w, f * e) + (1.0 - f[1:-1]) * e[1:-1]
                       for w, f, e in zip(ws, fext, ext)]
            whole_w = w64[:, :, :, :Z].to(dt).contiguous()
            whole_g = g64[1 : Z + 1].to(dt).contiguous()
            whole = cuda_varstencil.var_apply(whole_w, whole_g)
            torch.cuda.synchronize()
            err = max(float((a.double() - b).abs().max()) for a, b in zip(got, want))
            rel = err / scale
            rel_m = max(float((a.double() - b).abs().max()) for a, b in zip(got_m, want_m)) / scale_m
            same_m = all(bool(torch.equal(a, b)) for a, b in zip(got_m, unfused))
            cat = torch.cat(got)
            same = bool(torch.equal(cat[:Z], whole))
            pad_zero = int(torch.count_nonzero(cat[Z:])) == 0
            say(f"  {spec['name']} {dims} in {SHARDS} shards of {zl} planes ({SHARDS * zl - Z} padded): max abs err "
                f"{err:.3e}, rel {rel:.3e} (tol {spec['tol']:g}); value for value the unsharded "
                f"{spec['name'].split('-')[0]} on the {Z} real planes: {same}; padding 0: {pad_zero}; masked rel "
                f"{rel_m:.3e}, value for value the unfused expression: {same_m}")
            require({f"{spec['name']} within {spec['tol']:g}": rel <= spec["tol"],
                     f"{spec['name']} value for value the unsharded kernel": same,
                     f"{spec['name']} padding planes 0": pad_zero,
                     f"{spec['name']} masked within {spec['tol']:g}": rel_m <= spec["tol"],
                     f"{spec['name']} masked = the unfused expression value for value": same_m},
                    f"{spec['name']} at {dims}")
            report[key]["max_abs_err"] = max(report[key]["max_abs_err"], err)
            report[key]["max_rel_err"] = max(report[key]["max_rel_err"], rel, rel_m)
            if dims != fine:
                continue
            ms, dev_ms = event_ms(shards), graph_ms(shards)
            dev_masked_ms = graph_ms(shards_masked)
            whole_ms = event_ms(lambda: cuda_varstencil.var_apply(whole_w, whole_g))
            whole_dev_ms = graph_ms(lambda: cuda_varstencil.var_apply(whole_w, whole_g))
            plain_ms = event_ms(lambda: [curv_apply_slab_grid(w, e) for w, e in zip(ws, ext)], runs=5, reps=2)
            # each (node, offset) pair of a slab has its neighbour in the
            # halo-extended slab along z; along y and x, inside the grid.
            # 14-block: the unordered pairs inside a slab and the centres,
            # and each pair across its two faces (stored on this slab alone)
            cross = (3 * Y - 2) * (3 * X - 2)
            terms = SHARDS * 3 * zl * cross
            least = SHARDS * (((3 * zl - 2) * cross + zl * Y * X) // 2 + 2 * cross)
            esize = whole_g.element_size()
            state = sum(e.numel() for e in ext) + SHARDS * zl * Y * X * 3
            nbytes, nbytes14 = (9 * terms + state) * esize, (9 * least + state) * esize
            bound_ms, bound_by = bound(dt, nbytes, 2 * 9 * terms)
            bound14, _ = bound(dt, nbytes14, 2 * 9 * terms)
            fits, why = csr_fits(SHARDS * zl * Y * X, dt)
            lib_ms = None
            if fits:
                csrs = [slab_csr(w) for w in ws]
                lib = [torch.mv(A, e.reshape(-1)).reshape(w.shape[3:] + (3,)) for A, e, w in zip(csrs, ext, ws)]
                lib_rel = max(float((a.double() - b).abs().max()) for a, b in zip(lib, want)) / scale
                require({"CSR SpMV agrees with the plain version (1e-5)": lib_rel <= 1e-5}, "slab CSR")
                lib_ms = event_ms(lambda: [torch.mv(A, e.reshape(-1)) for A, e in zip(csrs, ext)])
                del csrs, lib
            gbs14 = nbytes14 / (dev_ms * 1e-3) / 1e9
            say(f"  {spec['name']} {dims} ({3 * Z * Y * X} DOF) over {SHARDS} shards: {ms:.4f} ms at the host's pace "
                f"({nbytes / (ms * 1e-3) / 1e9:.1f} GB/s), {dev_ms:.4f} ms on the card (graph replay; {gbs14:.1f} GB/s "
                f"on the 14-block bytes, {bound14 / dev_ms * 100:.0f}% of the 14-block bound); masked "
                f"{dev_masked_ms:.4f} ms on the card; unsharded {spec['name'].split('-')[0]} {whole_ms:.4f} / "
                f"{whole_dev_ms:.4f} ms; plain version {plain_ms:.4f} ms; "
                f"CSR SpMV of the shards' rows " + (f"{lib_ms:.4f} ms" if fits else f"not built ({why})")
                + f"; bound {bound_ms:.4f} ms on 27 blocks ({bound_by}), {bound14:.4f} ms on 14")
            report[key].update(ms=ms, device_ms=dev_ms, masked_device_ms=dev_masked_ms, plain_ms=plain_ms,
                               library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by, bound_14_ms=bound14,
                               gb_per_s_14=gbs14, whole_ms=whole_ms, whole_device_ms=whole_dev_ms, shards=SHARDS,
                               shard_planes=zl)
        del w64, g64, f64, w_sh, ext64, fext64, want, want_m
    return report


def sharded_memory(op_s, mg_s) -> dict:
    """Bytes a shard keeps of the fine level (the f64 operator's and the
    f32 level-0 weight slabs, the masks and the inverse diagonal) and its
    largest tensor."""
    per, largest = [0] * SHARDS, 0
    lv0 = mg_s.levels[0] if mg_s.levels else None
    for i in range(SHARDS):
        ts = [op_s.w[i], op_s.free[i]] + ([lv0.w[i], lv0.free[i], lv0.inv_diag[i]] if lv0 else [])
        per[i] = sum(t.numel() * t.element_size() for t in ts)
        largest = max([largest] + [t.numel() * t.element_size() for t in ts])
    return dict(per_shard=per, largest=largest)


def run_sharded_modes(ftt, counters, flagship_ref: dict, curv_ref: dict, cuda_varstencil) -> tuple[dict, dict]:
    """Phase [18]: every decomposition of ``fea_tpu_torch.parallel`` over
    SHARDS shards of the one card, at full width, each solve host-checked
    by ``host_ku`` and timed beside the unsharded one. Returns the K4-slab
    / K5-slab report and their launches in the sharded curvilinear solve."""
    from fea_tpu_torch.ops.extruded import infer_extruded
    from fea_tpu_torch.parallel import (make_device_mesh, replicated_precond, shard_curvilinear, shard_extruded,
                                        shard_operator, shard_structured_operator, sharded_sweep)
    from fea_tpu_torch.solve import solve_operator_fpcg

    devices = make_device_mesh(SHARDS)
    require({f"{SHARDS} shards on the one card": devices == [torch.device(DEV, 0)] * SHARDS}, "device list")

    say("  [18.1] K4-slab / K5-slab against their plain version and the unsharded K4/K5")
    report = check_var_slab_kernels(cuda_varstencil)

    say(f"  [18.2] shard_operator: the {EBE_BOX} box (K7 f64) and its distorted twin's stored operator (K6 f64)")
    nodes, elements = ftt.mesh.box_hex_mesh(*EBE_BOX, 0.1, 0.1, EBE_LZ)
    fixed, loads, tip = scenes.cantilever_bcs(nodes, EBE_LZ)
    mat = ftt.Material(E=10_000_000 * ftt.units.psi, nu=0.3)
    box = ftt.make_scene(nodes, elements, fixed, loads, mat, dtype=torch.float64)
    dnodes, _, _ = scenes.distorted_arrays(EBE_BOX, EBE_LZ)
    twin = ftt.make_scene(dnodes, elements, fixed, loads, mat, dtype=torch.float64)
    mf = ftt.build_operator(twin, dtype=torch.float64)
    stored = dataclasses.replace(mf, kind="stored", ke=mf.element_matrices().contiguous(), geom=None, material=None)
    del mf
    zero = box.prescribed_or_zero(torch.float64)
    for label, scene, op, key, bound_iters in (("uniform", box, ftt.build_operator(box, dtype=torch.float64),
                                                "uniform_f64", EBE_JAX_ITERS),
                                               ("stored", twin, stored, "stored_f64", EBE_DISTORTED_JAX_ITERS)):
        one, c1, wall1 = counted(counters, lambda: ftt.solve_operator(op, scene.loads, zero, tol=1e-8))
        sop = shard_operator(op, devices)
        sol, counts, wall = counted(counters, lambda: ftt.solve_operator(sop, scene.loads, zero, tol=1e-8))
        st = sol.stats
        u = sol.displacements.cpu().numpy()
        _, rel_host = host_check(scene.host_nodes, elements, mat, fixed, loads, u)
        du = float(np.abs(u - one.displacements.cpu().numpy()).max() / np.abs(u).max())
        say(f"    {label} ({scene.n_dof} DOF, {op.elements.shape[0]} elements, {sop.shards[0].elements.shape[0]} a "
            f"shard): sharded {st.iterations} iterations in {wall:.3f} s, unsharded {one.stats.iterations} in "
            f"{wall1:.3f} s (JAX {bound_iters}); host f64 true residual {rel_host:.3e}; displacements vs unsharded "
            f"{du:.3e} of max|u|; launches {KERNELS[key]['name'].split()[0]} {counts[key]} (unsharded {c1[key]})")
        require({
            "converged": st.converged,
            f"iterations within 1% of {bound_iters}": abs(st.iterations - bound_iters) <= 0.01 * bound_iters + 1,
            "host true residual <= 1e-8": rel_host <= 1e-8,
            "displacements within 10 tol of the unsharded solve": du <= 1e-7,
            f"{key} launched on every shard of every iteration": counts[key] >= SHARDS * st.iterations,
        }, f"shard_operator {label}")
        del sop
    del stored, twin

    say(f"  [18.3] sharded_sweep of {SHARDS} scaled tip loads on the box, one case a shard")
    op = ftt.build_operator(box, dtype=torch.float64)
    single, wall1 = timed(lambda: ftt.solve_displacements(op, box.loads, zero, tol=1e-8))
    batch = torch.arange(1.0, SHARDS + 1.0, dtype=torch.float64, device=DEV)[:, None, None] * box.loads[None]
    u_b, wall = timed(lambda: sharded_sweep(lambda lds: ftt.solve_displacements(op, lds, zero, tol=1e-8), batch,
                                            devices))
    rels = [host_check(nodes, elements, mat, fixed, batch[i].cpu().numpy(), u_b[i].cpu().numpy())[1]
            for i in range(SHARDS)]
    dus = [float((u_b[i] - (i + 1) * single).abs().max() / ((i + 1) * single).abs().max()) for i in range(SHARDS)]
    say(f"    {wall:.3f} s for {SHARDS} cases ({wall1:.3f} s the single solve); host f64 true residuals "
        + ", ".join(f"{r:.2e}" for r in rels) + "; case i vs (i + 1) x the single solve "
        + ", ".join(f"{d:.1e}" for d in dus))
    require({"every case: host true residual <= 1e-8": max(rels) <= 1e-8,
             "every case within 10 tol of the scaled single solve": max(dus) <= 1e-7}, "sharded_sweep")
    del op, box, batch, u_b

    say("  [18.4] shard_structured_operator on the flagship, the unsharded V-cycle beside it")
    scene, op_hi, mg = flagship_ref["scene"], flagship_ref["op_hi"], flagship_ref["mg"]
    presc = scene.prescribed_or_zero(torch.float64)
    one, wall1 = timed(lambda: solve_operator_fpcg(op_hi, scene.loads, presc, mg, tol=1e-8))
    op_s, constrain = shard_structured_operator(op_hi, devices)
    sol, counts, wall = counted(counters, lambda: solve_operator_fpcg(
        op_s, constrain(scene.loads), constrain(presc), replicated_precond(op_s, mg), tol=1e-8))
    st = sol.stats
    u = op_s.gather(sol.displacements).cpu().numpy()
    fl_nodes, fl_elements = scene.host_nodes, scene.host_elements
    fl_fixed, fl_loads = scene.fixed.cpu().numpy(), scene.loads.cpu().numpy()
    _, rel_host = host_check(fl_nodes, fl_elements, scene.material, fl_fixed, fl_loads, u)
    du = float(np.abs(u - flagship_ref["u"]).max() / np.abs(flagship_ref["u"]).max())
    say(f"    {scene.n_dof} DOF, {op_s.z_local} planes a shard: {st.iterations} iterations ([4]: "
        f"{flagship_ref['iterations']}) in {wall:.3f} s, the unsharded FCG loop {one.stats.iterations} in "
        f"{wall1:.3f} s; host f64 true residual {rel_host:.3e}; displacements vs [4] {du:.3e} of max|u|; launches "
        f"K3 {counts['slab_f64']}, K1 {counts['f32']}, K2 {counts['f64']}")
    require({"converged": st.converged,
             "iterations within 1 of [4]": abs(st.iterations - flagship_ref["iterations"]) <= 1,
             "host true residual <= 1e-8": rel_host <= 1e-8,
             "displacements within 10 tol of [4]": du <= 1e-7,
             "K3 launched on every shard of every apply": counts["slab_f64"] >= SHARDS * (st.iterations + 1)},
            "shard_structured_operator")
    del op_s, sol, one

    say(f"  [18.5] shard_curvilinear on [6]'s {CURV} distorted cantilever")
    scene = curv_ref["scene"]
    presc = scene.prescribed_or_zero(torch.float64)
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    op, mg = ftt.build_curvilinear(scene)
    one, wall1 = timed(lambda: solve_operator_fpcg(op, scene.loads, presc, mg, tol=1e-8))
    one_iters, one = one.stats.iterations, None
    before = torch.cuda.memory_allocated()
    (op_s, mg_s, constrain), t_build = timed(lambda: shard_curvilinear(op, mg, devices))
    added = torch.cuda.memory_allocated() - before
    whole_w = op.w.numel() * op.w.element_size()
    whole_w0 = mg.levels[0].w.numel() * mg.levels[0].w.element_size()
    mem = sharded_memory(op_s, mg_s)
    del op, mg
    gc.collect()
    held = torch.cuda.memory_allocated() - base  # the shards and the replicated levels, the whole fields gone
    with FieldSpy(cuda_varstencil) as fields:
        sol, counts, wall = counted(counters, lambda: solve_operator_fpcg(
            op_s, constrain(scene.loads), constrain(presc), mg_s, tol=1e-8))
    fields.check("[18.5] the sharded curvilinear solve")
    prof = profile_fcg(lambda: solve_operator_fpcg(op_s, constrain(scene.loads), constrain(presc), mg_s, tol=1e-8))
    say(f"    FCG stage (the Python loop over the shards), profiled: device {prof['device_ms']:.2f} ms in "
        f"{prof['n_device']} activities, busy share {prof['device_ms'] / 1e3 / wall:.3f} of the unprofiled wall "
        f"{wall:.4f} s")
    report["var_slab_f64"].update(sharded_fcg_device_ms=prof["device_ms"], sharded_fcg_wall_s=wall)
    st = sol.stats
    u = op_s.gather(sol.displacements).cpu().numpy()
    reac = op_s.gather(sol.reactions).cpu().numpy()
    Ku, rel_host = host_check(curv_ref["nodes"], curv_ref["elements"], curv_ref["mat"], curv_ref["fixed"],
                              curv_ref["loads"], u)
    reac_err = float(np.abs(reac - Ku).max() / np.abs(Ku).max())
    du = float(np.abs(u - curv_ref["u"]).max() / np.abs(curv_ref["u"]).max())
    say(f"    {scene.n_dof} DOF, {op_s.z_local} planes a shard ({SHARDS * op_s.z_local - op_s.z_real} padded), "
        f"sharded levels {[lv.w[0].shape[3:] for lv in mg_s.levels]}, replicated "
        f"{[lv.dims for lv in mg_s.rest.levels]}; build {t_build:.3f} s")
    per_shard = ", ".join(f"{b / 1e9:.3f}" for b in mem["per_shard"])
    say(f"    memory: the whole fine fields {whole_w / 1e9:.3f} GB (f64 operator) and {whole_w0 / 1e9:.3f} GB "
        f"(f32 level 0); the build added {added / 1e9:.3f} GB; a shard keeps {per_shard} GB of the fine level, its "
        f"largest tensor {mem['largest'] / 1e9:.3f} GB; with the caller's whole fields dropped the decomposition "
        f"holds {held / 1e9:.3f} GB")
    say(f"    {st.iterations} iterations ([6]: {curv_ref['iterations']}) in {wall:.3f} s, the unsharded FCG loop "
        f"{one_iters} in {wall1:.3f} s; host f64 true residual {rel_host:.3e}; reactions vs host K u "
        f"{reac_err:.3e}; displacements vs [6] {du:.3e} of max|u|; launches K4-slab {counts['var_slab_f32']}, "
        f"K5-slab {counts['var_slab_f64']}, K4 {counts['var_f32']}, K5 {counts['var_f64']}, K1/K2 "
        f"{counts['f32'] + counts['f64']}")
    require({"converged": st.converged,
             "iterations within 1 of [6]": abs(st.iterations - curv_ref["iterations"]) <= 1,
             "host true residual <= 1e-8": rel_host <= 1e-8,
             "reactions = K u (1e-10)": reac_err <= 1e-10,
             "displacements within 10 tol of [6]": du <= 1e-7,
             "K4-slab launched": counts["var_slab_f32"] > 0,
             "K5-slab launched on every shard of every apply": counts["var_slab_f64"] >= SHARDS * (st.iterations + 1),
             "K1/K2 not launched": counts["f32"] == 0 and counts["f64"] == 0,
             "a shard's largest tensor is its slab of the f64 field": op_s.z_local < op_s.z_real
             and mem["largest"] == whole_w // op_s.z_real * op_s.z_local}, "shard_curvilinear")
    slab_launches = {k: counts[k] for k in VAR_SLAB_KEYS}
    report["var_slab_f32"].update(shard_bytes=mem["per_shard"][0], largest_shard_tensor_bytes=mem["largest"],
                                  build_added_bytes=added)
    del op_s, mg_s, sol

    say("  [18.6] shard_extruded on [17]'s tube through solve_extruded")
    tube, _, a = scenes.tube(*TUBE, device=DEV)
    det = infer_extruded(tube)
    op, pc = ftt.build_extruded(tube, det)
    presc = tube.prescribed_or_zero(torch.float64)
    one, wall1 = timed(lambda: solve_operator_fpcg(op, tube.loads, presc, pc, tol=1e-8))
    op_s, pc_s, _ = shard_extruded(op, pc, devices)
    sol, counts, wall = counted(counters, lambda: ftt.solve_extruded(tube, det, tol=1e-8, prebuilt=(op_s, pc_s)))
    st = sol.stats
    u, reac = sol.displacements.cpu().numpy(), sol.reactions.cpu().numpy()
    _, rel_host = host_check(a["nodes"], a["elements"], a["mat"], a["fixed"], a["loads"], u)
    ring = a["fixed"].any(axis=1)
    load_y = float(a["loads"][:, 1].sum())
    balance = abs(float(reac[ring, 1].sum()) + load_y) / abs(load_y)
    du = float(np.abs(u - one.displacements.cpu().numpy()).max() / np.abs(u).max())
    say(f"    {tube.n_dof} DOF, {op_s.z_local} layers a shard, sharded levels "
        f"{[lv.op.z_real for lv in pc_s.mg.levels]} layers: {st.iterations} iterations (the reference on its TPU: "
        f"{TUBE_REF_ITERS}) in {wall:.3f} s, the unsharded FCG loop {one.stats.iterations} in {wall1:.3f} s; host f64 "
        f"true residual {rel_host:.3e}; ring reactions balance {balance:.2e}; displacements vs unsharded {du:.3e}; "
        f"launches {sum(counts.values())}")
    require({"converged": st.converged,
             f"iterations within 1 of {TUBE_REF_ITERS}": abs(st.iterations - TUBE_REF_ITERS) <= 1,
             "host true residual <= 1e-8": rel_host <= 1e-8,
             "reactions balance the load (1e-6)": balance <= 1e-6,
             "displacements within 10 tol of the unsharded solve": du <= 1e-7,
             "no kernel launched": not any(counts.values())}, "shard_extruded")
    del op, pc, op_s, pc_s, sol, one

    say(f"  [18.7] python -m fea_tpu_torch.dryrun {SHARDS}")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "fea_tpu_torch.dryrun", str(SHARDS)], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    for line in proc.stdout.strip().splitlines():
        say(f"    {line}")
    modes = [line.split(" mode ")[1].split(":")[0] for line in proc.stdout.splitlines() if " mode " in line]
    say(f"    exit {proc.returncode} in {time.perf_counter() - t0:.1f} s" + (f"; stderr: {proc.stderr[-2000:]}"
                                                                            if proc.returncode else ""))
    require({"dryrun exits 0": proc.returncode == 0,
             "all seven modes (and 5b)": modes == ["1", "2", "3", "4", "5", "5b", "6", "7"]}, "dryrun")
    return report, slab_launches


# -- [19] the rest of the reference: refinement, the sanitizer, native, utils, demos -------

REFINE_VOXEL = (16, 16, 160)  # the flagship's geometry at 139,587 DOF, the size the reference documents refinement at
REFINE_TOL = 1e-8
# `refine_yardsticks.py --history`: fea_tpu's pcg_refined on the scenes of [19.1] and [19.2] at tol 1e-8 with
# the config's defaults (inner_tol 1e-3, inner_iters 2000, max_outer 25), JAX on the CPU in f64: outer steps,
# inner iterations in all, converged, the true relative residual recomputed through the f64 operator, and after
# each outer step the inner iterations in all and the outer residual
REFINE_JAX = {
    "voxel": dict(outers=12, inner=12175, converged=True, true_rel=9.966e-9,
                  inner_by_outer=[795, 1923, 3056, 4048, 5096, 6168, 7155, 8225, 9273, 10139, 11192, 12175],
                  residual_by_outer=[3.48e-1, 6.45e-2, 1.47e-2, 3.24e-3, 6.65e-4, 1.56e-4, 3.20e-5, 6.42e-6,
                                     1.29e-6, 2.58e-7, 6.41e-8, 9.97e-9]),
    "box": dict(outers=7, inner=3998, converged=True, true_rel=7.124e-9,
                inner_by_outer=[404, 990, 1581, 2160, 2789, 3370, 3998],
                residual_by_outer=[6.38e-2, 7.45e-3, 5.85e-4, 3.53e-5, 2.15e-6, 1.15e-7, 7.12e-9]),
    "stored": dict(outers=5, inner=4079, converged=True, true_rel=3.964e-11,
                   inner_by_outer=[846, 1636, 2430, 3274, 4079],
                   residual_by_outer=[1.65e-1, 4.53e-3, 7.33e-6, 1.06e-8, 1.48e-11]),
}


class CountedApply:
    """An operator whose masked applies are counted: a refined solve's
    outer steps are its f64 applies less the first. Given the inner
    operator's ``CountedApply`` as ``inner``, each apply also notes how
    many inner applies came before it, so that ``inner_by_outer()`` gives
    the inner iterations in all after each outer step (an inner PCG
    applies once more than it iterates)."""

    def __init__(self, op, inner=None):
        self.op, self.calls, self.inner, self.seen = op, 0, inner, []

    def __getattr__(self, name):
        return getattr(self.op, name)

    def apply(self, x):
        self.calls += 1
        if self.inner is not None:
            self.seen.append(self.inner.calls)
        return self.op.apply(x)

    def inner_by_outer(self) -> list:
        return [n - k for k, n in enumerate(self.seen) if k > 0]


def run_refined_case(ftt, counters, label: str, op_hi, scene, arrays, ref: dict, keys: tuple, plain) -> dict:
    """``solve_operator_refined(op_hi, op_hi.astype(f32), ...)`` at tol
    1e-8, the launches counted from 0: converged as the reference, the
    true residual by ``host_ku`` (<= 1e-8 where the reference reached it,
    else within 2x of the reference's), the outer steps within 1 of the
    reference's and the inner iterations in all within 10% of the
    reference's over the same outer steps (where a refined solve stops is
    a threshold, the outer residual against tol: two f32 roundings of one
    inner solve can stop an outer step apart), the f64 kernel (``keys[1]``)
    launched once an outer step and three times more (rhs, first residual,
    reactions), the f32 kernel (``keys[0]``) once an inner iteration and
    once more an outer step, no other kernel; the displacements within
    1e-6 relative of ``plain`` (a ``solve()`` of the same scene)."""
    lo_key, hi_key = keys
    lo = CountedApply(op_hi.astype(torch.float32))
    hi = CountedApply(op_hi, lo)
    presc = scene.prescribed_or_zero(torch.float64)
    sol, counts, wall = counted(counters, lambda: ftt.solve_operator_refined(hi, lo, scene.loads, presc,
                                                                             tol=REFINE_TOL))
    st, outers, by_outer = sol.stats, hi.calls - 1, hi.inner_by_outer()
    m = min(outers, ref["outers"])  # outer steps both took
    same_steps = (by_outer[m - 1], ref["inner_by_outer"][m - 1]) if m else (0, 0)
    nodes, elements, mat, fixed, loads = arrays
    u = sol.displacements.cpu().numpy()
    if u.shape != nodes.shape or not np.all(np.isfinite(u)):
        raise AssertionError(f"{label}: displacements of shape {u.shape}, finite {np.all(np.isfinite(u))}")
    _, rel_host = host_check(nodes, elements, mat, fixed, loads, u)
    u_plain = plain.displacements.cpu().numpy()
    du = float(np.abs(u - u_plain).max() / np.abs(u_plain).max())
    name = lambda k: KERNELS[k]["name"].split()[0]  # noqa: E731
    say(f"  {label} ({scene.n_dof} DOF): converged {st.converged}, {outers} outer steps, {st.iterations} inner "
        f"iterations in {wall:.3f} s ({st.iterations / wall:.0f} inner iterations a second); outer residual "
        f"{st.relative_residual:.3e}, host f64 true residual {rel_host:.3e} (host_ku); reference (JAX on the CPU): "
        f"{ref['outers']} outer steps, {ref['inner']} inner iterations, true residual {ref['true_rel']:.3e}")
    say(f"    inner iterations in all after each outer step: {by_outer}; reference {ref['inner_by_outer']}; "
        f"outer residuals {[f'{r:.2e}' for r in ref['residual_by_outer']]} (reference)")
    say(f"    launches: {name(hi_key)} f64 {counts[hi_key]}, {name(lo_key)} f32 {counts[lo_key]}, others "
        f"{sum(v for k, v in counts.items() if k not in keys)}; vs solve() ({plain.stats.iterations} iterations): "
        f"max|du| / max|u| = {du:.3e}")
    if ref["converged"] and ref["true_rel"] <= REFINE_TOL:
        held = {"converged": st.converged, "host true residual <= 1e-8": rel_host <= REFINE_TOL}
    else:  # what the reference reaches instead
        held = {"converged as the reference": st.converged == ref["converged"],
                "host true residual within 2x of the reference's": rel_host <= 2 * ref["true_rel"]}
    require({
        **held,
        f"inner iterations over the {m} outer steps both took within 10% of the reference's":
            abs(same_steps[0] - same_steps[1]) <= 0.1 * same_steps[1],
        "inner iterations in all = the last outer step's count": (by_outer[-1] if by_outer else 0) == st.iterations,
        "outer steps within 1 of the reference's": abs(outers - ref["outers"]) <= 1,
        f"{hi_key}: outer steps + 3 launches": counts[hi_key] == outers + 3,
        f"{lo_key}: inner iterations + outer steps launches": counts[lo_key] == st.iterations + outers,
        "no other kernel launched": all(v == 0 for k, v in counts.items() if k not in keys),
        "displacements within 1e-6 of solve()'s": du <= 1e-6,
    }, f"refined {label}")
    return dict(counts=counts, wall=wall, outers=outers, inner=st.iterations, rel_host=rel_host)


def run_refine_guard(op_hi, b) -> None:
    """[19.3] tests/test_guards.py's broken inner solves on the card: a NaN
    and a negated inner apply each end with converged False, a finite x
    and a residual no larger than ||b||."""
    from fea_tpu_torch.solvers.refine import pcg_refined

    b_norm = float(b.norm())
    broken = {"nan": lambda x: torch.full_like(x, float("nan")),
              "negated": lambda x: -op_hi.apply(x.to(torch.float64)).to(x.dtype)}
    checks = {}
    for label, apply_lo in broken.items():
        x, st = pcg_refined(op_hi.apply, apply_lo, b, tol=1e-9, max_outer=10, inner_tol=1e-2, inner_iters=50)
        finite = bool(torch.isfinite(x).all())
        say(f"  {label} inner apply: converged {st.converged}, x finite {finite}, residual {st.residual_norm:.6e} "
            f"against ||b|| {b_norm:.6e}")
        checks.update({f"{label}: not converged": not st.converged, f"{label}: x finite": finite,
                       f"{label}: residual <= ||b||": st.residual_norm <= b_norm * (1 + 1e-12)})
    require(checks, "refinement guard")


def run_debug_nans(ftt, cuda_stencil, flagship_ref: dict) -> None:
    """[19.4] ``solve(debug_nans=True)`` on the card: the flagship as
    without it (iterations, displacements within 10 tol, the host check),
    with both walls; the 49,179-DOF box with a NaN load raises
    ``FloatingPointError``; a K2 launch on an input that holds a NaN
    raises, naming the kernel (the dispatcher never sees a ctypes
    launch)."""
    from fea_tpu_torch import sanitize
    from fea_tpu_torch.ops.structured import stencil_apply_np

    scene, ke, dims = flagship_ref["scene"], flagship_ref["ke"], flagship_ref["dims"]
    plain, wall_plain = timed(lambda: ftt.solve(scene, tol=1e-8))
    ftt.clear_build_cache()  # so that the routing and the builds run under the sanitizer too
    checked, wall_checked = timed(lambda: ftt.solve(scene, tol=1e-8, debug_nans=True))
    u_p, u_c = plain.displacements.cpu().numpy(), checked.displacements.cpu().numpy()
    du = float(np.abs(u_c - u_p).max() / np.abs(u_p).max())
    fixed, loads = scene.fixed.cpu().numpy(), scene.loads.cpu().numpy()
    F = 1.0 - fixed.astype(np.float64)
    Z, Y, X = dims[2] + 1, dims[1] + 1, dims[0] + 1
    Ku = stencil_apply_np(ke, u_c.reshape(Z, Y, X, 3), dims).reshape(-1, 3)
    rel_host = float(np.linalg.norm(F * (loads - Ku)) / np.linalg.norm(F * loads))
    say(f"  flagship ({scene.n_dof} DOF): solve() {plain.stats.iterations} iterations in {wall_plain:.3f} s; "
        f"solve(debug_nans=True) {checked.stats.iterations} iterations in {wall_checked:.3f} s; max|du| / max|u| "
        f"{du:.3e}; host f64 true residual {rel_host:.3e}")

    nodes, elements = ftt.mesh.box_hex_mesh(*EBE_BOX, 0.1, 0.1, EBE_LZ)
    fixed_b, loads_b, tip = scenes.cantilever_bcs(nodes, EBE_LZ)
    loads_b[np.nonzero(tip)[0][0], 1] = np.nan
    bad = ftt.make_scene(nodes, elements, fixed_b, loads_b, ftt.Material(E=10_000_000 * ftt.units.psi, nu=0.3),
                         dtype=torch.float64)
    try:
        ftt.solve(bad, tol=1e-8, debug_nans=True, on_nonconverged="ignore")
        raised_solve = None
    except FloatingPointError as exc:
        raised_solve = str(exc)
    g = torch.zeros((Z, Y, X, 3), dtype=torch.float64, device=DEV)
    g[Z // 2, Y // 2, X // 2, 1] = float("nan")
    try:
        with sanitize.debug_nans():
            cuda_stencil.stencil_apply(flagship_ref["op_hi"].weights, g)
        raised_kernel = None
    except FloatingPointError as exc:
        raised_kernel = str(exc)
    say(f"  {bad.n_dof}-DOF box with a NaN load, solve(debug_nans=True): raised {raised_solve!r}")
    say(f"  K2 on an input holding a NaN under the sanitizer: raised {raised_kernel!r}")
    require({
        "same iterations": checked.stats.iterations == plain.stats.iterations,
        "converged": checked.stats.converged,
        "displacements within 10 tol": du <= 10 * 1e-8,
        "host true residual <= 1e-8": rel_host <= 1e-8,
        "a NaN load raises FloatingPointError": raised_solve is not None,
        "the K2 launch raises, naming it": raised_kernel is not None and "fea_stencil_apply_f64" in raised_kernel,
        "the sanitizer is off again": not sanitize.active(),
    }, "debug_nans")


def run_native(ftt, flagship_ref: dict) -> None:
    """[19.5] ``fea_tpu_torch.native`` on the card's host: built, and its
    residual of [4]'s flagship solution within 1e-10 of ||b|| of
    ``host_ku``'s (two exact f64 sums in another order: they differ by
    their rounding, ~1e-12 of ||b||), with the time of each."""
    from fea_tpu_torch import native

    (ok, t_build) = timed(native.available)
    scene, ke, dims, u = flagship_ref["scene"], flagship_ref["ke"], flagship_ref["dims"], flagship_ref["u"]
    nodes, elements = scene.host_nodes, scene.host_elements
    fixed, loads = scene.fixed.cpu().numpy(), scene.loads.cpu().numpy()
    F = 1.0 - fixed.astype(np.float64)
    b_norm = float(np.linalg.norm(F * loads))
    say(f"  native.available(): {ok} ({t_build:.2f} s, the g++ build included)")
    require({"native library available": ok}, "native")
    t0 = time.perf_counter()
    _, rn, _ = native.stencil_residual_host(ke, u, loads, F, dims)
    t_native = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, rel_ku = host_check(nodes, elements, scene.material, fixed, loads, u)
    t_ku = time.perf_counter() - t0
    rel_native = rn / b_norm
    say(f"  flagship solution of [4]: native residual {rel_native:.6e} in {t_native:.3f} s, host_ku {rel_ku:.6e} "
        f"in {t_ku:.3f} s; difference {abs(rel_native - rel_ku):.3e} of ||b||")
    require({"within 1e-10 of ||b||": abs(rel_native - rel_ku) <= 1e-10, "<= 1e-8": rel_native <= 1e-8}, "native")


def run_utils(ftt, flagship_ref: dict) -> None:
    """[19.6] ``utils`` on the card: a Timer around a warm flagship
    ``solve()``, the record of that solve, and a ``trace`` whose Chrome
    trace holds K2's ``__global__`` function as a CUDA kernel event."""
    import tempfile

    scene = flagship_ref["scene"]
    with ftt.utils.Timer() as timer:
        sol = timer.set_result(ftt.solve(scene, tol=1e-8))
    rec = ftt.utils.record_solve(scene, sol.stats, timer.elapsed, method="fpcg-multigrid")
    say(f"  Timer around a warm flagship solve(): {timer.elapsed:.4f} s; record {rec.to_json()}")
    op_hi = flagship_ref["op_hi"]
    x = torch.ones_like(op_hi.free)
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        with ftt.utils.trace(d):  # a warm flagship solve (its certification and reactions launch K2), 3 applies
            ftt.solve(scene, tol=1e-8)
            for _ in range(3):
                op_hi.apply(x)
            torch.cuda.synchronize()
        (path,) = Path(d).iterdir()
        events = json.loads(path.read_text())["traceEvents"]
        size = path.stat().st_size
    cats = {}
    for e in events:
        cats[e.get("cat")] = cats.get(e.get("cat"), 0) + 1
    # K2 is stencil27_kernel<double, ...> (its name demangled, or mangled: stencil27_kernelIdLb...)
    k2 = [e for e in events if e.get("cat") == "kernel" and "stencil27_kernel" in e.get("name", "")
          and ("stencil27_kernel<double" in e["name"] or "stencil27_kernelId" in e["name"])]
    say(f"  trace: {path.name}, {size} bytes, {len(events)} events by category {cats}; {len(k2)} CUDA kernel "
        f"events of K2, named {sorted({e['name'][:90] for e in k2})}")
    require({
        "record: backend cuda": rec.backend == "cuda",
        "record: n_dof, n_elements, iterations": (rec.n_dof, rec.n_elements, rec.iterations)
        == (scene.n_dof, scene.n_elements, sol.stats.iterations),
        "record: in records": ftt.utils.records[-1] is rec,
        "timer > 0": timer.elapsed > 0,
        "trace holds K2's kernel": len(k2) >= 1,
    }, "utils")


# What each demo prints on the CPU (python -m fea_tpu_torch.examples.<name> --device cpu), held on the card:
# a printed number's pattern and (the CPU's value, relative tolerance), or (None, bound) for "at most".
DEMO_ANCHORS = {
    "cubebeam": [(r"max \|u\| = (\S+)", 3.0504e-4, 1e-4)],
    "euler_bernoulli": [(r"midspan deflection: (\S+)", 1.240079365e-05, 1e-9), (r"relative error: (\S+)", None, 1e-10)],
    "truss": [(r"newton iterations: (\d+)", 4, 0.0), (r"residual: (\S+)", None, 1e-12),
              (r"nonlinear apex displacement: \[\s*(\S+)", -0.01355685, 1e-6)],
    "single_element": [(r"free nodes = (\S+)", None, 1e-9)],
    "tube": [(r'"n_dof": (\d+)', 7800, 0.0), (r'"relative_residual": ([^,]+),', None, 1e-8),
             (r"\s(\S+)\s+\S+\]\]\s*$", -0.0235, 1e-3)],
    "lshape": [(r"max \|u\| = (\S+) m", 1.0418e-06, 1e-4), (r"max relative error (\S+)", None, 1e-7)],
    "sweep": [(r"0\.50 x\s+->\s+(\S+)", 3.572309e-05, 1e-6), (r"case 0: tip\s+(\S+)", 4.490205e-05, 1e-6),
              (r"linearity check: max deviation (\S+)", None, 1e-8)],
    "unstructured": [(r"scalar Jacobi :\s+(\d+)", 424, 0.05), (r"block-Jacobi\s+:\s+(\d+)", 403, 0.05),
                     (r"\ntwo-level\s+:\s+(\d+)", 44, 0.025), (r"cheb two-level:\s+(\d+)", 19, 0.06),
                     (r"vs dense solve: max relative error (\S+)", None, 1e-6)],
}


def run_demos(ftt, counters) -> None:
    """[19.7] Each demo's ``main()`` in this process, on the card, its
    printed anchors against the CPU's (``DEMO_ANCHORS``)."""
    import contextlib
    import importlib
    import io
    import re

    from fea_tpu_torch.examples import NAMES

    checks = {}
    for name in NAMES:
        mod = importlib.import_module(f"fea_tpu_torch.examples.{name}")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            _, counts, wall = counted(counters, lambda: mod.main([]))
        out = buf.getvalue()
        got = []
        for pattern, want, tol in DEMO_ANCHORS[name]:
            m = re.search(pattern, out)
            v = float(m.group(1)) if m else float("nan")
            ok = m is not None and (v <= tol if want is None else abs(v - want) <= tol * abs(want))
            checks[f"{name}: {pattern} {'<=' if want is None else '~'} {tol if want is None else want}"] = ok
            got.append(f"{v:g}")
        launched = ", ".join(f"{k} {v}" for k, v in counts.items() if v)
        say(f"  {name}: {wall:.2f} s, anchors {', '.join(got)}; launches: {launched or 'none'}")
    require(checks, "demos")


def run_rest(ftt, counters, cuda_stencil, flagship_ref: dict) -> dict:
    """Phase [19]; returns each kernel key's launches in its refined solve
    (K1/K2 on the voxel scene, K7 on the box, K6 on its distorted twin)."""
    from fea_tpu_torch.operator import build_operator
    from fea_tpu_torch.ops.structured import build_structured_operator

    mat = ftt.Material(E=10_000_000 * ftt.units.psi, nu=0.3)
    say(f"  [19.1] refinement on the {REFINE_VOXEL} voxel cantilever: K2 outside, K1 inside, Jacobi")
    scene, (nodes, elements, fixed, loads, _, _) = flagship_scene(REFINE_VOXEL)
    op_hi = build_structured_operator(scene, REFINE_VOXEL, dtype=torch.float64)
    plain = ftt.solve(scene, tol=REFINE_TOL)
    voxel = run_refined_case(ftt, counters, "voxel", op_hi, scene, (nodes, elements, mat, fixed, loads),
                             REFINE_JAX["voxel"], ("f32", "f64"), plain)
    launches = {k: voxel["counts"][k] for k in ("f32", "f64")}

    say(f"  [19.2] refinement on the {EBE_BOX} box (K7) and its distorted twin's stored operator (K6)")
    box_nodes, box_el = ftt.mesh.box_hex_mesh(*EBE_BOX, 0.1, 0.1, EBE_LZ)
    dist_nodes, _, _ = scenes.distorted_arrays(EBE_BOX, EBE_LZ)
    for label, nd, kind, keys, jax_iters in (("box", box_nodes, "uniform", ("uniform_f32", "uniform_f64"),
                                              EBE_JAX_ITERS),
                                             ("stored", dist_nodes, "stored", ("stored_f32", "stored_f64"),
                                              EBE_DISTORTED_JAX_ITERS)):
        fx, ld, _ = scenes.cantilever_bcs(nd, EBE_LZ)
        sc = ftt.make_scene(nd, box_el, fx, ld, mat, dtype=torch.float64)
        op = build_operator(sc, dtype=torch.float64)
        if kind == "stored":
            op = dataclasses.replace(op, kind="stored", ke=op.element_matrices().contiguous(), geom=None,
                                     material=None)
        plain_e = ftt.solve(sc, tol=REFINE_TOL)
        say(f"    {label}: solve() by Jacobi PCG, {plain_e.stats.iterations} iterations (JAX {jax_iters})")
        res = run_refined_case(ftt, counters, label, op, sc, (nd, box_el, mat, fx, ld), REFINE_JAX[label], keys,
                               plain_e)
        launches.update({k: res["counts"][k] for k in keys})
        del op, sc

    say("  [19.3] the outer loop's guard on the card (the voxel scene's f64 operator)")
    run_refine_guard(op_hi, op_hi.rhs(scene.loads, scene.prescribed_or_zero(torch.float64)))
    del op_hi, scene, plain

    say("  [19.4] debug_nans on the card")
    run_debug_nans(ftt, cuda_stencil, flagship_ref)
    say("  [19.5] native on the card's host")
    run_native(ftt, flagship_ref)
    say("  [19.6] utils")
    run_utils(ftt, flagship_ref)
    say("  [19.7] the demos, in this process, on the card")
    run_demos(ftt, counters)
    return launches


# bench_torch.py's run in [20]: its budgets keep every child it starts
# inside this script's time
BENCH_ARGS = ["--repeats", "2", "--budget-s", "800", "--family-timeout-s", "240"]
BENCH_TIMEOUT_S = 850
BENCH_REF_ITERS = 13  # BENCH_r04's flagship (the JAX package on its TPU): a count, not a time
# n_dof of each family as the JAX tools build it (bench.py:541-597,
# tools/many_bench.py, tools/unstructured_bench.py)
BENCH_FAMILY_DOF = {"extruded": 591_360, "curvilinear": 181_875, "canonicalized": 181_875, "arbitrary": 554_115,
                    "many": 1_048_707, "unstructured": 181_875, "curvilinear_812k": 811_923,
                    "unstructured_812k": 811_923, "capacity_8m": 8_124_675}


def run_child(args: list, timeout_s: float, keep=("Error",)) -> tuple[int, dict, str]:
    """``python <args>`` from the repository root in a child process (its
    own process group, killed whole on a timeout): (return code, its last
    stdout line as JSON or {}, that line). Its stderr lines holding one of
    ``keep`` are printed here."""
    torch.cuda.empty_cache()
    cmd = [sys.executable, *args]
    say(f"  {' '.join(cmd[1:])}")
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
    wall = time.perf_counter() - t0
    for line in err.splitlines():
        if any(w in line for w in keep):
            say("  " + line)
    lines = out.strip().splitlines()
    last = lines[-1] if lines else ""
    say(f"  rc {proc.returncode} after {wall:.1f} s; its last line ({len(last.encode())} bytes):")
    say(last)
    try:
        rec = json.loads(last)
    except json.JSONDecodeError:
        rec = {}
    return proc.returncode, rec if isinstance(rec, dict) else {}, last


def run_bench() -> None:
    """Phase [20]: bench_torch.py in a child process, gated on its final
    line."""
    rc, rec, last = run_child([str(ROOT / "bench_torch.py"), *BENCH_ARGS], BENCH_TIMEOUT_S,
                              keep=("warm-up done", "repeat ", "family ", "FAILED", "Error"))
    fam = rec.get("families") or {}
    checks = {
        "rc 0": rc == 0,
        "final line <= 1,500 bytes": 0 < len(last.encode()) <= 1500,
        "metric assemble_solve_dof_per_s": rec.get("metric") == "assemble_solve_dof_per_s",
        "flagship converged": rec.get("converged") is True,
        "flagship n_dof 1,048,707": rec.get("n_dof") == 1_048_707,
        "flagship host true residual <= 1e-8": (rec.get("relative_residual") or 1.0) <= 1e-8,
        f"flagship tip ratio in {TIP_BAND}": TIP_BAND[0] < (rec.get("tip_ratio") or 0.0) < TIP_BAND[1],
        f"flagship iterations <= {BENCH_REF_ITERS}": (rec.get("iterations") or 10**9) <= BENCH_REF_ITERS,
        "numerics check <= 1e-12": (rec.get("numerics_check") or 1.0) <= 1e-12,
    }
    for name, n_dof in BENCH_FAMILY_DOF.items():
        entry = fam.get(name) or {}
        what = "every case converged" if name == "many" else "converged"
        checks[f"{name} {what} at {n_dof:,} DOF"] = entry.get("converged") is True and entry.get("n_dof") == n_dof
    require(checks, "bench_torch.py")


# [21]: the measurement tools of fea_tpu_torch.bench, each a child process
# with its own timeout: (name, arguments, timeout s)
TOOLS = (
    ("spmv", ["-m", "fea_tpu_torch.bench.spmv"], 300),
    ("microbench", ["-m", "fea_tpu_torch.bench.microbench"], 240),
    ("profile", ["-m", "fea_tpu_torch.bench.profile"], 240),
    # 8x8x320 voxels, 78,003 DOF: over 50,000, so solve() takes the voxel
    # route (K1/K2), and the slender bar keeps SuperLU's fill small
    ("scipy_compare", ["-m", "fea_tpu_torch.bench.scipy_compare", "--nx", "8", "--ny", "8", "--nz", "320"], 300),
    ("prewarm", ["-m", "fea_tpu_torch.bench.prewarm"], 300),
)
SCIPY_DOF = 78_003
SPMV_MODES = ("structured_stencil", "uniform_plain", "uniform_kernel", "matfree", "stored_plain", "stored_kernel",
              "csr")
MICROBENCH_KEYS = ("f64_axpy_ms", "f32_axpy_ms", "f64_dot_ms", "f64_apply_flat_ms", "f32_level_apply_ms", "vcycle_ms")
PROFILE_PIECES = ("dd_masked_apply", "f32_level_apply", "vcycle", "fcg_vector_algebra")


def finite(rec: dict, keys) -> bool:
    return all(isinstance(rec.get(k), (int, float)) and np.isfinite(rec[k]) for k in keys)


def run_tools() -> dict:
    """Phase [21]: every tool of ``TOOLS`` in a child process, each gated
    on rc 0, its keys and its checks. Returns each kernel's launches by
    tool, as each child counted them over its run."""
    launches: dict = {}
    for name, args, timeout_s in TOOLS:
        say(f"  [21] {name}")
        rc, rec, _ = run_child(args, timeout_s)
        flagship = rec.get("n_dof") == 1_048_707
        counts = rec.get("launches") or {}
        k1k2 = counts.get("f32", 0) > 0 and counts.get("f64", 0) > 0
        if name == "spmv":
            checks = {
                "n_dof 1,048,707, stored_n_elements 40,960": flagship and rec.get("stored_n_elements") == 40_960,
                "every mode within 2e-5 of the f64 plain apply": rec.get("checks_passed") is True,
                "every mode timed, host pace and graph": finite(rec, [f"{m}_{t}ms" for m in SPMV_MODES
                                                                    for t in ("", "graph_")]),
                "stencil_hbm_gbps_min and its share": finite(rec, ("stencil_hbm_gbps_min", "stencil_hbm_share")),
                "K1, K6 and K7 launched (f32)": all(counts.get(k, 0) > 0 for k in ("f32", "stored_f32",
                                                                                    "uniform_f32")),
            }
        elif name == "microbench":
            checks = {"n_dof 1,048,707": flagship, "the kept keys finite": finite(rec, MICROBENCH_KEYS),
                      "timed by graph replay": rec.get("timing") == "graph replay of k calls",
                      "K1 and K2 launched": k1k2}
        elif name == "profile":
            checks = {
                "n_dof 1,048,707": flagship,
                "every piece timed, host and graph": finite(rec, [f"{p}_{t}ms" for p in PROFILE_PIECES
                                                                  for t in ("", "graph_")]),
                "the staged solve converged, host residual <= 1e-8": rec.get("fpcg_converged") is True
                and (rec.get("fpcg_relative_residual") or 1.0) <= 1e-8,
                f"at most {BENCH_REF_ITERS} iterations": (rec.get("fpcg_iterations") or 10**9) <= BENCH_REF_ITERS,
                "K1 and K2 launched": k1k2,
            }
        elif name == "scipy_compare":
            checks = {
                f"n_dof {SCIPY_DOF:,}": rec.get("n_dof") == SCIPY_DOF,
                "displacements within 1e-8 of SuperLU's": (rec.get("displacement_rel_diff") or 1.0) <= 1e-8,
                "K1 and K2 launched": k1k2,
                "host residual no worse than SuperLU's": (rec.get("relative_residual") or 1.0)
                <= (rec.get("scipy_relative_residual") or 0.0),
            }
        else:
            bench = rec.get("bench") or {}
            checks = {"kernels built": finite(rec, ("build_s",)),
                      "the flagship converged": bench.get("converged") is True and bench.get("n_dof") == 1_048_707}
        checks["rc 0"] = rc == 0
        require(checks, name)
        for key, n in counts.items():
            if n:
                launches.setdefault(key, {})[name] = n
    return launches


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card")
    import fea_tpu_torch as ftt
    from fea_tpu_torch.ops import cuda_apply, cuda_stencil, cuda_varstencil, nvcc

    phase("[1] device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    say(smi)
    version = subprocess.run([nvcc.find_nvcc(), "--version"], capture_output=True, text=True,
                             check=True, timeout=60).stdout.strip().splitlines()[-1]
    say(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, nvcc: {version}")
    say(f"  device 0: {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")

    phase("[2] build")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=3 + len(PTXAS_SOURCES)) as pool:  # one nvcc each, all at once
        builds = [pool.submit(m.build) for m in (cuda_stencil, cuda_varstencil, cuda_apply)]
        logs = {name: pool.submit(ptxas_log, nvcc, name) for name in PTXAS_SOURCES}
        for fut in builds:
            fut.result()
        say(f"  K1/K2 with K1-halo/K3, K4/K5 and K6/K7 built in {time.perf_counter() - t0:.2f} s")
        ptxas_report({name: fut.result() for name, fut in logs.items()})

    phase("[3] K1/K2 vs plain version (f64) on the card")
    report = check_kernels(ftt, cuda_stencil)

    phase("[4] voxel slice: flagship cantilever through fea_tpu_torch.solve")
    launches, flagship_ref = run_slice(ftt, cuda_stencil, cuda_varstencil)

    phase("[5] K4/K5 vs plain version (f64) on the card")
    report.update(check_var_kernels(ftt, cuda_varstencil))

    phase("[6] curvilinear slice: the 811,923-DOF distorted cantilever through fea_tpu_torch.solve")
    launches_curv, curv_ref = run_curvilinear(ftt, cuda_stencil, cuda_varstencil)
    launches.update({k: launches_curv[k] for k in VAR_KEYS})

    phase("[7] canonicalized slice: the renumbered 181,875-DOF scene through fea_tpu_torch.solve")
    run_canonical(ftt, cuda_stencil, cuda_varstencil)

    phase("[8] K6/K7 vs plain version (f64) on the card")
    report.update(check_apply_kernels(cuda_apply))

    phase("[9] element-by-element slice through fea_tpu_torch.solve")
    counters = (cuda_stencil.LAUNCHES, cuda_varstencil.LAUNCHES, cuda_apply.LAUNCHES)
    launches.update(run_ebe(ftt, counters))

    phase("[10] K1-halo/K3 vs plain version (f64) on the card")
    report.update(check_slab_kernels(ftt, cuda_stencil))

    phase(f"[11] capacity: the {CAPACITY} cantilever through fea_tpu_torch.solve on one card")
    capacity_ref = run_capacity(ftt, counters)

    phase(f"[12] z-sharded solve: build_zsharded_solver over {SHARDS} shards on the one card")
    sharded = run_sharded(ftt, counters, {"flagship": flagship_ref, "capacity": capacity_ref})
    launches.update({k: sharded[k] for k in SLAB_KEYS})
    del capacity_ref

    phase(f"[13] solve_many: {MANY_CASES} load cases on the flagship grid")
    run_many(ftt, counters)

    phase(f"[14] embedded slice: the {ARBITRARY} L-domain (554,115 DOF) through fea_tpu_torch.solve")
    embedded = run_embedded(ftt, counters)
    for key in VAR_KEYS:  # the K4/K5 entries carry the embedded route beside the curvilinear one
        got = embedded["report"][key]
        report[key]["max_abs_err"] = max(report[key]["max_abs_err"], got["max_abs_err"])
        report[key].update({f"embedded_{k}": v for k, v in got.items() if k != "max_abs_err"})
        report[key]["embedded_launches"] = embedded["launches"][key]

    phase("[15] AMG slice: the same L-domain with FEA_TPU_NO_EMBED set")
    no_kernel = run_amg(ftt, counters)

    phase(f"[16] two-level slice: the {TWO_LEVEL_L} L-domain with FEA_TPU_NO_EMBED and FEA_TPU_NO_AMG set")
    no_kernel.update(run_two_level(ftt, counters))

    phase(f"[17] extruded slice: the {TUBE[0]}-segment x {TUBE[1]}-layer tube (591,360 DOF) through "
          "fea_tpu_torch.solve")
    no_kernel.update(run_extruded(ftt, counters))

    phase(f"[18] sharded modes: fea_tpu_torch.parallel over {SHARDS} shards on the one card")
    slab_report, slab_launches = run_sharded_modes(ftt, counters, flagship_ref, curv_ref, cuda_varstencil)
    report.update(slab_report)
    launches.update(slab_launches)
    del curv_ref
    var_summary(report, launches)

    phase("[19] the rest: mixed-precision refinement (K1/K2, K7, K6), debug_nans, native, utils and the demos")
    for key, n in run_rest(ftt, counters, cuda_stencil, flagship_ref).items():
        report[key]["refined_launches"] = n
    del flagship_ref

    phase("[20] the benchmark: bench_torch.py with its families, in a child process")
    run_bench()

    phase("[21] the measurement tools: spmv, microbench, profile, scipy_compare and prewarm, each a child process")
    for key, by_tool in run_tools().items():
        report[key]["tools_launches"] = by_tool

    phase("[22] the JSON lines")
    say(json.dumps({"kernels": [
        dict(name=spec["name"], route="cuda", source=spec["source"], replaces=spec["replaces"],
             launches=launches[key], **report[key])
        for key, spec in KERNELS.items()
    ]}))
    say(json.dumps({"no_tpu_kernel": no_kernel}))
    say(smi)
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
