"""fea_tpu_torch: the fea-tpu solver in PyTorch, with CUDA kernels for an
NVIDIA Hopper card (sm_90a).

A port of the JAX package ``fea_tpu`` that takes the same scene in and
gives the same solution out. It imports torch and NumPy, never JAX. This
version serves:

  * the large hex8 routes: the voxel box (K1/K2), the curvilinear grid
    (K4/K5), the canonicalized (renumbered) grid, a box subset embedded
    in its box (K4/K5), and any other topology by block-CSR
    smoothed-aggregation AMG, else the two-level preconditioner
    (``build_two_level``, ``build_two_level_cheb``), and an extruded mesh
    (a section extruded along z: ``build_extruded``, ``solve_extruded``);
  * ``solve_many``: many load cases on one mesh of any of those routes
    but AMG (the arbitrary branch takes the two-level preconditioner);
  * the voxel box z-sharded over several devices
    (``parallel.build_zsharded_solver``, K3 and K1's halo form), which
    ``solve`` takes under ``SolverConfig(sharded=True)`` when more than
    one card is visible;
  * ``parallel``: the reference's decompositions over a list of devices
    (one card may repeat): element shards (``shard_operator``), sharded
    sweeps, and z-slab shards of the voxel, curvilinear (K4/K5's slab
    form) and extruded pipelines; ``python -m fea_tpu_torch.dryrun N``
    runs the reference's seven sharding modes;
  * the element-by-element operator (``build_operator``, K6/K7): an
    explicit ``method="cg"`` (Jacobi, block-Jacobi or none) or
    ``"dense"``, a prebuilt ``operator=``, hex8 scenes under 50,000 DOF,
    Euler-Bernoulli beams and 2D/3D bars, and ``solve_nonlinear`` for
    bars;
  * ``solve_operator_refined``: mixed-precision refinement, an f64 outer
    loop around an f32 Jacobi PCG, on a structured operator (K2 outside,
    K1 inside) or an element operator (K7, or K6 when stored);
  * ``solve(debug_nans=True)``: the NaN sanitizer (``sanitize.py``);
  * ``utils`` (solve records, timers, profiler traces, the program's
    spans and counters, the build directory), ``native`` (the host's
    exact f64 check in C++), ``viz`` (matplotlib, and pyvista where
    installed), ``Policy`` / ``default_policy``, and the demos,
    ``python -m fea_tpu_torch.examples.<name>``;
  * ``bench``: the family benches that ``bench_torch.py`` (the
    repository's benchmark) runs, ``python -m fea_tpu_torch.bench.<name>``.

Every entry point of the reference's ``fea_tpu`` has its counterpart
here. Entry points run on the CUDA card unless the caller passes
``device="cpu"``.

Quick start::

    import fea_tpu_torch as ftt

    nodes, elements = ftt.mesh.box_hex_mesh(32, 32, 320, 0.1, 0.1, 1.0)
    fixed = ftt.fix_where(nodes, lambda p: p[:, 2] == 0.0, dofs_per_node=3)
    loads = ...                                   # (N, 3) nodal forces
    scene = ftt.make_scene(nodes, elements, fixed, loads,
                           ftt.Material(E=10e6 * ftt.units.psi, nu=0.3),
                           dtype=torch.float64)          # on the card
    sol = ftt.solve(scene, tol=1e-8)
    sol.displacements, sol.reactions, sol.stats
"""
from __future__ import annotations

from . import assembly, mesh, native, ops, post, utils, viz
from .config import DEFAULT_CONFIG, SolverConfig
from .dtypes import Policy, default_policy
from .materials import Material, units
from .operator import StiffnessOperator, build_operator
from .ops.twolevel import TwoLevelChebPrecond, TwoLevelPrecond, build_two_level, build_two_level_cheb
from .scene import FAMILIES, ElementFamily, Scene, fix_where, make_scene, scene_from_numpy
from .solve import (
    Solution,
    build_curvilinear,
    build_extruded,
    clear_build_cache,
    solve,
    solve_curvilinear,
    solve_displacements,
    solve_extruded,
    solve_many,
    solve_nonlinear,
    solve_operator,
    solve_operator_fpcg,
    solve_operator_refined,
)
from .solvers import SolveStats, dense_solve, newton_krylov, pcg
from . import parallel  # after .solve, which parallel.halo imports

__version__ = "0.1.0"

__all__ = [
    "DEFAULT_CONFIG",
    "ElementFamily",
    "FAMILIES",
    "Material",
    "Policy",
    "Scene",
    "Solution",
    "SolveStats",
    "SolverConfig",
    "StiffnessOperator",
    "TwoLevelChebPrecond",
    "TwoLevelPrecond",
    "assembly",
    "build_curvilinear",
    "build_extruded",
    "build_operator",
    "build_two_level",
    "build_two_level_cheb",
    "clear_build_cache",
    "default_policy",
    "dense_solve",
    "fix_where",
    "make_scene",
    "mesh",
    "native",
    "newton_krylov",
    "ops",
    "parallel",
    "pcg",
    "post",
    "scene_from_numpy",
    "solve",
    "solve_curvilinear",
    "solve_displacements",
    "solve_extruded",
    "solve_many",
    "solve_nonlinear",
    "solve_operator",
    "solve_operator_fpcg",
    "solve_operator_refined",
    "units",
    "utils",
    "viz",
]
