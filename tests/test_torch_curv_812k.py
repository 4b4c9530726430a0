"""The ``curv_812k`` configuration through ``fea_tpu_torch.solve()``, at
tiny sizes on the CPU.

The scene is the benchmark's own: its generator (``benchmark/meshes/box.py``
at the configuration's distortion of a quarter cell), its material and
tolerance, and the loads of both of its traffic mixes, drawn by the
benchmark's traffic generator from a seed: ``loadcases`` (one mesh, the
source's load cases on the tip) and ``fresh`` (a new distorted mesh every
request, the configuration's own tip load). Each answer is held against
the benchmark's plain f64 hex8 K (``benchmark/reference/hex8.py``),
assembled densely here and solved directly.

Sizes: 4x4x16 (1,275 DOF; the curvilinear route's hierarchy is its dense
coarsest level alone) and 8x8x16 (4,131 DOF; one Galerkin level below the
fine one, so RAP and the V-cycle run). The large-grid routes are let in at
these sizes, as the port's other route tests do.
"""
import dataclasses
import json
import sys

import numpy as np
import pytest
import torch

import fea_tpu_torch as ftt
from benchmark.harness import load, spec
from benchmark.meshes import box
from benchmark.reference import hex8
from benchmark.tests import tiny
from torch_pin import one_torch_thread  # noqa: F401

SOLVE = sys.modules["fea_tpu_torch.solve"]
CACHE = sys.modules["fea_tpu_torch.solve.cache"]
SEEDS = (2**31 + 11, 3_900_020_001, 7)


@pytest.fixture
def large_routes_for_small_scenes(monkeypatch):
    monkeypatch.setattr(SOLVE, "_STRUCTURED_MIN_DOF", 0)
    monkeypatch.setattr(CACHE, "_BUILD_CACHE", {})


def _config(cells):
    bench = spec.Bench(tiny.REPO)
    cfg = json.loads((tiny.REPO / "benchmark/configs/curv_812k.json").read_text())
    return bench, cfg | {"cells": cells, "dof": tiny.dof(cells)}


def _dense_k(nodes, elements, E, nu):
    """The reference's K, assembled densely."""
    n = 3 * nodes.shape[0]
    K = np.zeros((n, n))
    ke = hex8.element_stiffness(torch.as_tensor(nodes)[torch.as_tensor(elements)], E, nu).numpy()
    for e, el in enumerate(elements):
        dofs = (3 * el[:, None] + np.arange(3)).ravel()
        K[np.ix_(dofs, dofs)] += ke[e]
    return K


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("mix", ["loadcases", "fresh"])
@pytest.mark.parametrize("cells", [[4, 4, 16], [8, 8, 16]], ids=["4x4x16", "8x8x16"])
def test_solve_matches_the_reference_k(cells, mix, seed, large_routes_for_small_scenes):
    bench, cfg = _config(cells)
    gen = load.Generator(cfg, bench.traffic(mix), box, seed)
    material = ftt.Material(E=cfg["E"], nu=cfg["nu"])
    scene = None
    for r in range(2):  # loadcases: the second request takes the cached build; fresh: a second mesh
        mesh = gen.mesh(r)
        f = gen.loads(r, mesh)[0]
        if scene is None or not gen.shared:
            scene = ftt.make_scene(mesh["nodes"], mesh["elements"], mesh["fixed"], f, material,
                                   dtype=torch.float64, device="cpu")
        else:  # the same mesh tensors with this request's loads, as the benchmark's caller sends them
            scene = dataclasses.replace(scene, loads=torch.as_tensor(f))
        sol = ftt.solve(scene, tol=cfg["tol"])
        assert sol.route == "fpcg-curvilinear-multigrid"
        assert sol.stats.converged and sol.stats.relative_residual <= cfg["tol"]

        K = _dense_k(mesh["nodes"], mesh["elements"], cfg["E"], cfg["nu"])
        free = ~mesh["fixed"].reshape(-1)
        want = np.zeros(K.shape[0])
        want[free] = np.linalg.solve(K[np.ix_(free, free)], f.reshape(-1)[free])
        u = sol.displacements.numpy().reshape(-1)
        ku = K @ u
        # the configuration's own limit: tol, plus 1e-10 for the rounding of
        # an f64 residual worked out from another assembly of K (the program's
        # figure and this one differ by 4e-12 or less at these sizes)
        res = np.linalg.norm(free * (f.reshape(-1) - ku)) / np.linalg.norm(free * f.reshape(-1))
        assert res <= cfg["limits"]["residual"]
        # the error of a solve certified at 1e-8 lies in the stiff modes,
        # which carry little of u: 1.3e-11 of max |u| or less measured here;
        # an answer in float32 (~1e-7) fails this
        assert np.abs(u - want).max() <= 1e-9 * np.abs(want).max()
        # the reactions are K u from the program's own f64 weights: the two
        # assemblies differ by rounding, raised by the cancellation in K u
        # (||K|| ||u|| / ||K u||); 2.6e-12 or less measured here
        assert np.linalg.norm(sol.reactions.numpy().reshape(-1) - ku) <= 1e-10 * np.linalg.norm(ku)
        assert np.abs(u[~free]).max() == 0.0
