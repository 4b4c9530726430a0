"""The ``voxel_8m`` configuration through ``fea_tpu_torch.solve()``, at a
tiny size on the CPU, its reader, and its residual limit's resolution at
full size on the card.

The configuration is the flagship ``voxel_1m`` at twice the resolution on
each axis: the same box, material, supports and tolerance, the same
generator (``benchmark/meshes/box.py``), and a residual limit widened to
what an f64 residual resolves at 8.1M. Here it is cut to 4x4x40
cells, the 1:1:10 aspect of its 64x64x640 (3,075 DOF: two levels, f32 over
f64, so K1's and K2's plain versions both run), and solved under the loads
of the ``loadcases`` mix, drawn by the benchmark's traffic generator from a
seed. Each answer is judged by the benchmark's own comparison
(``benchmark/reference/check.judge``) against the configuration's limits.
The large-grid routes are let in at this size, as the port's other route
tests do. The full mesh is built only by the card test, which runs there
with

    python -m pytest --noconftest -m cuda -s tests/test_torch_voxel_8m.py
"""
import dataclasses
import json
import sys

import numpy as np
import pytest
import torch

import fea_tpu_torch as ftt
from benchmark.harness import load, roofline, spec
from benchmark.harness.trace import Trace
from benchmark.meshes import box
from benchmark.reference import check, hex8
from benchmark.tests import tiny
from fea_tpu_torch import utils
from torch_pin import one_torch_thread  # noqa: F401

SOLVE = sys.modules["fea_tpu_torch.solve"]
CACHE = sys.modules["fea_tpu_torch.solve.cache"]
SEEDS = (2**31 + 11, 3_900_020_001, 7)
CELLS = [64, 64, 640]
TINY = [4, 4, 40]
ROUTE = "fpcg-multigrid"
READER = "f32_apply_roofline.voxel"
# the voxel route's readers that read a cached request; the route, build and capture readers read 0 there
SHARED = {"fcg_iterations", "f64_apply_roofline.voxel", "certify_ms_per_case", "certify_passes_per_case",
          "device_idle_share", "fcg_host_ms_per_case", "solve_self_ms_per_request", "fcg_device_ms_per_iteration"}
K1 = "void (anonymous namespace)::stencil27_kernel<float, true, false>(ConstWeights<float>, float const*)"
K2 = "void (anonymous namespace)::stencil27_kernel<double, true, false>(ConstWeights<double>, double const*)"


@pytest.fixture
def large_routes_for_small_scenes(monkeypatch):
    monkeypatch.setattr(SOLVE, "_STRUCTURED_MIN_DOF", 0)
    monkeypatch.setattr(CACHE, "_BUILD_CACHE", {})


def _config(cells=TINY):
    cfg = json.loads((tiny.REPO / "benchmark/configs/voxel_8m.json").read_text())
    return cfg | {"cells": cells, "dof": tiny.dof(cells)}


def test_the_configuration_is_the_flagships_at_twice_the_resolution():
    bench = spec.Bench(tiny.REPO)
    cfg, flagship = bench.config("voxel_8m"), bench.config("voxel_1m")
    entry = next(c for c in bench.data["configs"] if c["name"] == "voxel_8m")
    assert cfg["source"] == entry["source"] and cfg["reduced"] == entry["reduced"] == []
    assert cfg["dof"] == 3 * 65 * 65 * 641 == 8_124_675 == tiny.dof(cfg["cells"])
    assert cfg["cells"] == CELLS == [2 * n for n in flagship["cells"]]
    assert set(cfg) == set(flagship)
    differ = {k for k in cfg if cfg[k] != flagship[k]}
    assert differ == {"cells", "dof", "source", "about", "limits"}
    # the residual's limit is tol plus twice the widest gap between the program's own f64 residual and the
    # reference's measured at 8.1M (1.006e-9 on an H100; the card test below reads it): the flagship's tol plus
    # 1e-10 is finer than an f64 residual resolves there; the other two limits are every cell's
    assert cfg["limits"] == flagship["limits"] | {"residual": 1.21e-8}
    assert cfg["limits"]["residual"] >= cfg["tol"] + 2 * 1.006e-9
    assert cfg["E"] == 10e6 * ftt.units.psi and cfg["tol"] == 1e-8
    cell = bench.cell("voxel_8m.loadcases")
    assert cell["config"] == "voxel_8m" and cell["traffic"] == "loadcases" and cell["chips"] == 1


def test_the_cell_reports_the_voxel_routes_readers():
    """voxel_8m.loadcases reports K1's roofline and the shared voxel
    readers; K1's roofline reads the 1M voxel cells too."""
    bench = spec.Bench(tiny.REPO)
    assert {m["name"] for m in bench.metrics("per_layer", "voxel_8m.loadcases")} == SHARED | {READER}
    for cell in ("voxel_1m.batch8", "voxel_1m.loadcases"):
        assert READER in {m["name"] for m in bench.metrics("per_layer", cell)}


@pytest.mark.parametrize("seed", SEEDS)
def test_solve_is_judged_correct(seed, large_routes_for_small_scenes):
    cfg = _config()
    gen = load.Generator(cfg, spec.Bench(tiny.REPO).traffic("loadcases"), box, seed)
    mesh = gen.mesh(0)
    assert mesh["nodes"].size == cfg["dof"] and mesh["tip"].sum() == 5 * 5
    scene = ftt.make_scene(mesh["nodes"], mesh["elements"], mesh["fixed"], np.zeros_like(mesh["nodes"]),
                           ftt.Material(E=cfg["E"], nu=cfg["nu"]), dtype=torch.float64, device="cpu")
    for r in range(3):  # the first request builds, the later ones hit the route and voxel entries
        f = gen.loads(r, mesh)
        assert f[0][:, 2].max() == 0.0 and 50.0 / 25 <= f[0][:, 1].max() <= 200.0 / 25
        utils.reset()
        sol = ftt.solve(dataclasses.replace(scene, loads=torch.as_tensor(f[0])), tol=cfg["tol"])
        assert sol.route == ROUTE and sol.stats.converged
        got = check.judge(mesh["nodes"], mesh["elements"], mesh["fixed"], f, sol.displacements[None].numpy(),
                          sol.reactions[None].numpy(), [sol.stats.converged], cfg["E"], cfg["nu"], "cpu")
        limits = cfg["limits"]
        assert check.passes(check.worst([got]), limits)
        # the reference's residual within an f64 residual's resolution of the program's own
        assert abs(got["residual"][0] - sol.stats.relative_residual) <= limits["residual"] - cfg["tol"]
        # the reactions are K u of the program's own f64 operator; the supports exactly fixed
        assert got["reactions"][0] <= 1e-10 and got["support_u"][0] == 0.0
        c = utils.counters()
        if r == 0:
            assert c.get("build_cache.miss.route") == 1 and c.get("build_cache.miss.voxel") == 1
        else:
            assert c.get("build_cache.hit.route") == 1 and c.get("build_cache.hit.voxel") == 1
            assert not any(k.startswith("build_cache.miss") for k in c)


def test_the_answer_rounded_to_float32_is_judged_wrong(large_routes_for_small_scenes):
    """The rounded control's step at this size: the same answer in float32
    fails the configuration's residual limit by orders of magnitude."""
    cfg = _config()
    gen = load.Generator(cfg, spec.Bench(tiny.REPO).traffic("loadcases"), box, SEEDS[0])
    mesh = gen.mesh(0)
    f = gen.loads(0, mesh)
    scene = ftt.make_scene(mesh["nodes"], mesh["elements"], mesh["fixed"], f[0],
                           ftt.Material(E=cfg["E"], nu=cfg["nu"]), dtype=torch.float64, device="cpu")
    sol = ftt.solve(scene, tol=cfg["tol"])
    u = sol.displacements.to(torch.float32).to(torch.float64)[None].numpy()
    got = check.judge(mesh["nodes"], mesh["elements"], mesh["fixed"], f, u, sol.reactions[None].numpy(), [True],
                      cfg["E"], cfg["nu"], "cpu")
    assert got["residual"][0] > 100 * cfg["limits"]["residual"]
    assert not check.passes(check.worst([got]), cfg["limits"])


@pytest.fixture(scope="module")
def reader():
    bench = spec.Bench(tiny.REPO)
    return bench.reader(next(m for m in bench.data["per_layer"] if m["name"] == READER))


def test_the_bound_is_k1s_masked_apply_at_8m():
    """The kernel table's K1 bound at 8.1M, masked: bytes, 97.5 MB."""
    t, by = roofline.voxel_apply(CELLS, "float32", masked=True)
    assert by == "bytes" and round(t * 1e3, 4) == 0.0291
    assert t == pytest.approx(roofline.voxel_apply(CELLS, "float64", masked=True)[0] / 2, rel=1e-12)


def test_the_reader_reads_k1s_finest_masked_launches(reader):
    finest = [133.0, 131.0, 132.5]
    launches = ([(K1, us, 2_000) for us in finest] + [(K1, 40.0, 250), (K1, 9.0, 40)]  # coarser levels
                + [(K1.replace("true", "false"), 100.0, 2_000)]  # unmasked
                + [(K2, 278.0, 4_000), ("void at::native::vectorized_elementwise_kernel", 30.0, 9_000)])
    run = dataclasses.make_dataclass("Run", ["config", "trace"])
    trace = Trace(kernels=launches, busy_s=1.0, window_s=2.0, breakdown={})
    got = reader(run({"cells": CELLS}, trace))
    bound, _ = roofline.voxel_apply(CELLS, "float32", masked=True)
    assert got == pytest.approx(100.0 * bound / (np.mean(finest) * 1e-6), rel=1e-12)
    assert got == pytest.approx(100.0 * 0.0291e-3 / (np.mean(finest) * 1e-6), rel=2e-3)
    assert reader(run({"cells": CELLS}, None)) is None  # an untraced run
    assert reader(run({"cells": CELLS}, Trace([(K2, 278.0, 4_000)], 1.0, 2.0, {}))) is None  # no K1 launch
    assert reader(run({"cells": CELLS}, Trace([(K1, 133.0, None)], 1.0, 2.0, {}))) is None  # no grids


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["voxel_1m", "voxel_8m"])
def test_the_residuals_resolution_on_the_card(name):
    """At full size on the card, the gap between the reference's f64
    residual and the program's own over the same answers, within what the
    configuration's residual limit leaves above tol: the flagship's 1e-10
    at 1M, voxel_8m's 2.1e-9 at 8.1M. The gap is the two f64 K u's apart,
    the program's K2 stencil (its reactions are K u over all DOFs) and the
    reference's element scatter, so ||F (R - K u)|| / ||F f|| bounds it;
    both are printed."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a full-size solve on K1 and K2")
    cfg = spec.Bench(tiny.REPO).config(name)
    gen = load.Generator(cfg, spec.Bench(tiny.REPO).traffic("loadcases"), box, SEEDS[0])
    mesh = gen.mesh(0)
    dev = torch.device("cuda")
    scene = ftt.make_scene(mesh["nodes"], mesh["elements"], mesh["fixed"], np.zeros_like(mesh["nodes"]),
                           ftt.Material(E=cfg["E"], nu=cfg["nu"]), dtype=torch.float64, device=dev)
    nodes, elements = torch.as_tensor(mesh["nodes"], device=dev), torch.as_tensor(mesh["elements"], device=dev)
    free = torch.as_tensor(~mesh["fixed"], device=dev).to(torch.float64)
    for r in range(3):
        f = gen.loads(r, mesh)
        f_t = torch.as_tensor(f[0], device=dev)
        sol = ftt.solve(dataclasses.replace(scene, loads=f_t), tol=cfg["tol"])
        assert sol.route == ROUTE and sol.stats.converged
        got = check.judge(mesh["nodes"], mesh["elements"], mesh["fixed"], f, sol.displacements[None].cpu().numpy(),
                          sol.reactions[None].cpu().numpy(), [True], cfg["E"], cfg["nu"], dev)
        ku = hex8.stiffness_apply(nodes, elements, cfg["E"], cfg["nu"], sol.displacements[None])[0]
        ku_gap = float(torch.linalg.vector_norm(free * (sol.reactions - ku)) / torch.linalg.vector_norm(free * f_t))
        gap = abs(got["residual"][0] - sol.stats.relative_residual)
        print(f"{name} {cfg['cells']} request {r}: iterations {sol.stats.iterations}, own residual "
              f"{sol.stats.relative_residual:.4e}, reference's {got['residual'][0]:.4e}, gap {gap:.4e}, "
              f"||F (R - K u)|| / ||F f|| {ku_gap:.4e}")
        assert gap <= ku_gap * (1 + 1e-6)
        assert gap <= cfg["limits"]["residual"] - cfg["tol"]
        assert check.passes(check.worst([got]), cfg["limits"])
