"""The ``tube_591k`` configuration through ``fea_tpu_torch.solve()``, at a
tiny size on the CPU, and its two readers.

The scene is the benchmark's own: its generator (``benchmark/meshes/tube.py``),
its material, radii, length and tolerance, cut to 8 segments x 32 layers
(1,584 DOF: one z-level above the z-coarsest Thomas level, so the line
smoother, both Thomas solves and the composition run), and the loads of the
``loadcases`` mix, drawn by the benchmark's traffic generator from a seed.
Each answer is judged by the benchmark's own comparison
(``benchmark/reference/check.judge``); at one seed the displacements are held
against a dense direct solve of the reference's f64 K. The large-grid routes
are let in at this size, as the port's other route tests do.
"""
import dataclasses
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import fea_tpu_torch as ftt
from benchmark.harness import load, spec
from benchmark.meshes import tube
from benchmark.reference import check, hex8
from benchmark.tests import tiny
from fea_tpu_torch import utils
from fea_tpu_torch.ops import cuda_extruded, extruded_mg
from fea_tpu_torch.solve import staged
from torch_pin import one_torch_thread  # noqa: F401

SOLVE = sys.modules["fea_tpu_torch.solve"]
CACHE = sys.modules["fea_tpu_torch.solve.cache"]
SEEDS = (2**31 + 11, 3_900_020_001, 7)
TUBE32 = {"segments": 8, "layers": 32}
ROUTE = "fpcg-extruded-multigrid"
READERS = ("thomas_launches_per_iteration", "fcg_device_ms_per_iteration", "extruded_apply_launches_per_iteration")


@pytest.fixture
def large_routes_for_small_scenes(monkeypatch):
    monkeypatch.setattr(SOLVE, "_STRUCTURED_MIN_DOF", 0)
    monkeypatch.setattr(CACHE, "_BUILD_CACHE", {})


def _dof(segments, layers):
    return 3 * 2 * segments * (layers + 1)


def _config(cut=TUBE32):
    cfg = json.loads((tiny.REPO / "benchmark/configs/tube_591k.json").read_text())
    return cfg | cut | {"dof": _dof(cut["segments"], cut["layers"])}


def _zero_counts():
    extruded_mg.LAUNCHES["thomas"] = 0
    for key in staged.COUNTS:
        staged.COUNTS[key] = 0


def _scene(cfg, mesh):
    return ftt.make_scene(mesh["nodes"], mesh["elements"], mesh["fixed"], np.zeros_like(mesh["nodes"]),
                          ftt.Material(E=cfg["E"], nu=cfg["nu"]), dtype=torch.float64, device="cpu")


def _dense_k(nodes, elements, E, nu):
    """The reference's K, assembled densely."""
    n = 3 * nodes.shape[0]
    K = np.zeros((n, n))
    ke = hex8.element_stiffness(torch.as_tensor(nodes)[torch.as_tensor(elements)], E, nu).numpy()
    for e, el in enumerate(elements):
        dofs = (3 * el[:, None] + np.arange(3)).ravel()
        K[np.ix_(dofs, dofs)] += ke[e]
    return K


@pytest.mark.parametrize("cut", [TUBE32, {"segments": 256, "layers": 384}], ids=["8x32", "256x384"])
def test_mesh_is_the_programs_annulus_extrusion(cut):
    cfg = _config(cut)
    mesh = tube.build(cfg, np.random.default_rng(0))
    n2d, quads = ftt.mesh.annulus_section(cfg["segments"], cfg["r_in"], cfg["r_out"])
    nodes, elements = ftt.mesh.extrude_quads(n2d, quads, np.linspace(0.0, cfg["length"], cfg["layers"] + 1))
    assert np.array_equal(mesh["nodes"], nodes) and np.array_equal(mesh["elements"], elements)
    assert mesh["elements"].dtype == np.int64 and mesh["nodes"].size == cfg["dof"]
    z = mesh["nodes"][:, 2]
    assert np.array_equal(mesh["fixed"], np.repeat((z == 0.0)[:, None], 3, axis=1))
    assert np.array_equal(mesh["tip"], z == cfg["length"]) and mesh["tip"].sum() == 2 * cfg["segments"]
    # no random numbers: the mesh is the same whatever the generator
    again = tube.build(cfg, np.random.default_rng(12345))
    assert all(np.array_equal(mesh[k], again[k]) for k in mesh)


def test_the_configuration_is_the_benchmarks_entry():
    bench = spec.Bench(tiny.REPO)
    entry = next(c for c in bench.data["configs"] if c["name"] == "tube_591k")
    cfg = bench.config("tube_591k")
    assert cfg["source"] == entry["source"] and cfg["reduced"] == entry["reduced"] == []
    assert (cfg["segments"], cfg["layers"], cfg["dof"]) == (256, 384, 591_360) == (
        cfg["segments"], cfg["layers"], _dof(cfg["segments"], cfg["layers"]))
    assert cfg["E"] == 10e6 * ftt.units.psi and cfg["load_total"] == 1000 * ftt.units.lbf
    assert (cfg["r_in"], cfg["r_out"], cfg["length"]) == pytest.approx(
        (3.9 * ftt.units.inch, 4 * ftt.units.inch, 2 * ftt.units.ft), rel=1e-15)
    cell = bench.cell("tube_591k.loadcases")
    assert cell["config"] == "tube_591k" and cell["traffic"] == "loadcases" and cell["chips"] == 1
    assert {m["name"] for m in bench.metrics("per_layer", "tube_591k.loadcases")} == set(READERS)


@pytest.mark.parametrize("seed", SEEDS)
def test_solve_is_judged_correct(seed, large_routes_for_small_scenes):
    cfg = _config()
    gen = load.Generator(cfg, spec.Bench(tiny.REPO).traffic("loadcases"), tube, seed)
    mesh = gen.mesh(0)
    scene = _scene(cfg, mesh)
    for r in range(3):  # the first request builds, the later ones hit the route and extruded entries
        f = gen.loads(r, mesh)
        assert np.count_nonzero(f[0].any(axis=1)) == 2 * cfg["segments"] and f[0][:, 2].max() == 0.0
        utils.reset()
        sol = ftt.solve(dataclasses.replace(scene, loads=torch.as_tensor(f[0])), tol=cfg["tol"])
        assert sol.route == ROUTE and sol.stats.converged
        got = check.judge(mesh["nodes"], mesh["elements"], mesh["fixed"], f, sol.displacements[None].numpy(),
                          sol.reactions[None].numpy(), [sol.stats.converged], cfg["E"], cfg["nu"], "cpu")
        # the configuration's residual limit; the reactions are K u of the program's own
        # f64 operator (2.5e-12 of ||K u|| measured here); the supports exactly fixed
        assert got["residual"][0] <= cfg["limits"]["residual"]
        assert got["reactions"][0] <= 1e-10 and got["support_u"][0] == 0.0
        c = utils.counters()
        if r == 0:
            assert c.get("build_cache.miss.route") == 1 and c.get("build_cache.miss.extruded") == 1
        else:
            assert c.get("build_cache.hit.route") == 1 and c.get("build_cache.hit.extruded") == 1
            assert not any(k.startswith("build_cache.miss") for k in c)


def test_displacements_match_a_dense_solve(large_routes_for_small_scenes):
    cfg = _config()
    gen = load.Generator(cfg, spec.Bench(tiny.REPO).traffic("loadcases"), tube, SEEDS[0])
    mesh = gen.mesh(0)
    f = gen.loads(0, mesh)[0]
    sol = ftt.solve(dataclasses.replace(_scene(cfg, mesh), loads=torch.as_tensor(f)), tol=cfg["tol"])
    assert sol.route == ROUTE
    K = _dense_k(mesh["nodes"], mesh["elements"], cfg["E"], cfg["nu"])
    free = ~mesh["fixed"].reshape(-1)
    want = np.zeros(K.shape[0])
    want[free] = np.linalg.solve(K[np.ix_(free, free)], f.reshape(-1)[free])
    u = sol.displacements.numpy().reshape(-1)
    # a solve certified at 1e-8 errs in the stiff modes, which carry little of u:
    # 9.4e-11 to 9.9e-11 of max |u| measured here over the three seeds; the same
    # answer rounded to float32 reads 3.2e-8 to 5.4e-8 and fails this
    assert np.abs(u - want).max() <= 1e-9 * np.abs(want).max()
    assert np.abs(u[~free]).max() == 0.0


def test_the_counter_counts_each_steps_sweeps(large_routes_for_small_scenes):
    cfg = _config()
    mesh = tube.build(cfg, None)
    f = load.Generator(cfg, spec.Bench(tiny.REPO).traffic("loadcases"), tube, SEEDS[1]).loads(0, mesh)[0]
    scene = dataclasses.replace(_scene(cfg, mesh), loads=torch.as_tensor(f))
    _zero_counts()
    sol = ftt.solve(scene, tol=cfg["tol"])
    assert sol.route == ROUTE
    (_, _, (_, pc)), = CACHE._BUILD_CACHE[("extruded", 3)]
    L_sc, Lc = pc.sc.n_layers, pc.mg.thomas_uinv.shape[0]
    assert (L_sc, Lc) == (33, 17)  # 32 element layers; the z-coarsest level at 16
    per_step = 2 * (L_sc - 1) + 2 * (Lc - 1)
    assert staged.COUNTS["steps"] >= sol.stats.iterations > 0
    assert extruded_mg.LAUNCHES["thomas"] == per_step * staged.COUNTS["steps"]

    # a voxel solve sweeps nothing
    nodes, elements = ftt.mesh.box_hex_mesh(4, 4, 32, 0.1, 0.1, 1.0)
    fixed = ftt.fix_where(nodes, lambda q: q[:, 2] == 0.0, 3)
    loads = np.zeros_like(nodes)
    loads[nodes[:, 2] == nodes[:, 2].max(), 1] = 1.0
    box = ftt.make_scene(nodes, elements, fixed, loads, ftt.Material(E=cfg["E"], nu=cfg["nu"]),
                         dtype=torch.float64, device="cpu")
    _zero_counts()
    assert ftt.solve(box, tol=1e-8).route == "fpcg-multigrid"
    assert staged.COUNTS["steps"] > 0 and extruded_mg.LAUNCHES["thomas"] == 0


def test_the_route_opens_its_stages(large_routes_for_small_scenes):
    cfg = _config()
    mesh = tube.build(cfg, None)
    scene = _scene(cfg, mesh)
    loads = load.Generator(cfg, spec.Bench(tiny.REPO).traffic("loadcases"), tube, SEEDS[2]).loads(0, mesh)[0]
    for first in (True, False):
        utils.reset()
        assert ftt.solve(dataclasses.replace(scene, loads=torch.as_tensor(loads)), tol=cfg["tol"]).route == ROUTE
        records = utils.spans()
        (root,) = [s for s in records if s.parent is None]
        assert root.name == "fea.solve" and all(s.request == root.request for s in records)
        below = {s.name for s in records if s.parent == root.index}
        builds = {"fea.route", "fea.build.operator", "fea.build.hierarchy"}
        assert {"fea.fcg.run", "fea.certify"} <= below
        if first:  # the V-cycle's hierarchy and the section coarse space: two hierarchy builds
            assert builds <= below and sum(s.name == "fea.build.hierarchy" for s in records) == 2
        else:  # the route's verdict and the build come from the cache
            assert not builds & below


def _run(busy_s=1.0, requests=((True, 26),)):
    """A run for the readers: its traced slice's busy seconds (None: untraced) and
    (profiled, iterations) of each request."""
    recs = [SimpleNamespace(profiled=p, iterations=[its], cases=1) for p, its in requests]
    trace = None if busy_s is None else SimpleNamespace(busy_s=busy_s, window_s=2.0)
    return SimpleNamespace(requests=recs, trace=trace)


@pytest.fixture(scope="module")
def readers():
    bench = spec.Bench(tiny.REPO)
    return {m["name"]: bench.reader(m) for m in bench.data["per_layer"] if m["name"] in READERS}


def test_the_launch_reader_reads_the_programs_counters(readers, monkeypatch):
    read = readers["thomas_launches_per_iteration"]
    monkeypatch.setitem(extruded_mg.LAUNCHES, "thomas", 792 * 40 + 792)
    monkeypatch.setitem(staged.COUNTS, "steps", 40)
    assert read(_run()) == pytest.approx(792 + 792 / 40)
    monkeypatch.setitem(staged.COUNTS, "steps", 0)
    assert read(_run()) is None
    # a program without the counter, such as one before it
    monkeypatch.setitem(staged.COUNTS, "steps", 40)
    monkeypatch.setitem(sys.modules, "fea_tpu_torch.ops.extruded_mg", SimpleNamespace())
    assert read(_run()) is None
    monkeypatch.delitem(sys.modules, "fea_tpu_torch.ops.extruded_mg")
    assert read(_run()) is None


def test_the_apply_launch_reader_reads_the_kernels_counter(readers, monkeypatch):
    read = readers["extruded_apply_launches_per_iteration"]
    monkeypatch.setitem(cuda_extruded.LAUNCHES, "apply_f32", 35 * 40 + 35)
    monkeypatch.setitem(cuda_extruded.LAUNCHES, "apply_f64", 2 * 40 + 5)
    monkeypatch.setitem(staged.COUNTS, "steps", 40)
    assert read(_run()) == pytest.approx(37 + 40 / 40)
    monkeypatch.setitem(staged.COUNTS, "steps", 0)
    assert read(_run()) is None
    # a program without the kernel, such as one before it
    monkeypatch.setitem(staged.COUNTS, "steps", 40)
    monkeypatch.setitem(sys.modules, "fea_tpu_torch.ops.cuda_extruded", SimpleNamespace())
    assert read(_run()) is None
    monkeypatch.delitem(sys.modules, "fea_tpu_torch.ops.cuda_extruded")
    assert read(_run()) is None


def test_the_device_reader_reads_busy_time_over_the_slices_iterations(readers):
    read = readers["fcg_device_ms_per_iteration"]
    # two profiled requests of 27 and 26 iterations; one outside the slice counts nothing
    assert read(_run(0.371, ((True, 27), (False, 25), (True, 26)))) == pytest.approx(371.0 / 53)
    assert read(_run(busy_s=0.0)) is None  # nothing ran on a device: a CPU run
    assert read(_run(busy_s=None)) is None  # an untraced run
    assert read(_run(requests=((True, 0),))) is None


def test_a_traced_run_of_a_tiny_tube_cell(tmp_path):
    """The tiny tube cell through the harness, traced, on the CPU: correct,
    nothing failed, the launch reader at one step's count exactly (no capture
    on the CPU), the device reader left out. A child process, as the harness
    refuses a process that holds JAX."""
    root = tiny.checkout(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cfg = _config()
    (root / "benchmark/configs/tiny_tube.json").write_text(json.dumps(cfg))
    bench["configs"].append(dict(name="tiny_tube", source="test", file="benchmark/configs/tiny_tube.json",
                                 reduced=["segments", "layers"], why="a CPU test"))
    bench["workloads"].append(dict(name="tiny_tube.loadcases", config="tiny_tube", traffic="tiny_loadcases",
                                   chips=1, why="a CPU test"))
    for m in bench["per_layer"]:
        if m["name"] in READERS:
            m["workloads"].append("tiny_tube.loadcases")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import json, sys, torch\ntorch.set_num_threads(1)\nfrom pathlib import Path\n"
            "import fea_tpu_torch\nfrom fea_tpu_torch.ops import extruded_mg\nfrom fea_tpu_torch.solve import staged\n"
            "from benchmark.tests import tiny\n"
            "sys.modules['fea_tpu_torch.solve']._STRUCTURED_MIN_DOF = 0\n"
            "extruded_mg.LAUNCHES['thomas'] = 0\n"
            "for k in staged.COUNTS:\n    staged.COUNTS[k] = 0\n"
            f"rc, lines, err = tiny.run(Path({str(root)!r}), 'tiny_tube.loadcases', trace=1)\n"
            "print(json.dumps([rc, lines, err[-2000:], extruded_mg.LAUNCHES['thomas'], staged.COUNTS['steps']]))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tiny.REPO, capture_output=True, text=True, timeout=600,
                         env=os.environ | {"PYTHONPATH": str(tiny.REPO)})
    assert out.returncode == 0, out.stderr[-2000:]
    rc, lines, err, launches, steps = json.loads(out.stdout.strip().splitlines()[-1])
    assert rc == 0 and lines, err
    res = tiny.result(lines)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 2, err
    assert any(f"['{ROUTE}']" in line for line in lines if line.startswith("# window:")), lines
    per_step = 2 * (33 - 1) + 2 * (17 - 1)  # the section's 33 node layers, the z-coarsest level's 17
    assert steps > 0 and launches == per_step * steps
    assert res["metrics"]["thomas_launches_per_iteration"] == {"value": per_step, "unit": "launches"}
    assert "fcg_device_ms_per_iteration" not in res["metrics"]
    # the CPU applies the plain version: no launch of the kernel
    assert res["metrics"]["extruded_apply_launches_per_iteration"] == {"value": 0.0, "unit": "launches"}
