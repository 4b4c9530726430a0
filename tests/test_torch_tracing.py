"""The port's spans and counters (``fea_tpu_torch/utils/profiling.py``) and
the benchmark's readers of them (``benchmark/harness/spans.py``,
``benchmark/metrics/*``).

A call into ``solve`` or ``solve_many`` leaves one root span and the spans
of its stages under it, each with the root's request id, its parent's index
and an interval inside its parent's; under ``torch.profiler`` the same names
land in the Chrome trace as ``user_annotation`` events, and with no
profiler recording ``record_function`` is never entered. No JAX here: the
spans are the port's own.
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
from benchmark.harness import spans as bench_spans
from benchmark.harness import spec
from benchmark.tests import tiny
from fea_tpu_torch import utils
from fea_tpu_torch.ops.multigrid import build_multigrid
from fea_tpu_torch.ops.structured import build_structured_operator
from fea_tpu_torch.solve import certify, solve_operator_fpcg_staged
from fea_tpu_torch.solvers.cg import SolveStats
from torch_pin import one_torch_thread  # noqa: F401
from torch_tools import ShiftedRhs

PROFILING = sys.modules["fea_tpu_torch.utils.profiling"]
SOLVE = sys.modules["fea_tpu_torch.solve"]
CACHE = sys.modules["fea_tpu_torch.solve.cache"]
MAT = dict(E=1e7, nu=0.3)
STAGES = {"fea.route", "fea.build.operator", "fea.build.hierarchy", "fea.fcg.run", "fea.certify"}
CURV_BUILD = ("fea.build.curv.jacobians", "fea.build.curv.weights", "fea.build.curv.rap", "fea.build.curv.levels",
              "fea.build.curv.coarse")
READERS = ("route_ms_per_request", "operator_build_ms_per_request", "hierarchy_build_ms_per_request",
           "fcg_host_ms_per_case", "certify_ms_per_case", "certify_passes_per_case", "solve_self_ms_per_request")


def _box(nx, ny, nz, cases=None):
    nodes, elements = ftt.mesh.box_hex_mesh(nx, ny, nz, 0.1, 0.1, 1.0)
    fixed = ftt.fix_where(nodes, lambda q: q[:, 2] == 0.0, 3)
    tip = nodes[:, 2] == nodes[:, 2].max()
    loads = np.zeros((cases or 1,) + nodes.shape)
    loads[:, tip, 1] = 1.0
    loads[:, tip, 0] = np.linspace(-0.5, 0.5, cases or 1)[:, None]
    scene = ftt.make_scene(nodes, elements, fixed, loads[0], ftt.Material(**MAT), dtype=torch.float64, device="cpu")
    return scene, loads


def _distorted(nx, ny, nz, seed=7):
    """A box grid with its interior nodes moved by a quarter cell: the
    curvilinear route's scene."""
    lz = 0.1 * nz / nx
    nodes, elements = ftt.mesh.box_hex_mesh(nx, ny, nz, 0.1, 0.12, lz)
    interior = (nodes[:, 2] > 0) & (nodes[:, 2] < lz)
    nodes = nodes + 0.25 * (0.1 / nx) * np.random.default_rng(seed).uniform(-1, 1, nodes.shape) * interior[:, None]
    fixed = ftt.fix_where(nodes, lambda q: np.isclose(q[:, 2], 0.0), 3)
    loads = np.zeros_like(nodes)
    loads[np.isclose(nodes[:, 2], lz), 1] = 1.0
    return nodes, elements, fixed, loads


def _tree(records):
    """The one root of ``records`` and every span checked against it:
    the root's request id, a parent among them and an interval inside the
    parent's."""
    (root,) = [s for s in records if s.parent is None]
    by_index = {s.index: s for s in records}
    for s in records:
        assert s.request == root.request and s.start <= s.end
        if s is not root:
            parent = by_index[s.parent]
            assert parent.start <= s.start and s.end <= parent.end
    assert sorted(by_index) == list(range(root.index, root.index + len(records)))
    return root


def _children(records, parent):
    return [s for s in records if s.parent == parent.index]


def test_solve_many_leaves_one_root_over_the_stages():
    scene, loads = _box(4, 4, 32, cases=3)
    utils.reset()
    sol = ftt.solve_many(scene, loads, tol=1e-8)
    assert sol.stats.converged.all()
    records = utils.spans()
    root = _tree(records)
    assert root.name == "fea.solve_many" and records[-1] is root  # a parent closes after its children
    kids = _children(records, root)
    assert {s.name for s in kids} == STAGES
    assert [s.name for s in kids].count("fea.certify") == 3  # one a case
    assert all(s.name in ("fea.fcg.run", "fea.certify.pass") for s in records if s.parent not in (None, root.index))


def test_solve_just_over_the_structured_size_leaves_the_same_stages():
    scene, _ = _box(16, 16, 64)
    assert SOLVE._STRUCTURED_MIN_DOF <= scene.n_dof < SOLVE._STRUCTURED_MIN_DOF + 10_000
    utils.reset()
    sol = ftt.solve(scene, tol=1e-8)
    assert sol.route == "fpcg-multigrid" and sol.stats.converged
    records = utils.spans()
    root = _tree(records)
    assert root.name == "fea.solve"
    kids = _children(records, root)
    assert {s.name for s in kids} == STAGES and [s.name for s in kids].count("fea.certify") == 1
    # the root is its direct children and what they leave uncovered
    call = bench_spans.Call(None, root, records)
    assert abs(bench_spans.ms(kids) + bench_spans.self_ms(call) - 1e3 * root.seconds) < 1e-3


def test_the_canonicalized_route_nests_its_solve_under_the_root(monkeypatch):
    monkeypatch.setattr(SOLVE, "_STRUCTURED_MIN_DOF", 0)
    monkeypatch.setattr(CACHE, "_BUILD_CACHE", {})
    nodes, elements, fixed, loads = _distorted(4, 4, 16, seed=4)
    rng = np.random.default_rng(5)
    pi = rng.permutation(nodes.shape[0])
    inv = np.empty_like(pi)
    inv[pi] = np.arange(pi.size)
    scene = ftt.make_scene(nodes[inv], pi[elements][rng.permutation(elements.shape[0])], fixed[inv], loads[inv],
                           ftt.Material(**MAT), dtype=torch.float64, device="cpu")
    utils.reset()
    sol = ftt.solve(scene, tol=1e-8)
    assert sol.route == "fpcg-canonicalized-grid" and sol.stats.converged
    records = utils.spans()
    root = _tree(records)
    inner = [s for s in records if s.name == "fea.solve" and s is not root]
    assert root.name == "fea.solve" and len(inner) == 1 and inner[0].parent == root.index
    assert {s.name for s in _children(records, inner[0])} == STAGES
    assert sum(s.name == "fea.route" for s in records) == 3  # the outer grid test, the renumbering, the inner one


def _tube():
    n2, q = ftt.mesh.annulus_section(26, 0.099, 0.1016)
    return ftt.mesh.extrude_quads(n2, q, np.linspace(0.0, 1.0, 50))


def _broken_box(nx=3, ny=3, nz=8):
    nodes, elements = ftt.mesh.box_hex_mesh(nx, ny, nz, 0.1, 0.1, 0.3)
    elements = elements.copy()
    elements[[0, 1]] = elements[[1, 0]]  # the element order of no grid route
    return nodes, elements


@pytest.mark.parametrize("mesh, entry, route", [
    (_tube, "solve_many", None),
    (lambda: ftt.mesh.l_hex_mesh(6, 4, 12, 0.1, 0.1, 0.4), "solve_many", None),
    (_broken_box, "solve_many", None),
    (lambda: _broken_box(6, 6, 16), "solve", "fpcg-amg-bcsr"),  # 2,499 DOF: the AMG route's least
], ids=["extruded", "box-subset", "two-level", "amg"])
def test_each_route_spans_its_builds(mesh, entry, route, monkeypatch):
    monkeypatch.setattr(CACHE, "_BUILD_CACHE", {})
    monkeypatch.setattr(SOLVE, "_BLOCK_PRECOND_MIN_DOF", 0)
    nodes, elements = mesh()
    fixed = ftt.fix_where(nodes, lambda q: q[:, 2] == 0.0, 3)
    loads = np.zeros((2,) + nodes.shape)
    loads[:, nodes[:, 2] == nodes[:, 2].max(), 1] = 1.0
    scene = ftt.make_scene(nodes, elements, fixed, loads[0], ftt.Material(**MAT), dtype=torch.float64, device="cpu")
    utils.reset()
    if entry == "solve":
        sol = ftt.solve(scene, tol=1e-8)
        assert sol.route == route and sol.stats.converged
    else:
        assert ftt.solve_many(scene, loads, tol=1e-8).stats.converged.all()
    records = utils.spans()
    root = _tree(records)
    assert root.name == "fea." + entry
    assert {"fea.build.operator", "fea.build.hierarchy", "fea.fcg.run", "fea.certify"} <= {
        s.name for s in _children(records, root)}


def test_profiler_records_the_spans_as_user_annotations(tmp_path, monkeypatch):
    scene, loads = _box(4, 4, 32, cases=2)
    entered = []
    real = torch.profiler.record_function

    class Counted(real):
        def __enter__(self):
            entered.append(self.name)
            return super().__enter__()

    monkeypatch.setattr(torch.profiler, "record_function", Counted)
    ftt.solve_many(scene, loads, tol=1e-8)
    assert entered == []  # no profiler recording: no record_function
    scene, loads = _box(4, 4, 32, cases=2)  # a new mesh: the first one's repeat takes its cached build
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        ftt.solve_many(scene, loads, tol=1e-8)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    names = {e["name"] for e in json.loads(path.read_text())["traceEvents"] if e.get("cat") == "user_annotation"}
    assert {"fea.solve_many"} | STAGES <= names and {"fea.solve_many"} | STAGES <= set(entered)


def test_ring_is_bounded_and_reset_clears_it():
    utils.reset()
    utils.count("x", 2)
    s = utils.span("fea.test")
    for _ in range(PROFILING.RING_SIZE + 5):
        with s:
            pass
    records = utils.spans()
    assert len(records) == PROFILING.RING_SIZE and all(r.parent is None for r in records)
    assert records[-1].request - records[0].request == PROFILING.RING_SIZE - 1  # the oldest five went
    assert utils.counters() == {"x": 2}
    utils.reset()
    assert utils.spans() == [] and utils.counters() == {}


def test_a_decorated_function_opens_its_span_on_every_call():
    @utils.span("fea.outer")
    def outer(depth):
        return outer(depth - 1) if depth else None

    utils.reset()
    outer(2)
    records = utils.spans()
    root = _tree(records)
    assert [r.name for r in records] == ["fea.outer"] * 3 and records[0].parent == records[1].index
    assert root is records[-1]


def test_build_cache_counts_a_miss_then_hits(monkeypatch):
    monkeypatch.setattr(SOLVE, "_STRUCTURED_MIN_DOF", 0)
    monkeypatch.setattr(CACHE, "_BUILD_CACHE", {})
    nodes, elements, fixed, loads = _distorted(4, 4, 16)
    scene = ftt.make_scene(nodes, elements, fixed, loads, ftt.Material(**MAT), dtype=torch.float64, device="cpu")
    utils.reset()
    for i in range(3):
        sol = ftt.solve(dataclasses.replace(scene, loads=scene.loads * (i + 1)), tol=1e-8)
        assert sol.route == "fpcg-curvilinear-multigrid"
    assert utils.counters() == {"build_cache.miss.route": 1, "build_cache.hit.route": 2,
                                "build_cache.miss.curvilinear": 1, "build_cache.hit.curvilinear": 2,
                                "curv.coarse.cholesky": 1}  # the one build's coarsest inverse
    builds = [s for s in utils.spans() if s.name.startswith("fea.build.")]
    assert sorted(s.name for s in builds) == [  # the first call only; no coarser level at this size, so no RAP
        "fea.build.curv.coarse", "fea.build.curv.jacobians", "fea.build.curv.levels", "fea.build.curv.weights",
        "fea.build.hierarchy", "fea.build.operator"]


def test_the_curvilinear_build_spans_its_stages_inside_its_builds(monkeypatch):
    """At 8x8x16 (4,131 DOF) the hierarchy has one Galerkin level below
    the fine one: each ``fea.build.curv.*`` span opens once, the check and
    the assembly inside ``fea.build.operator``, RAP, the levels' bounds
    and casts and the coarse level's inverse inside
    ``fea.build.hierarchy``."""
    monkeypatch.setattr(SOLVE, "_STRUCTURED_MIN_DOF", 0)
    monkeypatch.setattr(CACHE, "_BUILD_CACHE", {})
    nodes, elements, fixed, loads = _distorted(8, 8, 16)
    scene = ftt.make_scene(nodes, elements, fixed, loads, ftt.Material(**MAT), dtype=torch.float64, device="cpu")
    utils.reset()
    sol = ftt.solve(scene, tol=1e-8)
    assert sol.route == "fpcg-curvilinear-multigrid" and sol.stats.converged
    records = utils.spans()
    root = _tree(records)
    by_index = {s.index: s for s in records}
    curv = [s for s in records if s.name.startswith("fea.build.curv.")]
    assert sorted(s.name for s in curv) == ["fea.build.curv.coarse", "fea.build.curv.jacobians",
                                            "fea.build.curv.levels", "fea.build.curv.rap", "fea.build.curv.weights"]
    parents = {s.name.rsplit(".", 1)[1]: by_index[s.parent] for s in curv}
    assert {k: p.name for k, p in parents.items()} == {
        "jacobians": "fea.build.operator", "weights": "fea.build.operator",
        "rap": "fea.build.hierarchy", "levels": "fea.build.hierarchy", "coarse": "fea.build.hierarchy"}
    assert all(p.parent == root.index for p in parents.values())


def test_a_correction_pass_is_a_span_and_a_count():
    """``refine_true`` on A = 2 I with a start at half the answer: one
    exact correction pass certifies it."""
    op = SimpleNamespace(free=torch.ones(4, 3, dtype=torch.float64), apply_raw=lambda u: 2.0 * u)
    loads = torch.ones(4, 3, dtype=torch.float64)
    stats = SolveStats(iterations=1, residual_norm=1.0, relative_residual=0.5, converged=True)

    def correct(r, tol_pass):
        return r / 2.0, SolveStats(iterations=1, residual_norm=0.0, relative_residual=0.0, converged=True)

    utils.reset()
    sol = certify.refine_true(op, loads, float(loads.norm()), loads / 4.0, stats, correct, tol=1e-10)
    assert sol.stats.converged and sol.stats.iterations == 2
    records = utils.spans()
    root = _tree(records)
    assert root.name == "fea.certify" and [r.name for r in _children(records, root)] == ["fea.certify.pass"]
    assert utils.counters() == {"certify.passes": 1}


def test_a_correction_that_moves_nothing_counts_stalled_passes_and_an_uncertified_case():
    """A correction handing back a zero displacement, converged (what the
    staged loop's correction did while it read its pass's displacement
    before running the pass): every pass counts ``certify.stalled``, the
    passes stop at ``max_refine``, and the case, reported at its true
    residual, counts ``certify.uncertified``."""
    op = SimpleNamespace(free=torch.ones(4, 3, dtype=torch.float64), apply_raw=lambda u: 2.0 * u)
    loads = torch.ones(4, 3, dtype=torch.float64)
    stats = SolveStats(iterations=5, residual_norm=1.0, relative_residual=0.5, converged=True)

    def correct(r, tol_pass):
        return torch.zeros_like(r), SolveStats(iterations=2, residual_norm=0.0, relative_residual=0.0, converged=True)

    utils.reset()
    sol = certify.refine_true(op, loads, float(loads.norm()), loads / 4.0, stats, correct, tol=1e-10)
    assert not sol.stats.converged and sol.stats.iterations == 5 + 3 * 2
    assert sol.stats.relative_residual == pytest.approx(0.5, rel=1e-15)
    assert utils.counters() == {"certify.passes": 3, "certify.stalled": 3, "certify.uncertified": 1}


def test_an_unconverged_solve_counts_one_uncertified_case():
    scene, _ = _box(4, 4, 32)
    op = build_structured_operator(scene, (4, 4, 32), dtype=torch.float64)
    mg = build_multigrid(op.astype(torch.float32), dtype=torch.float32,
                         free_np=1.0 - scene.fixed.numpy().astype(np.float64))
    utils.reset()
    sol = solve_operator_fpcg_staged(op, scene.loads, None, mg, tol=1e-30, max_iters=2)
    assert not sol.stats.converged
    assert utils.counters() == {"certify.uncertified": 1}  # a first pass that did not converge runs no pass


@pytest.mark.cuda
def test_a_correction_pass_raises_no_peak_device_memory():
    """A case certified through a correction pass peaks at the device
    memory of one certified without: the pass adds its correction into u
    in place, and the last residual and reactions go before the next come.
    (A pass that kept them held four more vectors, so a window's
    ``peak_device_gb`` hung on whether any of its cases took a pass.) At
    16x16x64 a vector is 441 KiB; the slack is a quarter of one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the device's memory statistics")
    from fea_tpu_torch.solve.curv import build_curvilinear

    nodes, elements, fixed, loads = _distorted(16, 16, 64)
    scene = ftt.make_scene(nodes, elements, fixed, loads, ftt.Material(**MAT), dtype=torch.float64, device="cuda")
    op, mg = build_curvilinear(scene)
    b = op.rhs(scene.loads, torch.zeros_like(scene.loads))
    v = op.free * torch.as_tensor(np.random.default_rng(3).standard_normal(tuple(b.shape)), device=b.device)
    shifted = ShiftedRhs(op, 3e-8 * float(b.norm()) / float(v.norm()) * v)
    del b, v

    def peak(o):
        solve_operator_fpcg_staged(o, scene.loads, None, mg, tol=1e-8)  # its plan and capture
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        sol = solve_operator_fpcg_staged(o, scene.loads, None, mg, tol=1e-8)
        torch.cuda.synchronize()
        return sol, torch.cuda.max_memory_allocated() - base

    utils.reset()
    sol, passed = peak(shifted)
    assert sol.stats.converged and utils.counters()["certify.passes"] >= 2  # the warm-up's and this one's
    del sol
    utils.reset()
    sol, plain = peak(op)
    assert sol.stats.converged and "certify.passes" not in utils.counters()
    assert passed <= plain + scene.loads.numel() * 8 // 4, (passed, plain)


def test_progress_lines_come_only_to_a_callback():
    scene, _ = _box(4, 4, 32)
    op = build_structured_operator(scene, (4, 4, 32), dtype=torch.float64)
    mg = build_multigrid(op.astype(torch.float32), dtype=torch.float32,
                         free_np=1.0 - scene.fixed.numpy().astype(np.float64))
    lines = []
    sol = solve_operator_fpcg_staged(op, scene.loads, None, mg, tol=1e-8, progress=lines.append)
    assert sol.stats.converged and lines and all(line.startswith("round ") for line in lines)


# --- the benchmark's readers, on a window made here -------------------------------------------------------------


def _span(name, request, index, parent, start, end):
    return PROFILING.SpanRecord(name, request, index, parent, start, end)


def _request(request, first, t0, cases, route, op, mg, run, wait, certify, passes, curv=None):
    """The spans of one call from ``t0`` (seconds), each stage ``ms`` long
    and back to back, its index from ``first``: root, route, operator,
    hierarchy, one FCG run with one wait, and a certification a case with
    ``passes`` correction passes in the first. ``curv``: the ms of the
    five ``fea.build.curv.*`` spans, two inside the operator's span and
    three inside the hierarchy's, or None for none."""
    out, idx, t = [], first + 1, t0 + 1e-3  # 1 ms of the root before its first stage

    def add(name, ms, parent=first):
        nonlocal idx, t
        rec = _span(name, request, idx, parent, t, t + ms * 1e-3)
        idx += 1
        t += ms * 1e-3
        out.append(rec)
        return rec

    add("fea.route", route)
    builds = [add("fea.build.operator", op), add("fea.build.hierarchy", mg)]
    for name, ms, parent in zip(CURV_BUILD, curv or (), builds[:1] * 2 + builds[1:] * 3):
        out.append(_span(name, request, idx, parent.index, parent.start, parent.start + ms * 1e-3))
        idx += 1
    fcg = add("fea.fcg.run", run)
    out.append(_span("fea.fcg.wait", request, idx, fcg.index, fcg.start, fcg.start + wait * 1e-3))
    idx += 1
    for c in range(cases):
        cert = add("fea.certify", certify)
        for _ in range(passes if c == 0 else 0):
            out.append(_span("fea.certify.pass", request, idx, cert.index, cert.start, cert.end))
            idx += 1
    root = _span("fea.solve_many", request, first, None, t0, t + 2e-3)  # 2 ms after the last stage
    return out + [root], idx


def _window(cases=2, drop_root_of=None, curv=False):
    """A run of three window requests (and a warm-up before them, and a
    profiled one inside), its records and the ring they left; ``curv``:
    request r's five curvilinear build spans last 1, 2, 3, 4 and 5 ms
    times r."""
    ring, records, idx, t = [], [], 0, 100.0
    stages = [(2.0, 4.0, 100.0, 30.0, 10.0, 3.0, 1), (3.0, 5.0, 120.0, 40.0, 12.0, 4.0, 0),
              (4.0, 6.0, 140.0, 50.0, 20.0, 5.0, 2), (1.0, 1.0, 1.0, 1.0, 0.0, 1.0, 0)]
    for r, (route, op, mg, run, wait, certify, passes) in enumerate(stages):
        spans_r, idx = _request(r + 1, idx, t, cases, route, op, mg, run, wait, certify, passes,
                                curv=tuple(k * (r + 1) for k in (1.0, 2.0, 3.0, 4.0, 5.0)) if curv else None)
        root = spans_r[-1]
        if r + 1 != drop_root_of:
            ring += spans_r
        if r > 0:  # request 1 is the warm-up
            records.append(SimpleNamespace(cases=cases, latency_s=root.end - t + 1e-3, done_at=root.end + 5e-4,
                                           profiled=r == 3, iterations=[40 + r] * cases))
        t = root.end + 0.01
    return SimpleNamespace(config={}, requests=records, trace=None), ring


def _expected(cases=2):
    """Each reader's median over requests 2 and 3 (request 4 is profiled)."""
    def per(route, op, mg, run, wait, certify, passes):
        return {"route_ms_per_request": route, "operator_build_ms_per_request": op,
                "hierarchy_build_ms_per_request": mg, "fcg_host_ms_per_case": (run - wait) / cases,
                "certify_ms_per_case": certify, "certify_passes_per_case": passes / cases,
                "solve_self_ms_per_request": 3.0}
    a = per(3.0, 5.0, 120.0, 40.0, 12.0, 4.0, 0)
    b = per(4.0, 6.0, 140.0, 50.0, 20.0, 5.0, 2)
    return {k: (a[k] + b[k]) / 2 for k in a}


@pytest.fixture
def readers():
    bench = spec.Bench(tiny.REPO)
    return {m["name"]: bench.reader(m) for m in bench.data["per_layer"] if m["name"] in READERS}


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_the_median_over_the_window(name, readers, monkeypatch):
    run, ring = _window()
    monkeypatch.setattr(utils, "spans", lambda: list(ring))
    assert readers[name](run) == pytest.approx(_expected()[name], rel=1e-9, abs=1e-9)


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_none_without_every_root(name, readers, monkeypatch):
    run, ring = _window(drop_root_of=3)
    monkeypatch.setattr(utils, "spans", lambda: list(ring))
    assert readers[name](run) is None
    _, whole = _window()
    monkeypatch.setattr(utils, "spans", lambda: [s for s in whole if s.index != 14])  # a child of request 2 went
    assert readers[name](run) is None
    monkeypatch.delattr(utils, "spans")  # a program without spans
    assert readers[name](run) is None


@pytest.fixture
def curv_readers():
    bench = spec.Bench(tiny.REPO)
    return {m["name"]: bench.reader(m) for m in bench.data["per_layer"]
            if m["name"] in ("fcg_iterations", "fcg_iterations.curv", "certify_passes_per_case.curv",
                             "curv_build_ms_per_request")}


def test_the_curvilinear_cells_read_the_voxel_cells_counts(curv_readers, monkeypatch):
    """``fcg_iterations.curv`` and ``certify_passes_per_case.curv`` are the
    readers of ``fcg_iterations`` and ``certify_passes_per_case``, listed
    for other cells."""
    run, ring = _window()
    monkeypatch.setattr(utils, "spans", lambda: list(ring))
    assert curv_readers["fcg_iterations.curv"](run) == curv_readers["fcg_iterations"](run) == 42.0
    assert curv_readers["certify_passes_per_case.curv"](run) == pytest.approx(_expected()["certify_passes_per_case"])


def test_curv_build_ms_is_its_spans_summed(curv_readers, monkeypatch):
    """The median over requests 2 and 3 of (1 + 2 + 3 + 4 + 5) x r ms; None
    without the spans (the parent program, or a window of cached builds),
    and None without every root."""
    read = curv_readers["curv_build_ms_per_request"]
    run, ring = _window(curv=True)
    monkeypatch.setattr(utils, "spans", lambda: list(ring))
    assert read(run) == pytest.approx(37.5, rel=1e-9)
    run, ring = _window()
    monkeypatch.setattr(utils, "spans", lambda: list(ring))
    assert read(run) is None
    run, ring = _window(curv=True, drop_root_of=3)
    monkeypatch.setattr(utils, "spans", lambda: list(ring))
    assert read(run) is None


def test_readers_in_a_traced_run_of_the_harness(tmp_path):
    """The seven readers listed for the tiny voxel cells, in a traced run
    on the CPU: each reads a finite value. The run is a child process, as
    the harness refuses a process that holds JAX."""
    root = tiny.checkout(tmp_path, cases=2)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        if m["name"] in READERS:
            m["workloads"] += ["tiny_voxel.batch8", "tiny_voxel.loadcases"]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import json, sys, torch\ntorch.set_num_threads(1)\nfrom pathlib import Path\n"
            "from benchmark.tests import tiny\n"
            "for cell in ('tiny_voxel.batch8', 'tiny_voxel.loadcases'):\n"
            f"    rc, lines, err = tiny.run(Path({str(root)!r}), cell, trace=1)\n"
            "    print(json.dumps([rc, lines[-1] if lines else None, err[-2000:]]))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tiny.REPO, capture_output=True, text=True, timeout=600,
                         env=os.environ | {"PYTHONPATH": str(tiny.REPO)})
    assert out.returncode == 0, out.stderr[-2000:]
    for cell, line in zip(("batch8", "loadcases"), out.stdout.strip().splitlines()[-2:]):
        rc, last, err = json.loads(line)
        assert rc == 0 and last is not None, err
        res = json.loads(last)
        assert res["correct"], err
        values = {k: res["metrics"][k]["value"] for k in READERS}
        assert all(np.isfinite(v) and v >= 0 for v in values.values()), values
        # a solve() of this size takes the element-by-element route: no hierarchy
        assert (values["hierarchy_build_ms_per_request"] > 0) == (cell == "batch8")


@pytest.mark.cuda
def test_capture_ms_is_the_capture_spans_time():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the FCG step is captured only there")
    from fea_tpu_torch.solve import staged

    nodes, elements = ftt.mesh.box_hex_mesh(8, 8, 64, 0.1, 0.1, 1.0)
    fixed = ftt.fix_where(nodes, lambda q: q[:, 2] == 0.0, 3)
    loads = np.zeros((2,) + nodes.shape)
    loads[:, nodes[:, 2] == nodes[:, 2].max(), 1] = 1.0
    scene = ftt.make_scene(nodes, elements, fixed, loads[0], ftt.Material(**MAT), dtype=torch.float64)
    before = staged.COUNTS["capture_ms"]
    utils.reset()
    ftt.solve_many(scene, loads, tol=1e-8)
    captures = [s for s in utils.spans() if s.name == "fea.fcg.capture"]
    assert len(captures) == 1 and any(s.name == "fea.fcg.wait" for s in utils.spans())
    assert staged.COUNTS["capture_ms"] - before == pytest.approx(1e3 * captures[0].seconds, rel=1e-9)
