"""``fea_tpu_torch.utils`` against ``fea_tpu.utils``: the solve record's
fields and JSON, the timer, a profiler trace written on the CPU, and the
build directory keyed by the machine's fingerprint."""
import dataclasses
import json
import os
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fea_tpu as ft
import fea_tpu_torch as ftt
from fea_tpu_torch.ops import nvcc
from fea_tpu_torch.utils import cache
from torch_pin import one_torch_thread  # noqa: F401


def _cubebeam(pkg, **kw):
    nodes, elements = pkg.mesh.box_hex_mesh(2, 2, 6, 0.1, 0.1, 0.6)
    fixed = pkg.fix_where(nodes, lambda p: p[:, 2] == 0.0, 3)
    loads = np.zeros_like(nodes)
    loads[nodes[:, 2] == 0.6, 1] = 1.0
    return pkg.make_scene(nodes, elements, fixed, loads, pkg.Material(E=1e7, nu=0.3), **kw)


def test_record_matches_the_reference():
    jscene = _cubebeam(ft, dtype=jnp.float64)
    tscene = _cubebeam(ftt, dtype=torch.float64, device="cpu")
    jsol = ft.solve(jscene, method="cg", tol=1e-10)
    tsol = ftt.solve(tscene, method="cg", tol=1e-10)
    n = len(ftt.utils.records)
    jrec = ft.utils.record_solve(jscene, jsol.stats, 0.5, method="cg", note="x")
    trec = ftt.utils.record_solve(tscene, tsol.stats, 0.5, method="cg", note="x")
    assert ftt.utils.records[n:] == [trec]
    assert [f.name for f in dataclasses.fields(trec)] == [f.name for f in dataclasses.fields(jrec)]
    assert (trec.n_dof, trec.n_elements, trec.method, trec.extra) == (jrec.n_dof, jrec.n_elements, "cg", {"note": "x"})
    assert abs(trec.iterations - jrec.iterations) <= 0.1 * jrec.iterations
    assert trec.relative_residual <= 1e-10 and trec.backend == "cpu" and jrec.backend == "cpu"
    assert trec.dof_per_s == trec.n_dof / 0.5
    tj, jj = json.loads(trec.to_json()), json.loads(jrec.to_json())
    assert tj.keys() == jj.keys() and tj["dof_per_s"] == jj["dof_per_s"]
    assert ftt.utils.SolveRecord(1, 1, 0, 0.0, 0.0).dof_per_s == float("inf")


def test_timer_waits_for_the_result():
    with ftt.utils.Timer() as t:
        time.sleep(0.02)
        out = t.set_result({"a": torch.ones(3), "b": [torch.zeros(2)]})
    assert 0.02 <= t.elapsed < 5.0 and out["a"].sum() == 3
    with ftt.utils.Timer() as t:  # nothing registered
        pass
    assert t.elapsed >= 0.0


def test_trace_writes_a_chrome_trace(tmp_path):
    scene = _cubebeam(ftt, dtype=torch.float64, device="cpu")
    with ftt.utils.trace(str(tmp_path / "tr")) as prof:
        ftt.solve(scene, method="cg", tol=1e-8)
    assert prof is not None
    (path,) = (tmp_path / "tr").iterdir()
    assert path.name.startswith("trace_") and path.suffix == ".json"
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert any(n and n.startswith("aten::") for n in names)


def test_build_directory_is_keyed_by_the_fingerprint(tmp_path, monkeypatch):
    before = nvcc.build_dir()
    try:
        path = ftt.utils.cache.setup_compilation_cache(str(tmp_path))
        assert os.path.isdir(path) and os.path.dirname(path) == str(tmp_path)
        assert nvcc.build_dir() == type(before)(path)
        assert ftt.utils.cache.setup_compilation_cache(str(tmp_path)) == path  # same machine, same key
        fp = cache.fingerprint()
        assert str(torch.version.cuda) in fp and cache._cpu_flags() in fp
        monkeypatch.setattr(cache, "fingerprint", lambda: fp + "|another card")
        other = ftt.utils.cache.setup_compilation_cache(str(tmp_path))
        assert other != path and nvcc.build_dir() == type(before)(other)
    finally:
        nvcc.set_build_dir(before)
    assert nvcc.build_dir() == before


@pytest.mark.parametrize("name", ["SolveRecord", "record_solve", "records", "Timer", "trace"])
def test_reference_names(name):
    assert name in ftt.utils.__all__ and hasattr(ftt.utils, name) and hasattr(ft.utils, name)
