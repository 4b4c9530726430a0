"""The port's demos (``python -m fea_tpu_torch.examples.<name>``) against
the JAX demos of ``examples/``: each pair runs here on the CPU, in
process, and the anchors each prints are compared.

Tolerances: numbers printed from f64 solves on both sides agree to the
printed digits, or within 1e-9 relative where both print full floats; the
cubebeam and tube demos of the reference build f32 scenes and the port's
twins f64 ones, so their anchors agree within 1e-4 relative (cubebeam's
max|u|) and one unit of the fifth printed decimal (the tube's tip
displacements in inch). Iteration counts of Jacobi and block-Jacobi CG
agree within 5% (the f64 recurrences differ by rounding over ~400
iterations), those of the two-level preconditioners within 1.
"""
import contextlib
import importlib.util
import io
import json
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from fea_tpu_torch.examples import NAMES
from torch_pin import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
ARGS = {"tube": ["--layers", "12"]}  # a shorter tube than the demo's 50 layers, on both sides


def _run_jax(name, monkeypatch) -> str:
    spec = importlib.util.spec_from_file_location(f"_jax_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *ARGS.get(name, [])])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        mod.main()
    return buf.getvalue()


def _run_port(name) -> str:
    mod = importlib.import_module(f"fea_tpu_torch.examples.{name}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        mod.main(["--device", "cpu", *ARGS.get(name, [])])
    return buf.getvalue()


def _num(pattern, text, group=1):
    m = re.search(pattern, text)
    assert m, (pattern, text[-2000:])
    return float(m.group(group))


def _nums(text):
    return [float(v) for v in re.findall(r"-?\d+\.?\d*(?:e[-+]\d+)?", text)]


def _line(prefix, text):
    (line,) = [ln for ln in text.splitlines() if ln.startswith(prefix)]
    return line


def _check_cubebeam(j, t):
    uj, ut = _num(r"max \|u\| = (\S+)", j), _num(r"max \|u\| = (\S+)", t)
    assert abs(ut / uj - 1) <= 1e-4 and abs(ut / 3.0504e-4 - 1) <= 1e-4
    rj, rt = json.loads(j.splitlines()[0]), json.loads(t.splitlines()[0])
    assert (rt["n_dof"], rt["n_elements"]) == (rj["n_dof"], rj["n_elements"]) == (3750, 784)
    assert rt["relative_residual"] <= 1e-8 and rt["method"] == "cg"


def _check_euler_bernoulli(j, t):
    for label in ("midspan deflection", "closed form qL^4/384EI"):
        a, b = _num(re.escape(label) + r": (\S+)", j), _num(re.escape(label) + r": (\S+)", t)
        assert abs(b / a - 1) <= 1e-9
    assert _num(r"relative error: (\S+)", t) <= 1e-10
    a, b = _nums(_line("end moment", j))[-1], _nums(_line("end moment", t))[-1]
    assert abs(b / a - 1) <= 1e-9


def _check_truss(j, t):
    assert _line("linear apex", t) == _line("linear apex", j)
    for label in ("nonlinear apex displacement:", "member axial forces"):
        assert np.allclose(_nums(_line(label, t)), _nums(_line(label, j)), rtol=1e-8, atol=0)
    assert _num(r"newton iterations: (\d+)", t) == _num(r"newton iterations: (\d+)", j)
    assert _num(r"residual: (\S+)", t) <= 1e-12


def _check_single_element(j, t):
    forces = lambda s: s.split("forces = Ke @ u")[1].split("recovered")[0]  # noqa: E731
    assert forces(t) == forces(j)
    assert t.split("forces = Ke @ u")[0] == j.split("forces = Ke @ u")[0]
    assert _num(r"free nodes = (\S+)", t) < 1e-9


def _check_tube(j, t):
    rj, rt = json.loads(j.splitlines()[0]), json.loads(t.splitlines()[0])
    assert (rt["n_dof"], rt["n_elements"]) == (rj["n_dof"], rj["n_elements"])
    assert rt["relative_residual"] <= 1e-8
    tail = lambda s: _nums(s.split("displacements / inch:")[1].split("...")[1])  # noqa: E731
    assert len(tail(t)) == len(tail(j)) == 9
    assert np.max(np.abs(np.subtract(tail(t), tail(j)))) <= 1e-5


def _check_lshape(j, t):
    for prefix in ("L-domain", "subgrid embedding"):
        assert _line(prefix, t) == _line(prefix, j)
    assert _num(r"max \|u\| = (\S+) m", t) == _num(r"max \|u\| = (\S+) m", j)
    assert _num(r"solved: (\d+) iterations", t) <= _num(r"solved: (\d+) iterations", j) + 1
    assert _num(r"max relative error (\S+)", t) < 1e-7


def _check_sweep(j, t):
    tips = lambda s: [ln for ln in s.splitlines() if ln.startswith("  ")]  # noqa: E731
    assert len(tips(t)) == 8 + 4 + 8
    for a, b in zip(tips(t), tips(j)):
        assert a.split("(")[0] == b.split("(")[0]  # the tip deflections, to the printed digits
    assert _num(r"linearity check: max deviation (\S+)", t) < 1e-8
    assert _num(r"1/E scaling check: max deviation (\S+)", t) < 1e-6


def _check_unstructured(j, t):
    assert t.splitlines()[0] == j.splitlines()[0]
    for label, band in (("scalar Jacobi", 0.05), ("block-Jacobi", 0.05)):
        a, b = _num(label + r"\s*:\s+(\d+)", j), _num(label + r"\s*:\s+(\d+)", t)
        assert abs(b - a) <= band * a
    for label in ("two-level", "cheb two-level"):
        a, b = _num("\n" + label + r"\s*:\s+(\d+)", j), _num("\n" + label + r"\s*:\s+(\d+)", t)
        assert abs(b - a) <= 1
    assert _num(r"vs dense solve: max relative error (\S+)", t) < 1e-6
    assert _num(r"agreement: (\S+)", t) < 1e-6


@pytest.mark.parametrize("name", NAMES)
def test_demo_prints_the_anchors_of_its_jax_twin(name, monkeypatch):
    jax_out = _run_jax(name, monkeypatch)
    port_out = _run_port(name)
    globals()[f"_check_{name}"](jax_out, port_out)
