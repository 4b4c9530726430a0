"""Port parity: mesh, scene, element stiffness and voxel detection of
fea_tpu_torch against fea_tpu, and the port's independence from JAX."""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fea_tpu as ft
from fea_tpu.elements import hex8 as jax_hex8
from fea_tpu.ops.structured import infer_box_dims as jax_infer_box_dims

import fea_tpu_torch as ftt
from fea_tpu_torch.elements.hex8 import CORNER_SIGNS, stiffness_matrix_np
from fea_tpu_torch.ops.structured import infer_box_dims
from torch_pin import one_torch_thread  # noqa: F401

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def _both_scenes(nodes, elements, fixed, loads, E=1e7, nu=0.3):
    jsc = ft.make_scene(nodes, elements, fixed, loads, ft.Material(E=E, nu=nu), dtype=jnp.float64)
    tsc = ftt.make_scene(nodes, elements, fixed, loads, ftt.Material(E=E, nu=nu), dtype=torch.float64, device="cpu")
    return jsc, tsc


def _tube(layers=6):
    nodes2d, quads = ft.mesh.annulus_section(12, 0.09, 0.1)
    return ft.mesh.extrude_quads(nodes2d, quads, np.linspace(0.0, 1.0, layers))


def test_mesh_matches_jax():
    for args in [(3, 2, 5, 0.3, 0.2, 0.5), (4, 4, 49, 0.1, 0.1, 1.0)]:
        n_t, e_t = ftt.mesh.box_hex_mesh(*args)
        n_j, e_j = ft.mesh.box_hex_mesh(*args)
        assert np.array_equal(n_t, n_j) and np.array_equal(e_t, e_j)
    n2, q = ftt.mesh.annulus_section(12, 0.09, 0.1)
    n_t, e_t = ftt.mesh.extrude_quads(n2, q, np.linspace(0.0, 1.0, 6))
    n_j, e_j = _tube()
    assert np.array_equal(n_t, n_j) and np.array_equal(e_t, e_j)


def test_make_scene_and_fix_where_match_jax():
    nodes, elements = ft.mesh.box_hex_mesh(3, 2, 5, 0.3, 0.2, 0.5)
    pred = lambda p: p[:, 2] == 0.0  # noqa: E731
    fixed = ftt.fix_where(nodes, pred, 3)
    assert np.array_equal(fixed, ft.fix_where(nodes, pred, 3))
    loads = np.random.default_rng(0).normal(size=nodes.shape)
    jsc, tsc = _both_scenes(nodes, elements, fixed.astype(int), loads)
    for name in ("nodes", "elements", "fixed", "loads"):
        assert np.array_equal(getattr(tsc, name).numpy(), np.asarray(getattr(jsc, name))), name
    assert (tsc.n_nodes, tsc.n_elements, tsc.n_dof) == (jsc.n_nodes, jsc.n_elements, jsc.n_dof)
    assert np.array_equal(tsc.free_mask(torch.float64).numpy(), np.asarray(jsc.free_mask(jnp.float64)))
    assert np.array_equal(tsc.prescribed_or_zero(torch.float64).numpy(), np.zeros(nodes.shape))
    assert tsc.device == torch.device("cpu")
    # the detectors' host copies: taken once, equal to the tensors
    assert tsc.host_nodes is tsc.host_nodes and tsc.host_elements is tsc.host_elements
    assert np.array_equal(tsc.host_nodes, nodes) and np.array_equal(tsc.host_elements, elements)


def test_make_scene_validation_errors_match_jax():
    nodes, elements = ft.mesh.box_hex_mesh(1, 1, 1, 1.0, 1.0, 1.0)
    fixed = np.zeros_like(nodes, bool)
    loads = np.zeros_like(nodes)
    bad = [
        (nodes, elements[:, :4], fixed, loads),
        (nodes, elements, fixed[:, :2], loads),
        (nodes, elements, fixed, loads[:, :2]),
    ]
    for args in bad:
        with pytest.raises(ValueError) as ej:
            ft.make_scene(*args, ft.Material(1.0, 0.3))
        with pytest.raises(ValueError) as et:
            ftt.make_scene(*args, ftt.Material(1.0, 0.3), device="cpu")
        assert str(et.value) == str(ej.value)


def test_infer_box_dims_matches_jax():
    nodes, elements = ft.mesh.box_hex_mesh(3, 2, 5, 0.3, 0.2, 0.5)
    distorted = nodes.copy()
    distorted[7, 0] += 0.01
    tn, te = _tube()
    cases = [
        (nodes, elements, (3, 2, 5)),
        (distorted, elements, None),  # moved node: not congruent voxels
        (nodes, elements[::-1].copy(), None),  # renumbered elements
        (tn, te, None),
    ]
    for n, e, want in cases:
        jsc, tsc = _both_scenes(n, e, np.zeros_like(n, bool), np.zeros_like(n))
        assert jax_infer_box_dims(jsc) == want
        assert infer_box_dims(tsc) == want


def test_stiffness_matrix_matches_jax_and_golden_values(rng):
    for _ in range(3):
        coords = CORNER_SIGNS + rng.uniform(-0.25, 0.25, size=(8, 3))
        mat = ft.Material(E=70e9, nu=0.3)
        want = jax_hex8.stiffness_matrix_np(coords, mat)
        got = stiffness_matrix_np(coords, ftt.Material(E=70e9, nu=0.3))
        assert np.max(np.abs(got - want)) <= 1e-14 * np.max(np.abs(want))
    # analytic values on the +-1 cube with E=1000, nu=0 (tests/test_hex8.py)
    K = stiffness_matrix_np(CORNER_SIGNS, ftt.Material(E=1000.0, nu=0.0))
    assert K[0, 0] == pytest.approx(4000.0 / 9.0, rel=1e-12)
    assert K[0, 1] == pytest.approx(250.0 / 3.0, rel=1e-12)
    assert K[0, 3] == pytest.approx(-1000.0 / 9.0, rel=1e-12)
    assert np.trace(K) == pytest.approx(32000.0 / 3.0, rel=1e-12)


def test_scene_from_numpy_round_trips_a_jax_scene():
    nodes, elements = ft.mesh.box_hex_mesh(2, 2, 3, 0.2, 0.2, 0.3)
    fixed = ft.fix_where(nodes, lambda p: p[:, 2] == 0.0, 3)
    rng = np.random.default_rng(1)
    loads = rng.normal(size=nodes.shape)
    presc = np.where(fixed, rng.normal(size=nodes.shape), 0.0)
    jsc = ft.make_scene(nodes, elements, fixed, loads, ft.Material(E=2e7, nu=0.25),
                        prescribed=presc, dtype=jnp.float64)
    tsc = ftt.scene_from_numpy(
        np.asarray(jsc.nodes), np.asarray(jsc.elements), np.asarray(jsc.fixed),
        np.asarray(jsc.loads), float(jsc.material.E), float(jsc.material.nu),
        np.asarray(jsc.prescribed), device="cpu",
    )
    assert tsc.nodes.dtype == torch.float64 and tsc.family == "hex8"
    for name in ("nodes", "elements", "fixed", "loads", "prescribed"):
        assert np.array_equal(getattr(tsc, name).numpy(), np.asarray(getattr(jsc, name))), name
    assert (tsc.material.E, tsc.material.nu) == (2e7, 0.25)


def test_import_leaves_jax_out():
    from fea_tpu_torch.examples import NAMES

    examples = ", ".join(f"fea_tpu_torch.examples.{n}" for n in NAMES)
    code = (
        "import sys, fea_tpu_torch, fea_tpu_torch.ops.multigrid, fea_tpu_torch.solve.fpcg, "
        "fea_tpu_torch.utils, fea_tpu_torch.utils.cache, fea_tpu_torch.native, fea_tpu_torch.viz.mpl, "
        f"fea_tpu_torch.sanitize, fea_tpu_torch.solvers.refine, {examples}; "
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'fea_tpu')]; "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": REPO},
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_every_reference_export_is_exported():
    """Every name of ``fea_tpu.__all__`` is in ``fea_tpu_torch.__all__``
    and importable from the package, as are the solvers' and the solve
    module's exports of the reference."""
    import fea_tpu
    import fea_tpu.solve
    import fea_tpu.solvers
    import fea_tpu_torch.solve
    import fea_tpu_torch.solvers

    for ref, port in ((fea_tpu, ftt), (fea_tpu.solvers, fea_tpu_torch.solvers)):
        missing = [n for n in ref.__all__ if n not in port.__all__ or not hasattr(port, n)]
        assert not missing, missing
    solve_mod = sys.modules["fea_tpu_torch.solve"]
    for name in ("solve_operator_refined", "solve_operator_refined_host"):
        assert hasattr(sys.modules["fea_tpu.solve"], name) and name in solve_mod.__all__
