"""``fea_tpu_torch.native`` (the host's exact f64 check in C++): the cases
of tests/test_native.py against the port's NumPy twin
(``fea_tpu_torch.ops.structured.stencil_apply_np``) and the port's plain
curvilinear apply, and bit for bit against ``fea_tpu.native`` on the same
inputs (the same C++ built with the same flags, fed the same table).

Tolerances: the twin sums 64 corner-pair products where the native kernel
sums the assembled 27-offset table, so they agree to f64 rounding
(1e-13 of max|K u|); against the reference's library, exactly.
"""
import numpy as np
import pytest
import torch

import fea_tpu.native as jnat
import fea_tpu_torch as ftt
import fea_tpu_torch.native as nat
from fea_tpu_torch.ops.curvilinear import assemble_curv_weights, curv_apply_grid, grid_view
from fea_tpu_torch.ops.structured import build_structured_operator, stencil_apply_np, structured_scene
from torch_pin import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.skipif(not nat.available(), reason="no host toolchain for the native kernel")


def _random_sym_ke(seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(24, 24))
    return a + a.T


@pytest.mark.parametrize("dims", [(1, 1, 1), (1, 2, 5), (2, 3, 4), (4, 4, 9), (3, 1, 7)])
def test_apply_matches_numpy_twin_and_the_reference(dims):
    ke = _random_sym_ke()
    nx, ny, nz = dims
    g = np.random.default_rng(42).normal(size=(nz + 1, ny + 1, nx + 1, 3))
    want = stencil_apply_np(ke, g, dims)
    got = nat.stencil_apply_host(ke, g, dims)
    assert np.max(np.abs(got - want)) <= 1e-13 * np.max(np.abs(want))
    assert np.array_equal(got, jnat.stencil_apply_host(ke, g, dims))
    # tensors are taken as they are
    assert np.array_equal(nat.stencil_apply_host(torch.as_tensor(ke), torch.as_tensor(g), dims), got)


def test_apply_real_hex8_ke():
    mat = ftt.Material(E=10_000_000 * ftt.units.psi, nu=0.3)
    scene, dims = structured_scene(3, 3, 8, 0.1, 0.1, 1.0, mat, dtype=torch.float64, device="cpu")
    op = build_structured_operator(scene, dims, dtype=torch.float64)
    ke = op.ke.numpy()
    g = np.random.default_rng(7).normal(size=op.grid_shape + (3,))
    want = stencil_apply_np(ke, g, dims)
    got = nat.stencil_apply_host(ke, g, dims)
    assert np.max(np.abs(got - want)) <= 1e-12 * np.max(np.abs(want))
    assert np.array_equal(got, jnat.stencil_apply_host(ke, g, dims))
    # and the operator's own raw apply (the plain version of K2)
    assert np.max(np.abs(op.apply_raw(torch.as_tensor(g).reshape(-1, 3)).numpy().reshape(g.shape) - got)) <= (
        1e-12 * np.max(np.abs(want)))


def test_fused_residual_matches_composition():
    ke = _random_sym_ke(3)
    dims = (4, 3, 6)
    nx, ny, nz = dims
    shape = (nz + 1, ny + 1, nx + 1, 3)
    rng = np.random.default_rng(11)
    u = rng.normal(size=shape)
    b = rng.normal(size=shape)
    free = (rng.uniform(size=shape) > 0.2).astype(np.float64)
    r, rn, au = nat.stencil_residual_host(ke, u, b, free, dims)
    want_au = stencil_apply_np(ke, u, dims)
    want_r = (free * (b - want_au)).reshape(-1, 3)
    scale = np.max(np.abs(want_au))
    assert np.max(np.abs(au - want_au.reshape(-1, 3))) <= 1e-13 * scale
    assert np.max(np.abs(r - want_r)) <= 1e-13 * scale
    assert abs(rn - np.linalg.norm(want_r)) <= 1e-12 * np.linalg.norm(want_r)
    jr, jrn, jau = jnat.stencil_residual_host(ke, u, b, free, dims)
    assert np.array_equal(r, jr) and rn == jrn and np.array_equal(au, jau)


def test_weight_table_existence_rule():
    W = nat.region_weight_table(_random_sym_ke(5))
    assert np.array_equal(W, jnat.region_weight_table(_random_sym_ke(5)))
    W = W.reshape(3, 3, 3, 3, 3, 3, 3, 3)
    assert np.all(W[0, :, :, 0, :, :] == 0.0)  # rz=0, dz=-1
    assert np.all(W[:, 0, :, :, 0, :] == 0.0)
    assert np.all(W[:, :, 0, :, :, 0] == 0.0)
    assert np.all(W[2, :, :, 2, :, :] == 0.0)  # rz=2, dz=+1
    assert np.all(W[:, 2, :, :, 2, :] == 0.0)
    assert np.all(W[:, :, 2, :, :, 2] == 0.0)


def test_var_stencil_matches_the_plain_curvilinear_apply():
    rng = np.random.default_rng(5)
    dims = (3, 4, 6)
    nodes, _ = ftt.mesh.box_hex_mesh(*dims, 0.3, 0.4, 0.6)
    lo, hi = nodes.min(0), nodes.max(0)
    interior = (nodes > lo + 1e-9) & (nodes < hi - 1e-9)
    nodes = nodes + 0.2 * 0.1 * rng.uniform(-1, 1, nodes.shape) * interior
    w, _ = assemble_curv_weights(torch.as_tensor(nodes), dims, ftt.Material(E=1e7, nu=0.3))
    Z, Y, X = dims[2] + 1, dims[1] + 1, dims[0] + 1
    g = rng.standard_normal((Z, Y, X, 3))
    want = curv_apply_grid(w, torch.as_tensor(g)).numpy()
    Wn = nat.pack_var_weights(grid_view(w))
    got = nat.var_stencil_apply_host(Wn, g)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-13 * scale
    assert np.array_equal(got, jnat.var_stencil_apply_host(jnat.pack_var_weights(grid_view(w).numpy()), g))
    b = rng.standard_normal((Z, Y, X, 3))
    free = (rng.uniform(size=(Z, Y, X, 3)) > 0.2).astype(np.float64)
    r, rn, au = nat.var_stencil_residual_host(Wn, g, b, free)
    r_want = (free * (b - want)).reshape(-1, 3)
    assert np.abs(au - want.reshape(-1, 3)).max() <= 1e-13 * scale
    assert np.abs(r - r_want).max() <= 1e-13 * max(scale, np.abs(b).max())
    assert rn == pytest.approx(float(np.linalg.norm(r_want)), rel=1e-12)


def test_slab_residual_matches_full():
    rng = np.random.default_rng(9)
    dims = (4, 3, 11)
    nx, ny, nz = dims
    Z, Y, X = nz + 1, ny + 1, nx + 1
    ke = _random_sym_ke(9)
    u = rng.standard_normal((Z, Y, X, 3))
    b = rng.standard_normal((Z, Y, X, 3))
    free = (rng.uniform(size=(Z, Y, X, 3)) > 0.2).astype(np.float64)
    r_w, rn_w, au_w = nat.stencil_residual_host(ke, u, b, free, dims)
    r_np = np.empty((Z, Y, X, 3))
    au_np = np.empty_like(r_np)
    nrm2 = 0.0
    for z0 in range(0, Z, 3):
        z1 = min(z0 + 3, Z)
        g0, g1 = max(z0 - 1, 0), min(z1 + 1, Z)
        nrm2 += nat.stencil_residual_slab_host(ke, u[g0:g1], b[z0:z1], free[z0:z1], r_np[z0:z1], au_np[z0:z1],
                                               dims, z0, g0)
    assert np.array_equal(r_np.reshape(-1, 3), r_w)
    assert np.array_equal(au_np.reshape(-1, 3), au_w)
    assert np.sqrt(nrm2) == pytest.approx(rn_w, rel=1e-14)


def test_without_the_library(monkeypatch):
    """A library caller never needs a compiler: the apply takes the NumPy
    twin and the fused functions return None."""
    monkeypatch.setattr(nat, "get_lib", lambda: None)
    assert not nat.available()
    ke = _random_sym_ke(1)
    g = np.random.default_rng(1).normal(size=(3, 3, 3, 3))
    assert np.array_equal(nat.stencil_apply_host(ke, g, (2, 2, 2)), stencil_apply_np(ke, g, (2, 2, 2)))
    assert nat.stencil_residual_host(ke, g, g, np.ones_like(g), (2, 2, 2)) is None
    assert nat.var_stencil_apply_host(np.zeros((3, 3, 3, 27, 3, 3)), g) is None
