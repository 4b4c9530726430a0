"""Port parity: the structured stencil of fea_tpu_torch against fea_tpu.

The port's plain stencil (the CPU path of the K1/K2 wrapper) is held
against the JAX stencil, the NumPy f64 oracle, the JAX Pallas K1 kernel
in interpret mode, and the plain reference of the JAX K2 kernel. Inputs
come from seeded NumPy; tolerances are stated per assertion.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fea_tpu as ft
from fea_tpu.native import region_weight_table as jax_region_weight_table
from fea_tpu.ops.pallas_stencil import stencil_apply_transposed
from fea_tpu.ops.structured import stencil_apply_grid as jax_stencil_apply_grid
from fea_tpu.ops.structured import stencil_apply_np as jax_stencil_apply_np
from fea_tpu.ops.structured import structured_scene as jax_structured_scene
from fea_tpu.ops.transposed import grid_of_t, stencil_apply_grid_T, t_of_grid

from fea_tpu_torch.elements.hex8 import stiffness_matrix_np
from fea_tpu_torch.materials import Material
from fea_tpu_torch.ops import cuda_stencil
from fea_tpu_torch.ops.cuda_stencil import region_weight_table, stencil_apply, stencil_weights
from fea_tpu_torch.ops.structured import stencil_apply_grid, stencil_apply_np

DIMS = [(3, 2, 5), (1, 1, 1), (4, 4, 8)]


def _ke(dims):
    """The reference Ke of a 0.3 x 0.2 x 0.5 box cut into ``dims`` voxels."""
    nx, ny, nz = dims
    h = (0.3 / nx, 0.2 / ny, 0.5 / nz)
    corners = np.array(
        [[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
         [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]], np.float64
    ) * np.array(h)
    return stiffness_matrix_np(corners, Material(E=1e7, nu=0.3))


def _grid(dims, seed):
    nx, ny, nz = dims
    return np.random.default_rng(seed).normal(size=(nz + 1, ny + 1, nx + 1, 3))


def _rel(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def test_region_table_equals_native_table():
    ke = _ke((3, 2, 5))
    assert np.array_equal(region_weight_table(ke), jax_region_weight_table(ke))


def test_ke_matches_jax_structured_operator():
    from fea_tpu.ops.structured import build_structured_operator

    for dims in DIMS:
        scene, _ = jax_structured_scene(*dims, 0.3, 0.2, 0.5, ft.Material(E=1e7, nu=0.3), dtype=jnp.float64)
        ke_jax = np.asarray(build_structured_operator(scene, dims, dtype=jnp.float64).ke)
        # one-element integration of the same corners: round-off only
        assert _rel(_ke(dims), ke_jax) < 1e-14


@pytest.mark.parametrize("dims", DIMS)
def test_f64_apply_matches_jax_and_oracle(dims):
    ke, g = _ke(dims), _grid(dims, 1)
    got = stencil_apply_grid(torch.as_tensor(ke), torch.as_tensor(g), dims).numpy()
    # f64 with another summation order: 1e-13 relative to max|K u|
    assert _rel(got, np.asarray(jax_stencil_apply_grid(jnp.asarray(ke), jnp.asarray(g), dims))) < 1e-13
    assert _rel(got, jax_stencil_apply_np(ke, g, dims)) < 1e-13
    assert np.array_equal(stencil_apply_np(ke, g, dims), jax_stencil_apply_np(ke, g, dims))


@pytest.mark.parametrize("dims", DIMS)
def test_f64_apply_matches_k2_plain_reference(dims):
    """K2's plain reference in the JAX package is the transposed-layout
    f64 pad-add (its interpret-mode dd kernel is a slow test there)."""
    ke, g = _ke(dims), _grid(dims, 2)
    w = stencil_weights(ke, torch.float64, "cpu")
    got = stencil_apply(w, torch.as_tensor(g)).numpy()
    want = np.asarray(grid_of_t(stencil_apply_grid_T(jnp.asarray(ke), t_of_grid(jnp.asarray(g)))))
    assert _rel(got, want) < 1e-13


@pytest.mark.parametrize("dims", DIMS)
def test_f32_apply_matches_oracle(dims):
    ke, g = _ke(dims), _grid(dims, 3).astype(np.float32)
    got = stencil_apply(stencil_weights(ke, torch.float32, "cpu"), torch.as_tensor(g)).numpy()
    # f32 rounding of inputs, weights and sums: the bound of test_pallas.py
    assert _rel(got.astype(np.float64), jax_stencil_apply_np(ke, g.astype(np.float64), dims)) < 2e-5


def test_f32_apply_matches_pallas_k1():
    """K1 itself, in interpret mode, on odd and even extents (each shape
    costs an interpret-mode compile, so one shape here; test_pallas.py
    holds K1 against the oracle on the others)."""
    dims = (3, 2, 5)
    ke, g = _ke(dims), _grid(dims, 3).astype(np.float32)
    got = stencil_apply(stencil_weights(ke, torch.float32, "cpu"), torch.as_tensor(g)).numpy()
    gT = jnp.asarray(np.transpose(g, (3, 1, 2, 0)))
    k1 = np.transpose(
        np.asarray(stencil_apply_transposed(jnp.asarray(ke, jnp.float32), gT, interpret=True)),
        (3, 1, 2, 0),
    )
    assert _rel(got.astype(np.float64), k1.astype(np.float64)) < 2e-5


def test_wrapper_routes_cpu_to_plain_version():
    dims = (3, 2, 5)
    ke, g = _ke(dims), torch.as_tensor(_grid(dims, 4))
    before = dict(cuda_stencil.LAUNCHES)
    for dt in (torch.float32, torch.float64):
        w = stencil_weights(ke, dt, "cpu")
        got = stencil_apply(w, g.to(dt))
        assert torch.equal(got, stencil_apply_grid(w.ke, g.to(dt), dims))
    # the counters count kernel launches only
    assert cuda_stencil.LAUNCHES == before


def test_wrapper_rejects_bad_input():
    dims = (3, 2, 5)
    ke = _ke(dims)
    g = torch.as_tensor(_grid(dims, 5))
    w64 = stencil_weights(ke, torch.float64, "cpu")
    with pytest.raises(TypeError):
        stencil_apply(stencil_weights(ke, torch.float64, "cpu"), g.to(torch.float16))
    with pytest.raises(TypeError):
        stencil_apply(stencil_weights(ke, torch.float32, "cpu"), g)  # weights f32, grid f64
    with pytest.raises(ValueError):
        stencil_apply(w64, g[..., :2])
    with pytest.raises(ValueError):
        stencil_apply(w64, g.reshape(-1, 3))
    with pytest.raises(ValueError):
        stencil_apply(w64, g[:1])
