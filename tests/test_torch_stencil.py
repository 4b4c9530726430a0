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
from torch_pin import one_torch_thread  # noqa: F401

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


# -- the masked form: F * K(F * g) + (1 - F) * g in the wrapper's one call ----

ODD_DIMS = [(13, 7, 29), (5, 3, 9)]  # element counts odd and unequal on every axis


def _mask(dims, seed, dtype=np.float64):
    nx, ny, nz = dims
    return (np.random.default_rng(seed).random((nz + 1, ny + 1, nx + 1, 3)) < 0.8).astype(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("dims", ODD_DIMS + [(300, 2, 3)], ids=["13x7x29", "5x3x9", "300x2x3"])
def test_masked_apply_is_the_unfused_expression(dims, dtype):
    ke = _ke(dims)
    g = torch.as_tensor(_grid(dims, 6)).to(dtype)
    F = torch.as_tensor(_mask(dims, 7)).to(dtype)
    w = stencil_weights(ke, dtype, "cpu")
    got = stencil_apply(w, g, F)
    assert got.dtype == dtype and got.shape == g.shape
    assert torch.equal(got, F * stencil_apply(w, F * g) + (1.0 - F) * g)
    # a fixed DOF passes through, a free one sees only free neighbours
    assert torch.equal(got[F == 0], g[F == 0])
    assert torch.equal(stencil_apply_grid(w.ke, g, dims, F), got)


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12), (np.float32, 2e-5)], ids=["f64", "f32"])
def test_masked_apply_matches_jax_masked_level(dtype, tol):
    """The JAX package's masked level operator (``transposed._LevelT.apply``
    through its plain reference, as it runs on the CPU) on the same seeded
    grid and mask: f64 to 1e-12 of max|out| (another summation order), f32
    to 2e-5 (f32 rounding of inputs, weights and sums)."""
    from fea_tpu.ops.transposed import _LevelT

    dims = (5, 3, 9)
    ke, g, F = _ke(dims).astype(dtype), _grid(dims, 8).astype(dtype), _mask(dims, 9, dtype)
    level = _LevelT(ke=jnp.asarray(ke), free=t_of_grid(jnp.asarray(F)), inv_diag=t_of_grid(jnp.asarray(F)),
                    lam_max=jnp.asarray(1.0), use_pallas=False)
    want = np.asarray(grid_of_t(level.apply(t_of_grid(jnp.asarray(g)))))
    assert want.dtype == dtype
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    got = stencil_apply(stencil_weights(_ke(dims), tdt, "cpu"), torch.as_tensor(g), torch.as_tensor(F)).numpy()
    assert _rel(got.astype(np.float64), want.astype(np.float64)) < tol


@pytest.mark.parametrize("n", [1, 2, 3, 5])
def test_masked_chunked_apply_is_the_masked_apply(n):
    """The chunked form hands each slab its planes of the mask: the same
    values as the whole-grid masked apply (1e-13: the slabs' plain version
    sums whole element layers, in another order at a slab's ends)."""
    dims = (5, 3, 9)
    w = stencil_weights(_ke(dims), torch.float64, "cpu")
    g, F = torch.as_tensor(_grid(dims, 10)), torch.as_tensor(_mask(dims, 11))
    got = cuda_stencil.stencil_apply_chunked(w, g, n, F).numpy()
    assert _rel(got, stencil_apply(w, g, F).numpy()) < 1e-13


def test_free_mask_must_be_zero_or_one():
    ok = torch.as_tensor(_mask((3, 2, 5), 12))
    assert cuda_stencil.check_free_mask(ok) is ok
    assert cuda_stencil.check_free_mask(ok.to(torch.float32)).dtype == torch.float32
    for bad in (0.5, 2.0, -1.0, float("nan")):
        t = ok.clone()
        t[1, 1, 1, 1] = bad
        with pytest.raises(ValueError):
            cuda_stencil.check_free_mask(t)


def test_wrapper_rejects_a_mask_that_does_not_match():
    dims = (3, 2, 5)
    w = stencil_weights(_ke(dims), torch.float64, "cpu")
    g, F = torch.as_tensor(_grid(dims, 13)), torch.as_tensor(_mask(dims, 14))
    with pytest.raises(TypeError):
        stencil_apply(w, g, F.to(torch.float32))
    with pytest.raises(ValueError):
        stencil_apply(w, g, F[..., 0])
    with pytest.raises(ValueError):
        stencil_apply(w, g, F[:-1])
    with pytest.raises(ValueError):
        cuda_stencil.stencil_apply_slab(w, g, 0, 6, F[:-1])
    with pytest.raises(ValueError):
        cuda_stencil.stencil_apply_chunked(w, g, 2, F[:, :, :-1])


def test_launch_checks_reject_what_the_kernel_does_not_take():
    """The checks that stand before every launch, on CPU tensors (they read
    only shapes, strides and addresses): an output that shares memory with
    an input, a tensor that is not contiguous. A row wider than a block of
    the kernel passes: the kernel cuts it into segments."""
    dims = (3, 2, 5)
    w = stencil_weights(_ke(dims), torch.float64, "cpu")
    g, F = torch.as_tensor(_grid(dims, 15)), torch.as_tensor(_mask(dims, 16))
    check = cuda_stencil._check_launch
    check("k", w.table, g, torch.empty_like(g), F)  # passes
    with pytest.raises(ValueError, match="alias"):
        check("k", w.table, g, g, None)
    with pytest.raises(ValueError, match="alias"):
        check("k", w.table, g, g[1:], None)  # a view into the input's planes
    with pytest.raises(ValueError, match="alias"):
        check("k", w.table, g, F, F)
    with pytest.raises(ValueError, match="contiguous"):
        check("k", w.table, g.transpose(1, 2), torch.empty_like(g), None)
    with pytest.raises(ValueError, match="contiguous"):
        check("k", w.table, g, torch.empty_like(g), F.transpose(1, 2))
    wide = torch.zeros((2, 2, 301, 3), dtype=torch.float64)
    check("k", w.table, wide, torch.empty_like(wide), torch.ones_like(wide))
