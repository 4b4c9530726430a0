"""K1, K2, K4, K5, K6 and K7 on the card against their plain version (f64)
on the card.

Needs a CUDA card and nvcc; skips without a card. This file imports
neither JAX nor fea_tpu, so it runs where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from fea_tpu_torch.elements.hex8 import stiffness_matrix_np
from fea_tpu_torch.materials import Material
from fea_tpu_torch.ops import cuda_stencil
from fea_tpu_torch.ops.cuda_stencil import stencil_apply, stencil_weights
from fea_tpu_torch.ops.structured import stencil_apply_grid

# K1: f32 rounding of inputs, weights and sums (tests/test_pallas.py's
# bound); K2: f64, another summation order than the plain version
BOUNDS = {torch.float32: ("f32", 2e-5), torch.float64: ("f64", 1e-12)}


@pytest.mark.cuda
@pytest.mark.parametrize("dims", [(1, 1, 1), (3, 2, 5), (4, 4, 8), (16, 16, 160)])
def test_kernels_match_plain_version_on_card(dims):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1 and K2 have no CPU mode")
    nx, ny, nz = dims
    corners = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                        [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]], np.float64) * 0.01
    ke = stiffness_matrix_np(corners, Material(E=1e7, nu=0.3))
    g64 = torch.as_tensor(np.random.default_rng(6).normal(size=(nz + 1, ny + 1, nx + 1, 3)), device="cuda")
    want = stencil_apply_grid(torch.as_tensor(ke, device="cuda"), g64, dims)
    for dt, (key, bound) in BOUNDS.items():
        n0 = cuda_stencil.LAUNCHES[key]
        got = stencil_apply(stencil_weights(ke, dt, "cuda"), g64.to(dt).contiguous())
        torch.cuda.synchronize()
        assert cuda_stencil.LAUNCHES[key] == n0 + 1
        rel = float((got.double() - want).abs().max() / want.abs().max())
        assert rel < bound, (dims, key, rel)


@pytest.mark.cuda
@pytest.mark.parametrize("dims", [(1, 1, 1), (3, 4, 6), (8, 8, 32), (20, 20, 80)])
def test_var_kernels_match_plain_version_on_card(dims):
    """K4 (f32) and K5 (f64) against the plain version in f64, on random
    weights and input."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K4 and K5 have no CPU mode")
    from fea_tpu_torch.ops import cuda_varstencil
    from fea_tpu_torch.ops.curvilinear import curv_apply_grid

    nx, ny, nz = dims
    rng = np.random.default_rng(8)
    w64 = torch.as_tensor(rng.normal(size=(27, 3, 3, nz + 1, ny + 1, nx + 1)), device="cuda")
    g64 = torch.as_tensor(rng.normal(size=(nz + 1, ny + 1, nx + 1, 3)), device="cuda")
    want = curv_apply_grid(w64, g64)
    for dt, bound in ((torch.float32, 2e-5), (torch.float64, 1e-12)):
        key = "var_f32" if dt == torch.float32 else "var_f64"
        n0 = cuda_varstencil.LAUNCHES[key]
        got = cuda_varstencil.var_apply(w64.to(dt).contiguous(), g64.to(dt).contiguous())
        torch.cuda.synchronize()
        assert cuda_varstencil.LAUNCHES[key] == n0 + 1
        rel = float((got.double() - want).abs().max() / want.abs().max())
        assert rel < bound, (dims, key, rel)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [4, 6, 24])
@pytest.mark.parametrize("E", [1, 700, 1030])
def test_element_apply_kernels_match_plain_version_on_card(k, E):
    """K6 (stored Ke batch) and K7 (one shared Ke) in f32 and f64 against
    their plain versions in f64, at the k of beams and 2D bars (4), 3D
    bars (6) and hex8 (24); each call launches its kernel once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K6 and K7 have no CPU mode")
    from fea_tpu_torch.ops import cuda_apply

    rng = np.random.default_rng(10 * k + E)
    ke_s = torch.as_tensor(rng.normal(size=(E, k, k)), device="cuda")
    ke_u = torch.as_tensor(rng.normal(size=(k, k)), device="cuda")
    u = torch.as_tensor(rng.normal(size=(E, k)), device="cuda")
    cases = (
        ("stored", cuda_apply.batched_matvec_stored, ke_s, cuda_apply.batched_matvec_stored_plain(ke_s, u)),
        ("uniform", cuda_apply.batched_matvec_uniform, ke_u, cuda_apply.batched_matvec_uniform_plain(ke_u, u)),
    )
    for kind, fn, ke, want in cases:
        for dt, bound in ((torch.float32, 2e-5), (torch.float64, 1e-12)):
            key = f"{kind}_{'f32' if dt == torch.float32 else 'f64'}"
            n0 = cuda_apply.LAUNCHES[key]
            got = fn(ke.to(dt).contiguous(), u.to(dt).contiguous())
            torch.cuda.synchronize()
            assert cuda_apply.LAUNCHES[key] == n0 + 1
            assert got.dtype == dt and got.shape == (E, k)
            rel = float((got.double() - want).abs().max() / want.abs().max())
            assert rel < bound, (kind, key, k, E, rel)
