"""The curvilinear hierarchy's coarsest level, made on the field's device:
its masked dense matrix (``ops/curvilinear.py::_dense_from_w``) against the
reference's host scatter ``fea_tpu.ops.curvilinear._dense_from_w_np``, and
its inverse (Cholesky, or LU for a matrix that is not positive definite)
against NumPy's, with the counters that say which branch a build took.

The scenes: a distorted (8, 8, 32) cantilever (coarsest level (4, 4, 16),
1,275 DOF) and the same grid as an embedded L-domain (void cells add no
weight, their DOFs held), each built by the port on the CPU.
"""
import numpy as np
import pytest
import torch

from fea_tpu.ops import curvilinear as jcv

from fea_tpu_torch.materials import Material
from fea_tpu_torch.mesh import box_hex_mesh
from fea_tpu_torch.ops import curvilinear as cv
from fea_tpu_torch.utils import counters
from torch_pin import one_torch_thread  # noqa: F401

DIMS = (8, 8, 32)


def _scene(pattern):
    """(fine weight field, (N, 3) free mask) of the distorted grid: the
    cantilever, or the L-domain that keeps every cell but those with
    x and z both past the middle."""
    nx, ny, nz = DIMS
    lz = 0.1 * nz / nx
    nodes, _ = box_hex_mesh(nx, ny, nz, 0.1, 0.12, lz)
    interior = (nodes[:, 2] > 0) & (nodes[:, 2] < lz)
    nodes = nodes + 0.25 * (0.1 / nx) * np.random.default_rng(7).uniform(-1, 1, nodes.shape) * interior[:, None]
    fixed = np.zeros(nodes.shape)
    fixed[np.isclose(nodes[:, 2], 0.0)] = 1.0
    valid = None
    if pattern == "embedded":
        iz, _, ix = np.meshgrid(np.arange(nz), np.arange(ny), np.arange(nx), indexing="ij")
        valid = ~((ix >= nx // 2) & (iz >= nz // 2))
        touched = np.zeros((nz + 1, ny + 1, nx + 1), bool)
        for dz in (0, 1):
            for dy in (0, 1):
                for dx in (0, 1):
                    touched[dz:dz + nz, dy:dy + ny, dx:dx + nx] |= valid
        fixed[~touched.reshape(-1)] = 1.0
        assert 0 < (~touched).sum() < touched.size
    w, _ = cv.assemble_curv_weights(torch.as_tensor(nodes), DIMS, Material(E=1e7, nu=0.3), valid=valid)
    return w, 1.0 - fixed


def _coarsest(pattern):
    """The built hierarchy, the coarsest level's f64 field and free grid,
    and the counters' change over the build."""
    w, free = _scene(pattern)
    before = counters()
    mg = cv.build_curv_multigrid(w, DIMS, free)
    after = counters()
    grown = {k: after.get(k, 0) - before.get(k, 0) for k in ("curv.coarse.cholesky", "curv.coarse.lu")}
    level = mg.levels[-1]
    assert level.dims == (4, 4, 16) and level.w.dtype == torch.float64
    return mg, level.w, level.free, grown


@pytest.mark.parametrize("pattern", ["cantilever", "embedded"])
def test_dense_matrix_is_the_reference_bit_for_bit(pattern):
    _, w, free, _ = _coarsest(pattern)
    got = cv._dense_from_w(w, free)
    want = jcv._dense_from_w_np(cv.grid_view(w).numpy(), free.numpy())
    assert got.shape == (1275, 1275) and got.dtype == torch.float64
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("pattern", ["cantilever", "embedded"])
def test_coarse_inverse_is_numpys_and_takes_cholesky(pattern):
    mg, w, free, grown = _coarsest(pattern)
    K = jcv._dense_from_w_np(cv.grid_view(w).numpy(), free.numpy())
    want = np.linalg.inv(K)
    got = mg.coarse_inv.numpy()
    assert mg.coarse_inv.dtype == torch.float64 and mg.coarse_inv.device == w.device
    assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max()
    assert np.abs(K @ got - np.eye(len(K))).max() <= 1e-9
    assert grown == {"curv.coarse.cholesky": 1, "curv.coarse.lu": 0}


@pytest.mark.parametrize("dims", [(1, 1, 2), (2, 3, 4)])
def test_indefinite_coarse_matrix_falls_back_to_lu(dims):
    """A random block-symmetric field (its centre blocks symmetric too)
    gives a symmetric, indefinite, nonsingular matrix: Cholesky fails,
    the build counts ``curv.coarse.lu`` and inverts by LU."""
    nx, ny, nz = dims
    w = torch.as_tensor(np.random.default_rng(5).normal(size=(27, 3, 3, nz + 1, ny + 1, nx + 1)))
    w[13] = 0.5 * (w[13] + w[13].transpose(0, 1))
    cv.symmetrize_field(w)
    free = np.ones(((nz + 1) * (ny + 1) * (nx + 1), 3))
    free[0] = 0.0
    before = counters()
    mg = cv.build_curv_multigrid(w, dims, free)
    after = counters()
    assert {k: after.get(k, 0) - before.get(k, 0) for k in ("curv.coarse.cholesky", "curv.coarse.lu")} == {
        "curv.coarse.cholesky": 0, "curv.coarse.lu": 1}
    K = jcv._dense_from_w_np(cv.grid_view(w).numpy(), free.reshape(nz + 1, ny + 1, nx + 1, 3))
    eig = np.linalg.eigvalsh(K)
    assert eig.min() < 0 < eig.max() and np.abs(eig).min() > 1e-6 * np.abs(eig).max()
    want = np.linalg.inv(K)
    assert np.abs(mg.coarse_inv.numpy() - want).max() <= 1e-10 * np.abs(want).max()
