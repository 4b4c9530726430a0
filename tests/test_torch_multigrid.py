"""Port parity: the multigrid hierarchy and V-cycle of fea_tpu_torch
against fea_tpu.ops.multigrid, on a 4x4x8 cantilever with more than one
level."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fea_tpu as ft
from fea_tpu.ops.multigrid import _build_hierarchy_host as jax_build_hierarchy_host
from fea_tpu.ops.multigrid import build_multigrid as jax_build_multigrid
from fea_tpu.ops.structured import build_structured_operator as jax_build_structured_operator
from fea_tpu.ops.structured import structured_scene as jax_structured_scene

import fea_tpu_torch as ftt
from fea_tpu_torch.ops.multigrid import (
    MultigridPreconditioner,
    _build_hierarchy_host,
    _prolong,
    _restrict,
    build_multigrid,
)
from fea_tpu_torch.ops.structured import build_structured_operator
from torch_pin import one_torch_thread  # noqa: F401

MAT = dict(E=1e7, nu=0.3)
DIMS = (4, 4, 8)


def _ops():
    """The f64 structured operators of one cantilever, in both packages."""
    jsc, dims = jax_structured_scene(*DIMS, 0.1, 0.1, 0.5, ft.Material(**MAT), dtype=jnp.float64)
    tsc = ftt.scene_from_numpy(
        np.asarray(jsc.nodes), np.asarray(jsc.elements), np.asarray(jsc.fixed),
        np.asarray(jsc.loads), MAT["E"], MAT["nu"], device="cpu",
    )
    return (
        jax_build_structured_operator(jsc, dims, dtype=jnp.float64),
        build_structured_operator(tsc, dims, dtype=torch.float64),
    )


def test_host_hierarchy_is_bitwise_the_reference():
    jop, top = _ops()
    kw = dict(coarse_dof_limit=100, small_level_dof=0)
    jl, jinv = jax_build_hierarchy_host(jop.astype(jnp.float32), dtype=jnp.float32, **kw)
    tl, tinv = _build_hierarchy_host(top.astype(torch.float32), dtype=torch.float32, **kw)
    assert len(tl) == len(jl) == 3
    for a, b in zip(tl, jl):
        for key in ("ke", "free", "inv_diag", "inv_tab"):
            assert np.array_equal(a[key], b[key]), key
        assert a["lam"] == b["lam"] and a["dims"] == b["dims"]
        assert str(a["dtype"]).replace("torch.", "") == np.dtype(b["dtype"]).name
    assert np.array_equal(tinv, jinv)


def test_prolong_restrict_match_jax(rng):
    from fea_tpu.ops.multigrid import _prolong as jp
    from fea_tpu.ops.multigrid import _restrict as jr

    c = rng.normal(size=(3, 4, 2, 3))
    f = rng.normal(size=(5, 7, 3, 3))
    assert np.array_equal(_prolong(torch.as_tensor(c)).numpy(), np.asarray(jp(jnp.asarray(c))))
    assert np.array_equal(_restrict(torch.as_tensor(f)).numpy(), np.asarray(jr(jnp.asarray(f))))
    # the extruded hierarchy's (L, n2, 3) fields, along the layer axis only
    c3 = rng.normal(size=(5, 7, 3))
    f3 = rng.normal(size=(9, 7, 3))
    assert np.array_equal(_prolong(torch.as_tensor(c3), axes=(0,)).numpy(),
                          np.asarray(jp(jnp.asarray(c3), axes=(0,))))
    assert np.array_equal(_restrict(torch.as_tensor(f3), axes=(0,)).numpy(),
                          np.asarray(jr(jnp.asarray(f3), axes=(0,))))


@pytest.mark.parametrize("small_level_dof", [0, 100_000])
def test_vcycle_matches_jax(small_level_dof):
    """One V-cycle of a random residual, through the reference's own
    hierarchy (``from_numpy``) and through the port's build; the default
    ``small_level_dof`` runs the coarse levels in f64 (K2's path)."""
    jop, top = _ops()
    kw = dict(degree=3, dtype=jnp.float32, small_level_dof=small_level_dof, coarse_dof_limit=100)
    mg_j = jax_build_multigrid(jop.astype(jnp.float32), **kw)
    Z, Y, X = top.grid_shape
    r = np.random.default_rng(7).normal(size=(Z * Y * X, 3)).astype(np.float32)
    want = np.asarray(mg_j(jnp.asarray(r)))
    levels, inv = jax_build_hierarchy_host(
        jop.astype(jnp.float32), coarse_dof_limit=100, dtype=jnp.float32, small_level_dof=small_level_dof
    )
    mg_from = MultigridPreconditioner.from_numpy(levels, inv, degree=3, device="cpu")
    mg_own = build_multigrid(
        top.astype(torch.float32), degree=3, dtype=torch.float32,
        small_level_dof=small_level_dof, coarse_dof_limit=100,
    )
    assert len(mg_own.levels) == 3
    for mg in (mg_from, mg_own):
        got = mg(torch.as_tensor(r)).numpy()
        assert got.dtype == np.float32
        # same math, another summation order: f32 rounding only
        assert np.allclose(got, want, rtol=2e-5, atol=2e-5 * np.abs(want).max())


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 2e-5)], ids=["f64", "f32"])
def test_masked_operator_matches_jax(dtype, tol):
    """``StructuredOperator.apply`` (the stencil wrapper's masked form) on
    a seeded vector against the JAX operator's: f64 to 1e-12 of max|out|,
    f32 to 2e-5 (f32 rounding)."""
    jop, top = _ops()
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    x = np.random.default_rng(3).normal(size=(top.n_nodes, 3))
    want = np.asarray(jop.astype(jdt).apply(jnp.asarray(x, jdt)), np.float64)
    got = top.astype(dtype).apply(torch.as_tensor(x).to(dtype))
    assert got.dtype == dtype
    assert np.abs(got.double().numpy() - want).max() <= tol * np.abs(want).max()
    # the fixed DOFs pass through
    fixed = top.free.numpy() == 0
    assert np.array_equal(got.numpy()[fixed], x.astype(got.numpy().dtype)[fixed])


def test_level_apply_is_the_unfused_masked_expression():
    """Every level of the hierarchy applies F K(F g) + (1 - F) g through
    the wrapper's masked form: value for value the expression written out
    around the raw apply, in the level's dtype."""
    from fea_tpu_torch.ops.cuda_stencil import stencil_apply

    _, top = _ops()
    mg = build_multigrid(top.astype(torch.float32), degree=3, dtype=torch.float32, coarse_dof_limit=100)
    assert {lv.dtype for lv in mg.levels} == {torch.float32, torch.float64}
    rng = np.random.default_rng(4)
    for lv in mg.levels:
        g = torch.as_tensor(rng.normal(size=tuple(lv.free.shape))).to(lv.dtype)
        F = lv.free
        assert torch.equal(lv.apply(g), F * stencil_apply(lv.weights, F * g) + (1.0 - F) * g)


def test_level_rejects_a_mask_that_is_not_zero_or_one():
    _, top = _ops()
    levels, inv = _build_hierarchy_host(top.astype(torch.float32), dtype=torch.float32, coarse_dof_limit=100)
    levels[0] = dict(levels[0], free=levels[0]["free"] * 0.5)
    with pytest.raises(ValueError, match="0 and 1"):
        MultigridPreconditioner.from_numpy(levels, inv, degree=3, device="cpu")
