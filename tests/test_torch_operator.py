"""Port parity, the element-by-element operator: the hex8 geometry path,
the beam and truss elements, assembly, the plain versions of K6/K7 and
every method of ``StiffnessOperator``, of fea_tpu_torch against fea_tpu.

Inputs come from NumPy seeds and go through both packages on the CPU in
f64 (f32 where a kernel's f32 form is checked); JAX's Pallas kernels run
in interpret mode, as tests/test_pallas.py runs them. f64 results agree
to 1e-12 relative to their largest entry: the same formulas in another
summation order.
"""
import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import fea_tpu as ft
from fea_tpu import assembly as jas
from fea_tpu.elements import beam as jbeam
from fea_tpu.elements import hex8 as jhex8
from fea_tpu.elements import truss as jtruss
from fea_tpu.ops import pallas_apply as jpa
from fea_tpu.scene import dof_ids as jax_dof_ids

import fea_tpu_torch as ftt
from fea_tpu_torch import assembly
from fea_tpu_torch.elements import beam, hex8, truss
from fea_tpu_torch.operator import operator_from_numpy
from fea_tpu_torch.ops import cuda_apply
from fea_tpu_torch.scene import dof_ids

from oracle import assemble_sparse
from torch_pin import one_torch_thread  # noqa: F401

MAT = dict(E=1e7, nu=0.3)
F64 = 1e-12


def close(got, want, rel=F64):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(np.max(np.abs(want)), 1e-300)
    err = np.max(np.abs(got - want)) / scale if want.size else 0.0
    assert err <= rel, err


def t(a):
    return torch.as_tensor(np.asarray(a))


def distorted_box(nx=2, ny=3, nz=4, seed=11):
    """A 2x3x4 box with interior nodes moved by up to a quarter cell, the
    first z layer fixed and a random load."""
    nodes, elements = ft.mesh.box_hex_mesh(nx, ny, nz, 0.2, 0.3, 0.4)
    rng = np.random.default_rng(seed)
    interior = (nodes[:, 2] > 0) & (nodes[:, 2] < 0.4)
    nodes = nodes + 0.025 * rng.uniform(-1, 1, nodes.shape) * interior[:, None]
    fixed = ft.fix_where(nodes, lambda q: q[:, 2] == 0.0, 3)
    loads = rng.normal(size=nodes.shape)
    presc = np.where(fixed, 1e-3 * rng.normal(size=nodes.shape), 0.0)
    return nodes, elements, fixed, loads, presc


def beam_arrays(n=7, seed=2):
    rng = np.random.default_rng(seed)
    x = np.cumsum(rng.uniform(0.1, 0.3, n + 1))[:, None]
    el = np.stack([np.arange(n), np.arange(n) + 1], axis=1)
    fixed = np.zeros((n + 1, 2), bool)
    fixed[0] = True
    fixed[-1, 0] = True
    return x, el, fixed, rng.normal(size=(n + 1, 2)), np.where(fixed, 1e-3 * rng.normal(size=(n + 1, 2)), 0.0)


def bar_arrays(dim, seed=3):
    """A small random truss: a fixed base and a free cloud above it."""
    rng = np.random.default_rng(seed)
    nodes = rng.uniform(0.0, 1.0, (8, dim))
    members = np.array([[0, 4], [1, 4], [2, 5], [3, 5], [4, 5], [4, 6], [5, 6], [6, 7], [5, 7], [0, 7],
                        [1, 6], [2, 7]])
    fixed = np.zeros((8, dim), bool)
    fixed[:4] = True
    return nodes, members, fixed, rng.normal(size=(8, dim)), np.where(fixed, 1e-3 * rng.normal(size=(8, dim)), 0.0)


def scene_pair(family, nodes, elements, fixed, loads, presc, section=None):
    mat = (1e7, 0.3) if family == "hex8" else (2e11, 0.0)
    jsc = ft.make_scene(nodes, elements, fixed, loads, ft.Material(*mat), family=family,
                        prescribed=presc, section=section, dtype=jnp.float64)
    tsc = ftt.scene_from_numpy(nodes, elements, fixed, loads, *mat, presc, family=family, section=section,
                               device="cpu")
    return jsc, tsc


def test_scene_from_numpy_carries_beams_and_bars():
    x, el, fixed, loads, presc = beam_arrays()
    jsc, tsc = scene_pair("eb_beam", x, el, fixed, loads, presc, section=np.float64(3e-6))
    assert tsc.family == "eb_beam" and tsc.n_dof == jsc.n_dof == 16
    assert float(tsc.section) == 3e-6
    nodes, members, fixed, loads, presc = bar_arrays(3)
    jsc, tsc = scene_pair("bar3d", nodes, members, fixed, loads, presc, section=np.full(12, 100.0))
    assert np.array_equal(tsc.section.numpy(), np.asarray(jsc.section))
    assert np.array_equal(dof_ids(tsc.elements, 3).numpy(), np.asarray(jax_dof_ids(jsc.elements, 3)))


def test_hex8_geometry_path_matches_jax(rng):
    nodes, elements, *_ = distorted_box()
    jmat, tmat = ft.Material(**MAT), ftt.Material(**MAT)
    jg = jhex8.precompute_geometry(jnp.asarray(nodes), jnp.asarray(elements), dtype=jnp.float64)
    tg = hex8.precompute_geometry(t(nodes), t(elements).long(), dtype=torch.float64)
    close(tg.grads, jg.grads)
    close(tg.wdetj, jg.wdetj)
    assert float(tg.min_detj) == pytest.approx(float(jg.min_detj), rel=F64)
    close(hex8.stiffness_matrices(t(nodes), t(elements), tmat, dtype=torch.float64),
          jhex8.stiffness_matrices(jnp.asarray(nodes), jnp.asarray(elements), jmat, dtype=jnp.float64))
    u_e = rng.normal(size=(elements.shape[0], 8, 3))
    close(hex8.apply_elements(tg, t(u_e), tmat), jhex8.apply_elements(jg, jnp.asarray(u_e), jmat))
    close(hex8.diagonal(tg, tmat), jhex8.diagonal(jg, jmat))
    close(hex8.block_diagonal(tg, tmat), jhex8.block_diagonal(jg, jmat))
    u = rng.normal(size=nodes.shape)
    teps, tsig = hex8.centroid_strain_stress(t(nodes), t(elements), t(u), tmat)
    jeps, jsig = jhex8.centroid_strain_stress(jnp.asarray(nodes), jnp.asarray(elements), jnp.asarray(u), jmat)
    close(teps, jeps)
    close(tsig, jsig)
    close(hex8.von_mises(tsig), jhex8.von_mises(jsig))


def test_beam_and_truss_elements_match_jax(rng):
    x, el, *_ = beam_arrays()
    inertia = rng.uniform(1e-6, 2e-6, el.shape[0])
    jmat, tmat = ft.Material(2e11, 0.0), ftt.Material(2e11, 0.0)
    close(beam.stiffness_matrices(t(x), t(el), tmat, t(inertia)),
          jbeam.stiffness_matrices(jnp.asarray(x), jnp.asarray(el), jmat, jnp.asarray(inertia)))
    close(beam.uniform_load_vector(t(x), t(el), 1000.0), jbeam.uniform_load_vector(jnp.asarray(x), jnp.asarray(el), 1000.0))
    u = rng.normal(size=(x.shape[0], 2))
    for got, want in zip(beam.moment_shear(t(x), t(el), t(u), tmat, 1e-6),
                         jbeam.moment_shear(jnp.asarray(x), jnp.asarray(el), jnp.asarray(u), jmat, 1e-6)):
        close(got, want)
    for dim in (2, 3):
        nodes, members, *_ = bar_arrays(dim)
        k = rng.uniform(50.0, 150.0, members.shape[0])
        close(truss.stiffness_matrices(t(nodes), t(members), t(k)),
              jtruss.stiffness_matrices(jnp.asarray(nodes), jnp.asarray(members), jnp.asarray(k)))
        d = 0.05 * rng.normal(size=nodes.shape)
        close(truss.internal_forces(t(nodes), t(members), t(d), t(k)),
              jtruss.internal_forces(jnp.asarray(nodes), jnp.asarray(members), jnp.asarray(d), jnp.asarray(k)))
        close(truss.member_forces(t(nodes), t(members), t(d), t(k)),
              jtruss.member_forces(jnp.asarray(nodes), jnp.asarray(members), jnp.asarray(d), jnp.asarray(k)))


def test_incidence_plan_matches_direct_scatter_and_jax(rng):
    nodes, elements, *_ = distorted_box()
    plan = assembly.build_incidence_plan(elements, 3, nodes.shape[0], dtype=torch.float64)
    jplan = jas.build_incidence_plan(elements, 3, nodes.shape[0])
    assert np.array_equal(plan.positions.numpy(), np.asarray(jplan.positions))
    assert np.array_equal(plan.mask.numpy(), np.asarray(jplan.mask))
    f_e = t(rng.normal(size=(elements.shape[0], 8, 3)))
    direct = assembly.scatter_add_direct(f_e, t(elements), nodes.shape[0])
    close(plan.scatter_add(f_e.reshape(-1)).reshape(-1, 3), direct, rel=1e-14)
    close(direct, jas.scatter_add_direct(jnp.asarray(f_e.numpy()), jnp.asarray(elements), nodes.shape[0]), rel=1e-14)


def test_assemble_dense_matches_jax_and_oracle():
    nodes, elements, *_ = distorted_box()
    ke = hex8.stiffness_matrices(t(nodes), t(elements), ftt.Material(**MAT), dtype=torch.float64)
    K = assembly.assemble_dense(ke, t(elements), 3, nodes.size)
    close(K, jas.assemble_dense(jnp.asarray(ke.numpy()), jnp.asarray(elements), 3, nodes.size))
    close(K, assemble_sparse(nodes, elements, MAT["E"], MAT["nu"]).toarray())
    coo = assembly.assemble_bcoo(ke, t(elements), 3, nodes.size)
    assert coo.is_coalesced()
    close(coo.to_dense(), K, rel=1e-14)


# -- K6 / K7: the plain versions the wrappers run on a CPU tensor ---------

@pytest.mark.parametrize("E", [700, 1030])
def test_plain_versions_match_jax_kernels_at_k24(E):
    rng = np.random.default_rng(E)
    k = 24
    ke_s, ke_u, u = rng.normal(size=(E, k, k)), rng.normal(size=(k, k)), rng.normal(size=(E, k))
    for np_dt, dt, rel in ((np.float32, torch.float32, 1e-5), (np.float64, torch.float64, F64)):
        want_s = jpa.batched_matvec_stored(jnp.asarray(ke_s, np_dt), jnp.asarray(u, np_dt), interpret=True)
        want_u = jpa.batched_matvec_uniform(jnp.asarray(ke_u, np_dt), jnp.asarray(u, np_dt), interpret=True)
        got_s = cuda_apply.batched_matvec_stored(t(ke_s).to(dt), t(u).to(dt))
        got_u = cuda_apply.batched_matvec_uniform(t(ke_u).to(dt), t(u).to(dt))
        assert got_s.dtype == got_u.dtype == dt
        close(got_s, want_s, rel)
        close(got_u, want_u, rel)


@pytest.mark.parametrize("k", [4, 6])
def test_plain_versions_match_einsum_at_beam_and_bar_k(k):
    """At k = 4 (beams, 2D bars) and 6 (3D bars) the plain versions are
    held against jnp.einsum, the contract of the JAX kernels, and never
    against JAX's stored kernel, which sums 24 columns whatever k is."""
    rng = np.random.default_rng(k)
    E = 37
    ke_s, ke_u, u = rng.normal(size=(E, k, k)), rng.normal(size=(k, k)), rng.normal(size=(E, k))
    close(cuda_apply.batched_matvec_stored(t(ke_s), t(u)), jnp.einsum("eab,eb->ea", ke_s, u))
    close(cuda_apply.batched_matvec_uniform(t(ke_u), t(u)), jnp.einsum("ab,eb->ea", ke_u, u))


def test_wrappers_take_the_plain_version_on_cpu_and_check_inputs():
    rng = np.random.default_rng(0)
    ke, u = t(rng.normal(size=(5, 6, 6))), t(rng.normal(size=(5, 6)))
    before = dict(cuda_apply.LAUNCHES)
    cuda_apply.batched_matvec_stored(ke, u)
    cuda_apply.batched_matvec_uniform(ke[0], u)
    assert cuda_apply.LAUNCHES == before  # no kernel ran
    with pytest.raises(TypeError, match="float32 nor float64"):
        cuda_apply.batched_matvec_stored(ke.half(), u.half())
    with pytest.raises(TypeError, match="ke is"):
        cuda_apply.batched_matvec_uniform(ke[0].float(), u)
    with pytest.raises(ValueError, match="ke must be"):
        cuda_apply.batched_matvec_stored(ke[:4], u)
    with pytest.raises(ValueError, match="k <= 32"):
        cuda_apply.batched_matvec_uniform(t(np.eye(33)), t(np.ones((2, 33))))
    with pytest.raises(ValueError, match="no kernel for device"):
        cuda_apply.batched_matvec_stored(ke.to("meta"), u.to("meta"))


# -- StiffnessOperator against fea_tpu's, every kind ----------------------

def _cases():
    nodes, elements, fixed, loads, presc = distorted_box()
    voxel_nodes, _ = ft.mesh.box_hex_mesh(2, 3, 4, 0.2, 0.3, 0.4)
    x, el, bfixed, bloads, bpresc = beam_arrays()
    n2, m2, f2, l2, p2 = bar_arrays(2)
    n3, m3, f3, l3, p3 = bar_arrays(3)
    return {
        "hex8_matfree": ("hex8", nodes, elements, fixed, loads, presc, None, dict(uniform=False)),
        "hex8_stored": ("hex8", nodes, elements, fixed, loads, presc, None, None),
        "hex8_uniform": ("hex8", voxel_nodes, elements, fixed, loads, presc, None, dict(uniform=True)),
        "eb_beam": ("eb_beam", x, el, bfixed, bloads, bpresc, np.float64(2e-6), {}),
        "bar2d": ("bar2d", n2, m2, f2, l2, p2, np.linspace(50.0, 150.0, 12), {}),
        "bar3d": ("bar3d", n3, m3, f3, l3, p3, np.linspace(50.0, 150.0, 12), {}),
    }


CASES = _cases()


def _check_operator(top, jop, presc, rng):
    x = rng.normal(size=tuple(jop.free.shape))
    close(top.apply_raw(t(x)), jop.apply_raw(jnp.asarray(x)))
    close(top.apply(t(x)), jop.apply(jnp.asarray(x)))
    loads = rng.normal(size=x.shape)
    close(top.rhs(t(loads), t(presc)), jop.rhs(jnp.asarray(loads), jnp.asarray(presc)))
    close(top.diag_raw(), jop.diag_raw())
    close(top.diag_masked(), jop.diag_masked())
    close(top.block_diag_raw(), jop.block_diag_raw())
    close(top.block_diag_inv_masked(), jop.block_diag_inv_masked())
    close(top.element_matrices(), jop.element_matrices())
    close(top.dense(), jop.dense())


@pytest.mark.parametrize("case", sorted(CASES))
def test_operator_matches_jax(case):
    family, nodes, elements, fixed, loads, presc, section, build_kw = CASES[case]
    jsc, tsc = scene_pair(family, nodes, elements, fixed, loads, presc, section)
    rng = np.random.default_rng(len(case))
    if build_kw is None:  # a stored hex8 operator, as a caller would prebuild it
        jm = ft.build_operator(jsc, dtype=jnp.float64, uniform=False)
        jop = ft.StiffnessOperator(elements=jm.elements, free=jm.free, plan=jm.plan, kind="stored",
                                   ke=jm.element_matrices())
        tm = ftt.build_operator(tsc, dtype=torch.float64, uniform=False)
        top = ftt.StiffnessOperator(elements=tm.elements, free=tm.free, plan=tm.plan, kind="stored",
                                    ke=tm.element_matrices())
    else:
        jop = ft.build_operator(jsc, dtype=jnp.float64, **build_kw)
        top = ftt.build_operator(tsc, dtype=torch.float64, **build_kw)
    assert top.kind == jop.kind and top.dtype == torch.float64
    _check_operator(top, jop, presc, rng)
    geom = jop.geom
    carried = operator_from_numpy(
        jop.kind, np.asarray(jop.elements), np.asarray(jop.free),
        ke=None if jop.ke is None else np.asarray(jop.ke),
        grads=None if geom is None else np.asarray(geom.grads),
        wdetj=None if geom is None else np.asarray(geom.wdetj),
        material=None if jop.material is None else ftt.Material(**MAT), device="cpu",
    )
    _check_operator(carried, jop, presc, rng)


def test_operator_without_plan_chunked_and_cast():
    family, nodes, elements, fixed, loads, presc, _, _ = CASES["hex8_matfree"]
    _, tsc = scene_pair(family, nodes, elements, fixed, loads, presc)
    op = ftt.build_operator(tsc, dtype=torch.float64, uniform=False)
    bare = ftt.build_operator(tsc, dtype=torch.float64, uniform=False, use_plan=False)
    chunked = dataclasses.replace(op, matfree_chunk=5)
    x = t(np.random.default_rng(4).normal(size=nodes.shape))
    want = op.apply_raw(x)
    close(bare.apply_raw(x), want, rel=1e-14)
    close(bare.diag_raw(), op.diag_raw(), rel=1e-14)
    close(chunked.apply_raw(x), want, rel=1e-14)
    low = op.astype(torch.float32)
    assert low.free.dtype == low.geom.grads.dtype == low.plan.mask.dtype == torch.float32
    close(low.apply_raw(x.float()).double(), want, rel=1e-5)


def test_build_operator_errors_match_jax():
    x, el, fixed, loads, _ = beam_arrays()
    flipped = el[:, ::-1].copy()
    jsc, tsc = scene_pair("eb_beam", x, flipped, fixed, loads, None)
    with pytest.raises(ValueError) as ej:
        ft.build_operator(jsc, dtype=jnp.float64)
    with pytest.raises(ValueError) as et:
        ftt.build_operator(tsc, dtype=torch.float64)
    assert str(et.value) == str(ej.value)
    nodes, members, fixed, loads, _ = bar_arrays(2)
    jsc, tsc = scene_pair("bar2d", nodes, members, fixed, loads, None)
    with pytest.raises(ValueError) as ej:
        ft.build_operator(jsc, dtype=jnp.float64)
    with pytest.raises(ValueError) as et:
        ftt.build_operator(tsc, dtype=torch.float64)
    assert str(et.value) == str(ej.value)


def test_element_apply_checks_reject_what_the_kernels_do_not_take():
    """The checks that stand before a K6/K7 launch, on CPU tensors (they
    read only strides and addresses): K7's tile kernel (k = 24) moves rows
    in 16-byte pieces, so a view that starts off a 16-byte boundary is
    refused, never copied behind the caller's back; K6, and K7 at any other
    k, go value by value and take such a view; none takes a tensor that is
    not contiguous."""
    rng = np.random.default_rng(31)
    ke = torch.as_tensor(rng.normal(size=(24, 24)))
    flat = torch.as_tensor(rng.normal(size=(5 * 24 + 1,)))
    check = cuda_apply._check_kernel_args
    u, u_off, out = flat[:-1].view(5, 24), flat[1:].view(5, 24), torch.empty(5, 24, dtype=flat.dtype)
    check("k", "uniform", ke, u, out)  # passes
    with pytest.raises(ValueError, match="16-byte"):
        check("k", "uniform", ke, u_off, out)
    with pytest.raises(ValueError, match="16-byte"):
        check("k", "uniform", ke, u, torch.empty(5 * 24 + 1, dtype=flat.dtype)[1:].view(5, 24))
    # only the tile kernel asks for alignment: K6 at k = 24, and K7 at k = 6 with a Ke view off a boundary
    check("k", "stored", torch.zeros(5, 24, 24, dtype=flat.dtype), u_off, out)
    ke6 = torch.zeros(37, dtype=flat.dtype)[1:].view(6, 6)
    check("k", "uniform", ke6, flat[1:].view(20, 6), torch.empty(20, 6, dtype=flat.dtype))
    check("k", "uniform", flat[1 : 24 * 4 + 1].view(4, 24)[:, :4].contiguous(), flat[1:81].view(20, 4),
          torch.empty(20, 4, dtype=flat.dtype))
    with pytest.raises(ValueError, match="contiguous"):
        check("k", "uniform", ke, flat[:-1].view(24, 5).T, out)
    with pytest.raises(ValueError, match="contiguous"):
        check("k", "uniform", ke.T, u, out)
    # on the CPU the wrapper takes the plain version whatever the view
    got = cuda_apply.batched_matvec_uniform(ke, flat[1:].view(5, 24))
    assert torch.equal(got, cuda_apply.batched_matvec_uniform_plain(ke, flat[1:].view(5, 24)))
