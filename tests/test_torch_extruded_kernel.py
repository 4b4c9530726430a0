"""Kernel E, the extruded operator's apply in one launch, on the CPU: its
wrapper refuses what the kernel does not take before it builds anything,
a CPU tensor keeps the plain version, the layer-slab path keeps its plain
pieces, and the kernel's tile plan, emulated in torch, computes the plain
apply within f64 rounding on a tube (valence 2) and on a rectangular section
(valence up to 4)."""
import numpy as np
import pytest
import torch

from fea_tpu_torch.mesh import annulus_section, generate_quad_grid
from fea_tpu_torch.ops import cuda_extruded
from fea_tpu_torch.ops.extruded import _make
from fea_tpu_torch.parallel.extruded import _shard_operator
from fea_tpu_torch.solve import staged
from torch_pin import one_torch_thread  # noqa: F401

SECTIONS = {"tube": annulus_section(12, 0.8, 1.0), "grid": generate_quad_grid(5, 4, 1.0, 1.0)}


def _op(quads, n2, L, seed=0, dtype=torch.float64):
    """An extruded operator of random symmetric Ke a quad and a random 0/1
    free mask (the kernel's arithmetic needs no geometry)."""
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(quads.shape[0], 24, 24))
    free = (rng.random((n2 * L, 3)) > 0.2).astype(np.float64)
    return _make(M + M.transpose(0, 2, 1), np.asarray(quads, np.int64), free, n2, L, dtype, torch.device("cpu"))


def _x(op, seed=1, dtype=torch.float64):
    return torch.as_tensor(np.random.default_rng(seed).normal(size=(op.n_nodes, 3)), dtype=dtype)


def _fan(n_quads):
    """A section of ``n_quads`` quads around node 0: its valence."""
    ring = 2 * n_quads
    quads = np.array([[0, 1 + 2 * i, 1 + (2 * i + 1) % ring, 1 + (2 * i + 2) % ring] for i in range(n_quads)])
    return quads, ring + 1


def _emulate(op, x, masked, nb):
    """What the kernel computes, in torch from its plan and laid-out Ke
    (``cuda_extruded.tile_plan``, ``tile_weights``; sums in torch's order):
    every chunk's halo staged with zero layers past both ends, each node's
    bottom- and top-face rows times its incident quads' corners through the
    plan's halo slots, the ends' missing faces dropped."""
    L, n2 = op.n_layers, op.n2
    plan = cuda_extruded.tile_plan(op.quads.numpy(), op.inc_q.numpy(), op.inc_c.numpy(), op.inc_m.numpy(), n2, nb)
    kp = cuda_extruded.tile_weights(op.kes.to(x.dtype)).reshape(-1, 4, 4, 6, 6)
    F = op.free.to(x.dtype)
    g = (F * x if masked else x).reshape(L, n2, 3)
    staged = torch.zeros((L + 2, n2 + 1, 3), dtype=x.dtype, device=x.device)  # node n2: a slot past the halo
    staged[1:-1, :n2] = g
    halo = plan.halo.long().masked_fill(plan.halo < 0, n2)
    s = staged[:, halo]  # (L + 2, chunks, H, 3)
    inc = plan.inc.long().reshape(plan.chunks, nb, plan.V, 6)
    valid = (inc[..., 0] >= 0).to(x.dtype)
    q, c, h = inc[..., 0].clamp(min=0), inc[..., 1].clamp(min=0), inc[..., 2:].clamp(min=0)
    u = s[:, torch.arange(plan.chunks)[:, None, None, None], h]  # (L + 2, chunks, nb, V, 4, 3)
    K = kp[q, c]  # (chunks, nb, V, 4, 6, 6)
    bottom = torch.cat([u[1:-1], u[2:]], dim=-1)  # element layer l: layers l, l + 1
    top = torch.cat([u[:-2], u[1:-1]], dim=-1)  # element layer l - 1: layers l - 1, l
    ab = torch.einsum("bwvkrj,lbwvkj,bwv->lbwr", K[..., :3, :], bottom, valid)
    at = torch.einsum("bwvkrj,lbwvkj,bwv->lbwr", K[..., 3:, :], top, valid)
    ab[-1] = 0.0
    at[0] = 0.0
    out = torch.zeros((L, n2, 3), dtype=x.dtype, device=x.device)
    own = plan.nodes.long().reshape(plan.chunks, nb)
    keep = own >= 0
    out[:, own[keep]] = (ab + at)[:, keep]
    out = out.reshape(-1, 3)
    return F * out + (1.0 - F) * x if masked else out


def _f32_x(op, x):
    return op, x.float()


def _f32_op(op, x):
    return op.astype(torch.float32), x


def _short_x(op, x):
    return op, x[1:]


def _flat_x(op, x):
    return op, x.reshape(-1)


def _strided_x(op, x):
    return op, x.T.contiguous().T


def _valence_9(op, x):
    quads, n2 = _fan(9)
    wide = _op(quads, n2, 3)
    return wide, _x(wide)


@pytest.mark.parametrize("bad,error,match", [
    (_f32_x, TypeError, "the operator torch.float64"),
    (_f32_op, TypeError, "the operator torch.float32"),
    (_short_x, ValueError, "must be"),
    (_flat_x, ValueError, "must be"),
    (_strided_x, ValueError, "not contiguous"),
    (_valence_9, ValueError, "at most 8"),
    (lambda op, x: (op, x), ValueError, "CUDA device"),
])
@pytest.mark.parametrize("masked", [True, False])
def test_the_wrapper_refuses_before_building(bad, error, match, masked, monkeypatch):
    """x of another dtype than the operator, of the wrong shape or strided,
    a section node in 9 quads, and CPU tensors each raise before ``build()``
    runs, masked and raw."""
    def no_build():
        raise AssertionError("built")

    monkeypatch.setattr(cuda_extruded, "build", no_build)
    quads, n2 = SECTIONS["tube"][1], SECTIONS["tube"][0].shape[0]
    op = _op(quads, n2, 5)
    op, x = bad(op, _x(op))
    with pytest.raises(error, match=match):
        cuda_extruded.extruded_apply(op, x, masked)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_the_cpu_keeps_the_plain_version(dtype, monkeypatch):
    """On the CPU apply, apply_raw and rhs are the parent's formulas bit for
    bit, and the kernel's wrapper is never called nor counted."""
    def no_kernel(*_):
        raise AssertionError("the kernel's wrapper was called")

    monkeypatch.setattr(cuda_extruded, "extruded_apply", no_kernel)
    quads, n2 = SECTIONS["grid"][1], SECTIONS["grid"][0].shape[0]
    op = _op(quads, n2, 7, dtype=dtype)
    x, p = _x(op, 2, dtype), _x(op, 3, dtype)
    n0 = dict(cuda_extruded.LAUNCHES)

    def raw(u):  # the parent's apply_raw
        return op._accumulate(op._element_forces(u.reshape(op.n_layers, op.n2, 3))).reshape(-1, 3)

    F = op.free
    assert torch.equal(op.apply_raw(x), raw(x))
    assert torch.equal(op.apply(x), F * raw(F * x) + (1.0 - F) * x)
    assert torch.equal(op.rhs(x, p), F * (x - raw((1.0 - F) * p)) + (1.0 - F) * p)
    assert cuda_extruded.LAUNCHES == n0


def test_the_layer_slab_path_keeps_its_plain_pieces(monkeypatch):
    """The layer-slab operator of a small tube on two CPU slabs applies the
    unsharded plain version's K within f64 rounding, through
    ``_element_forces`` / ``_accumulate`` and never the kernel's wrapper."""
    def no_kernel(*_):
        raise AssertionError("the kernel's wrapper was called")

    monkeypatch.setattr(cuda_extruded, "extruded_apply", no_kernel)
    quads, n2 = SECTIONS["tube"][1], SECTIONS["tube"][0].shape[0]
    op = _op(quads, n2, 11)
    x = _x(op)
    cpu = torch.device("cpu")
    op_s = _shard_operator(op, [cpu, cpu], 6)
    for got, want in ((op_s.gather(op_s.apply(op_s.scatter(x))), op.apply(x)),
                      (op_s.gather(op_s.apply_raw(op_s.scatter(x))), op.apply_raw(x))):
        assert float((got - want).abs().max()) <= 1e-13 * float(want.abs().max())


@pytest.mark.parametrize("section", sorted(SECTIONS))
@pytest.mark.parametrize("L", [2, 3, 70])
@pytest.mark.parametrize("nb", [8, 4])
def test_the_tile_plan_computes_the_plain_apply(section, L, nb):
    """The kernel's arithmetic from its plan (halo slots, incidence, the 6 x 6
    Ke blocks, the missing faces of the end layers), emulated in torch,
    against the plain apply, masked and raw, within f64 rounding (1e-13 of
    the largest output: another summation order)."""
    nodes2d, quads = SECTIONS[section]
    op = _op(quads, nodes2d.shape[0], L, seed=L)
    x = _x(op)
    assert op.inc_q.shape[1] == (2 if section == "tube" else 4)
    for masked in (True, False):
        want = op.apply(x) if masked else op.apply_raw(x)
        got = _emulate(op, x, masked, nb)
        assert float((got - want).abs().max()) <= 1e-13 * float(want.abs().max()), (section, L, nb, masked)


@pytest.mark.parametrize("section", sorted(SECTIONS) + ["fan"])
@pytest.mark.parametrize("nb", [8, 4])
def test_the_tile_plan_covers_every_node_once(section, nb):
    """Every section node is owned by one slot; a chunk's halo is sorted,
    within ``MAX_HALO`` and holds the corners of every quad its nodes are in;
    each incidence names the quad and corner of the operator's incidence and
    the halo slots of the quad's own corners."""
    quads, n2 = _fan(8) if section == "fan" else (SECTIONS[section][1], SECTIONS[section][0].shape[0])
    op = _op(quads, n2, 2)
    plan = cuda_extruded.tile_plan(op.quads.numpy(), op.inc_q.numpy(), op.inc_c.numpy(), op.inc_m.numpy(), n2, nb)
    nodes = plan.nodes.numpy().reshape(plan.chunks, nb)
    halo, inc = plan.halo.numpy(), plan.inc.numpy().reshape(plan.chunks, nb, plan.V, 6)
    assert sorted(nodes[nodes >= 0].tolist()) == list(range(n2))
    assert plan.H <= cuda_extruded.MAX_HALO and plan.V == op.inc_q.shape[1]
    for b in range(plan.chunks):
        h = halo[b][halo[b] >= 0]
        assert np.all(np.diff(h) > 0)
        for w, n in enumerate(nodes[b]):
            if n < 0:
                assert np.all(inc[b, w, :, 0] == -1)
                continue
            for v in range(plan.V):
                q, c = inc[b, w, v, :2]
                if not float(op.inc_m[n, v, 0]):
                    assert q == -1
                    continue
                assert (q, c) == (int(op.inc_q[n, v]), int(op.inc_c[n, v])) and quads[q, c] == n
                assert np.array_equal(h[inc[b, w, v, 2:]], quads[q])


def test_the_launch_counter_is_credited_by_a_capture():
    """Both keys exist at import, and the staged loop's capture credits
    them to every replay."""
    assert set(cuda_extruded.LAUNCHES) == {"apply_f32", "apply_f64"}
    assert any(c is cuda_extruded.LAUNCHES for c in staged._COUNTERS)
