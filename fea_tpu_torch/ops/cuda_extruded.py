"""E: the extruded operator's apply as one CUDA kernel.

``extruded_apply(op, x, masked)`` launches the hand-written kernel of
``csrc/extruded.cu`` once on a CUDA tensor and raises for any other: the
masked ``F * K (F * x) + (1 - F) * x`` of ``ExtrudedOperator.apply`` or the
raw ``K x`` of its ``apply_raw``, in the operator's dtype (f32 or f64), for
any node-layer count L >= 2 and a section valence of at most :data:`MAX_V`.
``ExtrudedOperator.apply`` / ``apply_raw`` take it for every CUDA tensor;
their plain version (a corner gather, a batched ``bmm``, two incidence
gather-sums and the mask terms, ~17 launches) stays the CPU path.

The kernel walks a host plan (:func:`tile_plan`): the section's nodes cut
into chunks of at most ``nb`` (a thread block's), each with the sorted list
of section nodes its rows read (its halo, at most :data:`MAX_HALO`) and, a
node an incidence, the quad, the node's corner in it and the halo slots of
the quad's four corners; and Ke laid out in 6 x 6 blocks
(:func:`tile_weights`). Both are made on the operator's first apply on the
card and kept with it; the CPU tests emulate the kernel from them. The
tile's width adapts to what the wrapper sees: two node layers a lane once
L reaches 128, else one, and chunks of 4 nodes where chunks of 8 would give
fewer blocks than the card has SMs. It is built at first use by
:mod:`fea_tpu_torch.ops.nvcc`.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from .. import sanitize
from .nvcc import CSRC, launch_on, load_library

__all__ = ["LAUNCHES", "MAX_HALO", "MAX_V", "Plan", "build", "extruded_apply", "tile_plan", "tile_weights"]

MAX_V = 8  # quads a section node may belong to
MAX_HALO = 64  # section nodes a chunk may read: with its Ke blocks, at most 188 KB of shared memory (f64)
_LANES = 32

# Launches of the kernel, counted where the wrapper launches it and nowhere
# else (masked and raw alike); a capture credits them to every replay
LAUNCHES = {"apply_f32": 0, "apply_f64": 0}

_LIB: Optional[ctypes.CDLL] = None
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_SMS: dict = {}  # device index -> its SM count
# Ke's rows of corner c's DOFs, then of corner c + 4's; its columns of corner
# k's DOFs on the element's lower layer, then on its upper one
_ROWS = torch.tensor([[3 * c + d for d in range(3)] + [3 * (c + 4) + d for d in range(3)] for c in range(4)])
_COLS = torch.tensor([[3 * k + d for d in range(3)] + [12 + 3 * k + d for d in range(3)] for k in range(4)])


@dataclasses.dataclass(frozen=True)
class Plan:
    """The kernel's chunks of section nodes, int32 on the operator's device."""

    nodes: torch.Tensor  # (chunks * nb,) the owned section nodes a chunk, -1 past its last
    halo: torch.Tensor  # (chunks, H) the section nodes a chunk reads, sorted, -1 past its last
    inc: torch.Tensor  # (chunks * nb, V, 6) a node's incidences: quad, corner, halo slots of the quad's 4 corners
    nb: int  # slots a chunk (warps a block)
    chunks: int
    H: int  # halo width
    V: int  # the section's valence


def build() -> ctypes.CDLL:
    """Compile ``csrc/extruded.cu`` (once per source version) and load it."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = load_library(CSRC / "extruded.cu", "feaextruded_cuda")
    for suffix in _SUFFIX.values():
        f = getattr(lib, f"fea_extruded_apply_{suffix}")
        f.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int64] * 8 + [ctypes.c_void_p]
        f.restype = ctypes.c_int
    _LIB = lib
    return lib


def tile_plan(quads: np.ndarray, inc_q: np.ndarray, inc_c: np.ndarray, inc_m: np.ndarray, n2: int, nb: int,
              device=None) -> Plan:
    """The chunks of at most ``nb`` section nodes: the nodes in order of
    first appearance in ``quads`` (then any node no quad has), a chunk closed
    when it holds ``nb`` or when one more node would take its halo past
    :data:`MAX_HALO` (one node reads at most 1 + 3 V <= 25 section nodes at
    the valence the kernel takes). ``inc_*`` are the operator's padded
    incidence (n2, V)."""
    quads = np.asarray(quads, np.int64)
    valid = np.asarray(inc_m).reshape(n2, -1) > 0
    inc_q = np.asarray(inc_q).reshape(n2, -1)
    inc_c = np.asarray(inc_c).reshape(n2, -1)
    V = inc_q.shape[1]
    flat = quads.reshape(-1)
    _, first = np.unique(flat, return_index=True)
    order = list(flat[np.sort(first)]) + list(np.setdiff1d(np.arange(n2), flat))
    needs = [set(quads[inc_q[n, valid[n]]].reshape(-1).tolist()) for n in range(n2)]
    chunks: list[tuple[list, list]] = []
    own: list = []
    reads: set = set()
    for n in order:
        more = reads | needs[n]
        if own and (len(own) == nb or len(more) > MAX_HALO):
            chunks.append((sorted(own), sorted(reads)))
            own, more = [], set(needs[n])
        own.append(int(n))
        reads = more
    chunks.append((sorted(own), sorted(reads)))
    H = max(1, max(len(h) for _, h in chunks))
    nodes = np.full((len(chunks), nb), -1, np.int32)
    halo = np.full((len(chunks), H), -1, np.int32)
    inc = np.full((len(chunks), nb, V, 6), -1, np.int32)
    for b, (own, reads) in enumerate(chunks):
        nodes[b, :len(own)] = own
        halo[b, :len(reads)] = reads
        slot = {n: i for i, n in enumerate(reads)}
        for w, n in enumerate(own):
            for v in np.nonzero(valid[n])[0]:
                q = int(inc_q[n, v])
                inc[b, w, v] = [q, int(inc_c[n, v])] + [slot[int(m)] for m in quads[q]]
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return Plan(nodes=t(nodes.reshape(-1)), halo=t(halo), inc=t(inc.reshape(-1, V, 6)), nb=nb, chunks=len(chunks),
                H=H, V=V)


def tile_weights(kes: torch.Tensor) -> torch.Tensor:
    """(Q2, 4, 4, 36): kp[q, c, k] is Ke_q's 6 x 6 block of the rows of
    corners c and c + 4 and the columns of corner k, row-major."""
    rows, cols = _ROWS.to(kes.device), _COLS.to(kes.device)
    return kes[:, rows[:, None, :, None], cols[None, :, None, :]].reshape(kes.shape[0], 4, 4, 36).contiguous()


def _tables(op, nb: int) -> tuple[Plan, torch.Tensor]:
    """The operator's plan of ``nb`` slots and its laid-out Ke, made once and
    kept with the operator."""
    cache = op._tile_plans
    if nb not in cache:
        host = lambda t: t.detach().cpu().numpy()  # noqa: E731
        cache[nb] = tile_plan(host(op.quads), host(op.inc_q), host(op.inc_c), host(op.inc_m), op.n2, nb,
                              op.kes.device)
    if "kp" not in cache:
        cache["kp"] = tile_weights(op.kes)
    return cache[nb], cache["kp"]


def _tiling(op, device: torch.device) -> tuple[int, Plan, torch.Tensor]:
    """(layers a lane, plan, kp) for the operator's L and n2 on ``device``."""
    L = op.n_layers
    lpl = 2 if L >= 128 else 1
    tiles = math.ceil(L / (_LANES * lpl))
    plan, kp = _tables(op, 8)
    if device.index not in _SMS:
        _SMS[device.index] = torch.cuda.get_device_properties(device).multi_processor_count
    if plan.chunks * tiles < _SMS[device.index]:
        plan, kp = _tables(op, 4)
    return lpl, plan, kp


def _check(op, x: torch.Tensor) -> None:
    """Raise for what the kernel does not take; the device last, so that
    every other check can be made on the CPU."""
    dtype = op.kes.dtype
    if dtype not in _SUFFIX:
        raise TypeError(f"extruded_apply: the operator is {dtype}, the kernel takes float32 or float64")
    for name, t in (("x", x), ("free", op.free)):
        if t.dtype != dtype:
            raise TypeError(f"extruded_apply: {name} is {t.dtype}, the operator {dtype}")
    N = op.n2 * op.n_layers
    for name, t in (("x", x), ("free", op.free)):
        if tuple(t.shape) != (N, 3):
            raise ValueError(f"extruded_apply: {name} must be ({N}, 3), got {tuple(t.shape)}")
    if op.n_layers < 2:
        raise ValueError(f"extruded_apply: {op.n_layers} node layers; the kernel takes 2 or more")
    V = op.inc_q.shape[1]
    if V > MAX_V:
        raise ValueError(f"extruded_apply: a section node in {V} quads; the kernel takes at most {MAX_V}")
    for name, t in (("x", x), ("free", op.free)):
        if not t.is_contiguous():
            raise ValueError(f"extruded_apply: {name} is not contiguous")
    for name, t in (("x", x), ("kes", op.kes), ("free", op.free), ("quads", op.quads)):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"extruded_apply: {name} on {t.device}: the kernel takes one CUDA device")


def extruded_apply(op, x: torch.Tensor, masked: bool) -> torch.Tensor:
    """``op.apply(x)`` (masked) or ``op.apply_raw(x)`` by one launch of the
    kernel on the current stream: x (N, 3) contiguous in the operator's dtype
    (TypeError otherwise), on the operator's CUDA device, at most
    :data:`MAX_V` quads a section node (ValueError otherwise, before
    anything is built)."""
    _check(op, x)
    lpl, plan, kp = _tiling(op, x.device)
    lib = build()
    suffix = _SUFFIX[x.dtype]
    fn = f"fea_extruded_apply_{suffix}"
    y = torch.empty_like(x)
    err = launch_on(x.device, getattr(lib, fn), x.data_ptr(), op.free.data_ptr() if masked else None, y.data_ptr(),
                    kp.data_ptr(), plan.nodes.data_ptr(), plan.halo.data_ptr(), plan.inc.data_ptr(), op.n_layers,
                    op.n2, plan.chunks, plan.nb, plan.H, plan.V, lpl, int(masked))
    if err != 0:
        raise RuntimeError(f"{fn}: CUDA error {err} at launch ({op.n_layers} layers of {op.n2} nodes)")
    LAUNCHES[f"apply_{suffix}"] += 1
    if sanitize.active():
        sanitize.check(fn, y)
    return y
