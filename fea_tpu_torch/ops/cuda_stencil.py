"""K1, K2 and K3: the structured voxel stencil ``K @ u`` as CUDA kernels.

Three entry points, each with its plain torch version in
:mod:`fea_tpu_torch.ops.structured`:

  * ``stencil_apply(ke_table, g)``: the whole grid, K1 (f32) or K2 (f64);
    plain version ``stencil_apply_grid``;
  * ``stencil_apply_slab(ke_table, g_ext, z0, z_real)``: the planes of
    one z slab from its halo-extended input, K1's halo form (f32) or K3
    (f64), as the z-sharded solve runs them on each shard; plain version
    ``stencil_apply_slab_grid``;
  * ``stencil_apply_chunked(ke_table, g, n_chunks)``: the whole grid in
    ``n_chunks`` slab launches over views of ``g``, the counterpart of
    ``fea_tpu/ops/pallas_stencil.py::stencil_apply_transposed_dd_chunked``;
    plain version ``stencil_apply_chunked_grid``.

Each takes an optional ``free`` mask, a 0/1 grid of the input's shape
and dtype (halo-extended like the input for a slab), and then computes
the operator with Dirichlet rows, ``F * K(F * g) + (1 - F) * g``, in the
same one launch; ``free=None`` is the raw ``K @ g``.

For a CPU tensor each runs its plain version. For a CUDA tensor it
launches the hand-written kernel of ``csrc/stencil.cu`` or raises:
nothing falls back to the plain version on the card.

The kernels are built at first use by :mod:`fea_tpu_torch.ops.nvcc`.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import sanitize
from .nvcc import CSRC, launch_on, load_library

__all__ = [
    "LAUNCHES",
    "StencilWeights",
    "build",
    "check_free_mask",
    "dd_z_chunks",
    "region_weight_table",
    "stencil_apply",
    "stencil_apply_chunked",
    "stencil_apply_slab",
    "stencil_weights",
    "z_chunk_bounds",
]

_CORNERS = (
    (0, 0, 0),
    (0, 0, 1),
    (0, 1, 1),
    (0, 1, 0),
    (1, 0, 0),
    (1, 0, 1),
    (1, 1, 1),
    (1, 1, 0),
)  # == ops.structured._CORNERS (element corner order, (cz, cy, cx))

# Launches of each kernel, counted where the wrapper launches it and
# nowhere else: a run shows through these that it went through K1 / K2
# (whole grid) or K1's halo form / K3 (z slabs).
LAUNCHES = {"f32": 0, "f64": 0, "slab_f32": 0, "slab_f64": 0}

_LIB: Optional[ctypes.CDLL] = None
_ENTRY = {torch.float32: ("f32", "fea_stencil_apply_f32"),
          torch.float64: ("f64", "fea_stencil_apply_f64")}
_SLAB_ENTRY = {torch.float32: ("slab_f32", "fea_stencil_apply_slab_f32"),
               torch.float64: ("slab_f64", "fea_stencil_apply_slab_f64")}


def region_weight_table(ke: np.ndarray) -> np.ndarray:
    """(27 regions, 27 offsets, 3, 3) f64 node-stencil weights from Ke.

    Entry [(rz,ry,rx), (dz,dy,dx)] = sum over corner pairs (a, b) with
    ``corner_b - corner_a == (dz,dy,dx)`` of ``Ke[3a:3a+3, 3b:3b+3]``,
    restricted to pairs whose supporting element exists in the node's
    boundary region (corner offset 0 needs an element above the node on
    that axis, offset 1 one below). The same table as
    ``fea_tpu/native/__init__.py::region_weight_table``.
    """
    ke = np.asarray(ke, np.float64)
    W = np.zeros((3, 3, 3, 3, 3, 3, 3, 3), np.float64)
    for rz in range(3):
        for ry in range(3):
            for rx in range(3):
                for a, ca in enumerate(_CORNERS):
                    if any((off == 0 and r == 2) or (off == 1 and r == 0)
                           for off, r in zip(ca, (rz, ry, rx))):
                        continue
                    for b, cb in enumerate(_CORNERS):
                        dz, dy, dx = (cb[0] - ca[0], cb[1] - ca[1], cb[2] - ca[2])
                        W[rz, ry, rx, dz + 1, dy + 1, dx + 1] += ke[
                            3 * a : 3 * a + 3, 3 * b : 3 * b + 3
                        ]
    return np.ascontiguousarray(W.reshape(27, 27, 3, 3))


@dataclasses.dataclass(frozen=True)
class StencilWeights:
    """One element Ke in the forms the stencil takes: the (24, 24) matrix
    for the plain version and the region table for the kernel, both in one
    dtype on one device, and the same table in host memory, from which a
    launch fills the kernel's parameters (the card's constant bank)."""

    ke: torch.Tensor  # (24, 24)
    table: torch.Tensor  # (27, 27, 3, 3)
    host_table: torch.Tensor  # the table on the CPU, contiguous

    def astype(self, dtype: torch.dtype) -> "StencilWeights":
        return StencilWeights(self.ke.to(dtype), self.table.to(dtype), self.host_table.to(dtype))

    def to(self, device) -> "StencilWeights":
        """The same weights with ``ke`` and ``table`` on ``device``."""
        return StencilWeights(self.ke.to(device), self.table.to(device), self.host_table)


def stencil_weights(ke: np.ndarray, dtype: torch.dtype, device) -> StencilWeights:
    """All forms of ``ke``: the region table is summed in f64 on the host
    and rounded once to ``dtype``."""
    ke64 = np.asarray(ke, np.float64)
    host = torch.as_tensor(region_weight_table(ke64)).to(dtype).contiguous()
    return StencilWeights(
        ke=torch.as_tensor(ke64, device=device).to(dtype),
        table=host.to(device),
        host_table=host,
    )


def check_free_mask(free: torch.Tensor) -> torch.Tensor:
    """``free`` unchanged, once it is known to hold only 0 and 1: the
    masked kernel selects by it where the unfused expression multiplies,
    and the two agree only for such a mask. Called where a mask is built
    (an operator, a multigrid level, a shard), never inside a loop."""
    if not bool(((free == 0) | (free == 1)).all()):
        raise ValueError("the free mask must hold only 0 and 1")
    return free


def build() -> ctypes.CDLL:
    """Compile ``csrc/stencil.cu`` (once per source version) and load it."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = load_library(CSRC / "stencil.cu", "feastencil_cuda")
    for entries, n_ints in ((_ENTRY, 3), (_SLAB_ENTRY, 7)):
        for _, fn in entries.values():
            f = getattr(lib, fn)
            f.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64] * n_ints + [ctypes.c_void_p]
            f.restype = ctypes.c_int
    _LIB = lib
    return lib


def _check(name: str, ke_table: StencilWeights, g: torch.Tensor, min_planes: int,
           free: Optional[torch.Tensor] = None) -> None:
    """Raise unless ``g`` is a (planes, Y, X, 3) f32/f64 grid with at
    least ``min_planes`` planes and Y, X >= 2, ``ke_table`` matches it in
    dtype and device, and ``free`` (when given) in shape, dtype and device."""
    if g.dtype not in _ENTRY:
        raise TypeError(f"{name}: dtype {g.dtype} is neither float32 nor float64")
    if g.ndim != 4 or g.shape[3] != 3 or g.shape[0] < min_planes or min(g.shape[1:3]) < 2:
        raise ValueError(
            f"{name}: g must be (Z, Y, X, 3) with Z >= {min_planes} and Y, X >= 2, got {tuple(g.shape)}"
        )
    tab, ke = ke_table.table, ke_table.ke
    if tab.dtype != g.dtype or ke.dtype != g.dtype:
        raise TypeError(f"{name}: weights are {tab.dtype}, g is {g.dtype}")
    if tab.device != g.device or ke.device != g.device:
        raise ValueError(f"{name}: weights on {tab.device}, g on {g.device}")
    if tuple(tab.shape) != (27, 27, 3, 3) or tuple(ke.shape) != (24, 24):
        raise ValueError(f"{name}: weights must be a (24, 24) Ke and a (27, 27, 3, 3) table")
    if g.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {g.device}")
    if free is not None:
        if free.dtype != g.dtype:
            raise TypeError(f"{name}: free is {free.dtype}, g is {g.dtype}")
        if free.shape != g.shape or free.device != g.device:
            raise ValueError(
                f"{name}: free must have g's shape and device, got {tuple(free.shape)} on {free.device} "
                f"for {tuple(g.shape)} on {g.device}"
            )


def _check_launch(name: str, tab: torch.Tensor, g: torch.Tensor, out: torch.Tensor,
                  free: Optional[torch.Tensor]) -> None:
    """Raise on what the kernel does not take: a tensor that is not
    contiguous, or an output that shares memory with an input (a block
    reads planes that another block writes). Any X, Y >= 2 is taken: the
    kernel cuts rows too wide for a block into segments."""
    for what, t in (("g", g), ("the table", tab), ("out", out), ("free", free)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
    lo, hi = out.data_ptr(), out.data_ptr() + out.numel() * out.element_size()
    for what, t in (("g", g), ("free", free)):
        if t is not None and t.data_ptr() < hi and lo < t.data_ptr() + t.numel() * t.element_size():
            raise ValueError(f"{name}: out must not alias {what}")


def _launch(entries: dict, weights: StencilWeights, g: torch.Tensor, free: Optional[torch.Tensor],
            out: torch.Tensor, *sizes: int) -> None:
    """One launch of the kernel of ``g``'s dtype in ``entries`` on the
    current stream of ``g``'s card; raises on a launch error."""
    key, fn = entries[g.dtype]
    tab, host = weights.table, weights.host_table
    _check_launch(fn, tab, g, out, free)
    if host.device.type != "cpu" or host.dtype != tab.dtype or host.shape != tab.shape or not host.is_contiguous():
        raise ValueError(f"{fn}: host_table must be the table on the CPU, contiguous, in {tab.dtype}")
    lib = build()
    err = launch_on(g.device, getattr(lib, fn), host.data_ptr(), tab.data_ptr(), g.data_ptr(),
                    None if free is None else free.data_ptr(), out.data_ptr(), *sizes)
    if err != 0:
        raise RuntimeError(f"{fn}: CUDA error {err} at launch (sizes {sizes})")
    LAUNCHES[key] += 1
    if sanitize.active():
        sanitize.check(fn, out)


def stencil_apply(ke_table: StencilWeights, g: torch.Tensor, free: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``K @ u`` on the node grid: g (Z, Y, X, 3) -> (Z, Y, X, 3); with a
    0/1 mask ``free`` of g's shape and dtype, the masked operator
    ``free * K(free * g) + (1 - free) * g``.

    f32 runs K1 and f64 runs K2 on a CUDA tensor, one launch either way; a
    CPU tensor takes the plain torch version. ``ke_table`` must match
    ``g`` in dtype and device.
    """
    _check("stencil_apply", ke_table, g, 2, free)
    Z, Y, X, _ = g.shape
    if g.device.type == "cpu":
        from .structured import stencil_apply_grid

        return stencil_apply_grid(ke_table.ke, g, (X - 1, Y - 1, Z - 1), free)
    out = torch.empty_like(g)
    _launch(_ENTRY, ke_table, g, free, out, X, Y, Z)
    return out


def stencil_apply_slab(ke_table: StencilWeights, g_ext: torch.Tensor, z0: int, z_real: int,
                       free_ext: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``K @ u`` on one z slab of a grid of ``z_real`` planes:
    g_ext (Zl + 2, Y, X, 3) -> (Zl, Y, X, 3).

    ``g_ext`` holds global planes ``z0 - 1 .. z0 + Zl``: the slab's own
    planes between the neighbour's plane below (index 0) and above
    (index Zl + 1). Planes at or past ``z_real`` are zero padding: they
    are never read, and their output is 0. With ``free_ext``, the 0/1 mask
    on the same planes, the slab's planes of the masked operator
    ``F * K(F * g) + (1 - F) * g`` (a padding plane comes out as
    ``(1 - F) * g``). f32 runs K1's halo form and f64 runs K3 on a CUDA
    tensor; a CPU tensor takes the plain torch version.
    """
    _check("stencil_apply_slab", ke_table, g_ext, 3, free_ext)
    if z0 < 0 or z_real < 2:
        raise ValueError(f"stencil_apply_slab: need z0 >= 0 and z_real >= 2, got z0={z0}, z_real={z_real}")
    Ze, Y, X, _ = g_ext.shape
    if g_ext.device.type == "cpu":
        from .structured import stencil_apply_slab_grid

        return stencil_apply_slab_grid(ke_table.ke, g_ext, z0, z_real, free_ext)
    out = torch.empty((Ze - 2, Y, X, 3), dtype=g_ext.dtype, device=g_ext.device)
    _launch(_SLAB_ENTRY, ke_table, g_ext, free_ext, out, X, Y, Ze - 2, Ze, z0, z0 - 1, z_real)
    return out


def z_chunk_bounds(Z: int, n_chunks: int) -> list[tuple[int, int]]:
    """The planes [s, e) of each of at most ``n_chunks`` z chunks of
    ``ceil(Z / n_chunks)`` planes (the last one shorter), as the reference
    cuts them."""
    cz = -(-Z // n_chunks)
    return [(s, min(s + cz, Z)) for s in range(0, Z, cz)]


def dd_z_chunks(Y: int, X: int, Z: int) -> int:
    """The chunk count ``fea_tpu/ops/pallas_stencil.py::dd_z_chunks`` gives
    a grid of (Z, Y, X) nodes: the fewest z slabs whose halo-extended
    width keeps X * (planes + 2) <= 16,000, the TPU kernel's VMEM fit.

    The card needs no chunking (it holds the whole grid); the rule is kept
    so that K3 can be run at the reference's own chunk counts.
    """
    n = 1
    while X * (-(-Z // n) + 2) > 16_000 and n < Z:
        n += 1
    return n


def stencil_apply_chunked(ke_table: StencilWeights, g: torch.Tensor, n_chunks: int,
                          free: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``K @ u`` on the whole grid g (Z, Y, X, 3) in ``n_chunks`` z slabs,
    masked by ``free`` as :func:`stencil_apply` is.

    On a CUDA tensor each slab is one launch of K1's halo form (f32) or
    K3 (f64) on a view of ``g`` (the slab and its halo planes are one
    contiguous range of planes), writing its planes of one output tensor:
    no concatenation. The result is bit for bit that of
    :func:`stencil_apply` (the same kernel body). A CPU tensor takes the
    plain torch version.
    """
    _check("stencil_apply_chunked", ke_table, g, 2, free)
    if n_chunks < 1:
        raise ValueError(f"stencil_apply_chunked: n_chunks must be >= 1, got {n_chunks}")
    Z, Y, X, _ = g.shape
    if g.device.type == "cpu":
        from .structured import stencil_apply_chunked_grid

        return stencil_apply_chunked_grid(ke_table.ke, g, n_chunks, free)
    out = torch.empty_like(g)
    for s, e in z_chunk_bounds(Z, n_chunks):
        lo, hi = max(s - 1, 0), min(e + 1, Z)
        _launch(_SLAB_ENTRY, ke_table, g[lo:hi], None if free is None else free[lo:hi], out[s:e],
                X, Y, e - s, hi - lo, s, lo, Z)
    return out
