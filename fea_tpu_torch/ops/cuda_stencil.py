"""K1 and K2: the structured voxel stencil ``K @ u`` as CUDA kernels.

``stencil_apply(ke_table, g)`` is the one entry point. For a CPU tensor
it runs the plain torch version,
:func:`fea_tpu_torch.ops.structured.stencil_apply_grid`. For a CUDA
tensor it launches the hand-written kernel of ``csrc/stencil.cu`` (K1 for
f32, K2 for f64) or raises: nothing falls back to the plain version on
the card.

The kernels are built at first use by :mod:`fea_tpu_torch.ops.nvcc`.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch

from .nvcc import CSRC, load_library

__all__ = [
    "LAUNCHES",
    "StencilWeights",
    "build",
    "region_weight_table",
    "stencil_apply",
    "stencil_weights",
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
# nowhere else: a run shows through these that it went through K1 / K2.
LAUNCHES = {"f32": 0, "f64": 0}

_LIB: Optional[ctypes.CDLL] = None
_ENTRY = {torch.float32: ("f32", "fea_stencil_apply_f32"),
          torch.float64: ("f64", "fea_stencil_apply_f64")}


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
    """One element Ke in the two forms the stencil takes: the (24, 24)
    matrix for the plain version and the region table for the kernel,
    both in one dtype on one device."""

    ke: torch.Tensor  # (24, 24)
    table: torch.Tensor  # (27, 27, 3, 3)

    def astype(self, dtype: torch.dtype) -> "StencilWeights":
        return StencilWeights(self.ke.to(dtype), self.table.to(dtype))


def stencil_weights(ke: np.ndarray, dtype: torch.dtype, device) -> StencilWeights:
    """Both forms of ``ke``: the region table is summed in f64 on the
    host and rounded once to ``dtype``."""
    ke64 = np.asarray(ke, np.float64)
    return StencilWeights(
        ke=torch.as_tensor(ke64, device=device).to(dtype),
        table=torch.as_tensor(region_weight_table(ke64), device=device).to(dtype),
    )


def build() -> ctypes.CDLL:
    """Compile ``csrc/stencil.cu`` (once per source version) and load it."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = load_library(CSRC / "stencil.cu", "feastencil_cuda")
    for _, fn in _ENTRY.values():
        f = getattr(lib, fn)
        f.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 3 + [ctypes.c_void_p]
        f.restype = ctypes.c_int
    _LIB = lib
    return lib


def stencil_apply(ke_table: StencilWeights, g: torch.Tensor) -> torch.Tensor:
    """``K @ u`` on the node grid: g (Z, Y, X, 3) -> (Z, Y, X, 3).

    f32 runs K1 and f64 runs K2 on a CUDA tensor; a CPU tensor takes the
    plain torch version. ``ke_table`` must match ``g`` in dtype and
    device.
    """
    if g.dtype not in _ENTRY:
        raise TypeError(f"stencil_apply: dtype {g.dtype} is neither float32 nor float64")
    if g.ndim != 4 or g.shape[3] != 3 or min(g.shape[:3]) < 2:
        raise ValueError(f"stencil_apply: g must be (Z, Y, X, 3) with Z, Y, X >= 2, got {tuple(g.shape)}")
    tab, ke = ke_table.table, ke_table.ke
    if tab.dtype != g.dtype or ke.dtype != g.dtype:
        raise TypeError(f"stencil_apply: weights are {tab.dtype}, g is {g.dtype}")
    if tab.device != g.device or ke.device != g.device:
        raise ValueError(f"stencil_apply: weights on {tab.device}, g on {g.device}")
    if tuple(tab.shape) != (27, 27, 3, 3) or tuple(ke.shape) != (24, 24):
        raise ValueError("stencil_apply: weights must be a (24, 24) Ke and a (27, 27, 3, 3) table")
    Z, Y, X, _ = g.shape
    if g.device.type == "cpu":
        from .structured import stencil_apply_grid

        return stencil_apply_grid(ke, g, (X - 1, Y - 1, Z - 1))
    if g.device.type != "cuda":
        raise ValueError(f"stencil_apply: no kernel for device {g.device}")
    if not (g.is_contiguous() and tab.is_contiguous()):
        raise ValueError("stencil_apply: g and the table must be contiguous")
    key, fn = _ENTRY[g.dtype]
    lib = build()
    out = torch.empty_like(g)
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        err = getattr(lib, fn)(tab.data_ptr(), g.data_ptr(), out.data_ptr(), X, Y, Z, stream)
    if err != 0:
        raise RuntimeError(f"{fn}: CUDA error {err} at launch ({X}x{Y}x{Z} nodes)")
    LAUNCHES[key] += 1
    return out
