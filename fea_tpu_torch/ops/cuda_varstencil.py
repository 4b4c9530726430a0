"""K4 and K5: the variable-weight block stencil as CUDA kernels.

``var_apply(weights, g)`` is the one entry point. For a CPU tensor it
runs the plain torch version,
:func:`fea_tpu_torch.ops.curvilinear.curv_apply_grid`. For a CUDA tensor
it launches the hand-written kernel of ``csrc/varstencil.cu`` (K4 for
f32, K5 for f64) or raises: nothing falls back to the plain version on
the card.

The kernels are built at first use by :mod:`fea_tpu_torch.ops.nvcc`.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .nvcc import CSRC, launch_on, load_library

__all__ = ["LAUNCHES", "build", "var_apply"]

# Launches of each kernel, counted where the wrapper launches it and
# nowhere else: a run shows through these that it went through K4 / K5.
LAUNCHES = {"var_f32": 0, "var_f64": 0}

_LIB: Optional[ctypes.CDLL] = None
_ENTRY = {torch.float32: ("var_f32", "fea_var_apply_f32"),
          torch.float64: ("var_f64", "fea_var_apply_f64")}


def build() -> ctypes.CDLL:
    """Compile ``csrc/varstencil.cu`` (once per source version) and load it."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = load_library(CSRC / "varstencil.cu", "feavarstencil_cuda")
    for _, fn in _ENTRY.values():
        f = getattr(lib, fn)
        f.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 3 + [ctypes.c_void_p]
        f.restype = ctypes.c_int
    _LIB = lib
    return lib


def var_apply(weights: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``K @ u`` on the node grid: weights (27, 3, 3, Z, Y, X) and
    g (Z, Y, X, 3) -> (Z, Y, X, 3).

    f32 runs K4 and f64 runs K5 on a CUDA tensor; a CPU tensor takes the
    plain torch version. ``weights`` must match ``g`` in dtype and device.
    """
    if g.dtype not in _ENTRY:
        raise TypeError(f"var_apply: dtype {g.dtype} is neither float32 nor float64")
    if g.ndim != 4 or g.shape[3] != 3:
        raise ValueError(f"var_apply: g must be (Z, Y, X, 3), got {tuple(g.shape)}")
    Z, Y, X, _ = g.shape
    if tuple(weights.shape) != (27, 3, 3, Z, Y, X):
        raise ValueError(
            f"var_apply: weights must be (27, 3, 3, {Z}, {Y}, {X}) for g {tuple(g.shape)}, "
            f"got {tuple(weights.shape)}"
        )
    if weights.dtype != g.dtype:
        raise TypeError(f"var_apply: weights are {weights.dtype}, g is {g.dtype}")
    if weights.device != g.device:
        raise ValueError(f"var_apply: weights on {weights.device}, g on {g.device}")
    if g.device.type == "cpu":
        from .curvilinear import curv_apply_grid

        return curv_apply_grid(weights, g)
    if g.device.type != "cuda":
        raise ValueError(f"var_apply: no kernel for device {g.device}")
    if not (g.is_contiguous() and weights.is_contiguous()):
        raise ValueError("var_apply: g and the weights must be contiguous")
    key, fn = _ENTRY[g.dtype]
    lib = build()
    out = torch.empty_like(g)
    err = launch_on(g.device, getattr(lib, fn), weights.data_ptr(), g.data_ptr(), out.data_ptr(), X, Y, Z)
    if err != 0:
        raise RuntimeError(f"{fn}: CUDA error {err} at launch ({X}x{Y}x{Z} nodes)")
    LAUNCHES[key] += 1
    return out
