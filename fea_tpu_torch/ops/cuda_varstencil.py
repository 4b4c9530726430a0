"""K4 and K5: the variable-weight block stencil as CUDA kernels, whole
and on one z slab.

``var_apply(weights, g)`` applies the stencil to a whole grid and
``var_apply_slab(weights, g_ext)`` to one z slab of a sharded grid
(``parallel/curv.py``). For a CPU tensor each runs its plain torch
version, :func:`fea_tpu_torch.ops.curvilinear.curv_apply_grid` and
:func:`~fea_tpu_torch.ops.curvilinear.curv_apply_slab_grid`. For a CUDA
tensor each launches its hand-written kernel of ``csrc/varstencil.cu``
(K4 / K4-slab for f32, K5 / K5-slab for f64) or raises: nothing falls
back to the plain version on the card.

The kernels are built at first use by :mod:`fea_tpu_torch.ops.nvcc`.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import sanitize
from .nvcc import CSRC, launch_on, load_library

__all__ = ["LAUNCHES", "build", "var_apply", "var_apply_slab"]

# Launches of each kernel, counted where the wrapper launches it and
# nowhere else: a run shows through these that it went through K4 / K5
# and their slab forms.
LAUNCHES = {"var_f32": 0, "var_f64": 0, "var_slab_f32": 0, "var_slab_f64": 0}

_LIB: Optional[ctypes.CDLL] = None
_ENTRY = {torch.float32: ("var_f32", "fea_var_apply_f32"),
          torch.float64: ("var_f64", "fea_var_apply_f64")}
_SLAB_ENTRY = {torch.float32: ("var_slab_f32", "fea_var_apply_slab_f32"),
               torch.float64: ("var_slab_f64", "fea_var_apply_slab_f64")}


def build() -> ctypes.CDLL:
    """Compile ``csrc/varstencil.cu`` (once per source version) and load it."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = load_library(CSRC / "varstencil.cu", "feavarstencil_cuda")
    for _, fn in (*_ENTRY.values(), *_SLAB_ENTRY.values()):
        f = getattr(lib, fn)
        f.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 3 + [ctypes.c_void_p]
        f.restype = ctypes.c_int
    _LIB = lib
    return lib


def _launch(name: str, entry: dict, weights: torch.Tensor, g: torch.Tensor, halo: int) -> Optional[torch.Tensor]:
    """Check the arguments of a wrapper and launch ``entry``'s kernel for
    g's dtype on the card: output planes are g's less ``halo`` (0 whole, 2
    a slab). None for a CPU tensor, where the caller takes the plain
    version; raises on anything the kernel does not take."""
    if g.dtype not in entry:
        raise TypeError(f"{name}: dtype {g.dtype} is neither float32 nor float64")
    if g.ndim != 4 or g.shape[3] != 3 or g.shape[0] <= halo:
        raise ValueError(f"{name}: g must be (Z{' + 2' if halo else ''}, Y, X, 3) with Z >= 1, got {tuple(g.shape)}")
    planes, Y, X = g.shape[0] - halo, g.shape[1], g.shape[2]
    if tuple(weights.shape) != (27, 3, 3, planes, Y, X):
        raise ValueError(
            f"{name}: weights must be (27, 3, 3, {planes}, {Y}, {X}) for g {tuple(g.shape)}, "
            f"got {tuple(weights.shape)}"
        )
    if weights.dtype != g.dtype:
        raise TypeError(f"{name}: weights are {weights.dtype}, g is {g.dtype}")
    if weights.device != g.device:
        raise ValueError(f"{name}: weights on {weights.device}, g on {g.device}")
    if g.device.type == "cpu":
        return None
    if g.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {g.device}")
    if not (g.is_contiguous() and weights.is_contiguous()):
        raise ValueError(f"{name}: g and the weights must be contiguous")
    key, fn = entry[g.dtype]
    lib = build()
    out = torch.empty((planes, Y, X, 3), dtype=g.dtype, device=g.device)
    err = launch_on(g.device, getattr(lib, fn), weights.data_ptr(), g.data_ptr(), out.data_ptr(), X, Y, planes)
    if err != 0:
        raise RuntimeError(f"{fn}: CUDA error {err} at launch ({X}x{Y}x{planes} nodes)")
    LAUNCHES[key] += 1
    if sanitize.active():
        sanitize.check(fn, out)
    return out


def var_apply(weights: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``K @ u`` on the node grid: weights (27, 3, 3, Z, Y, X) and
    g (Z, Y, X, 3) -> (Z, Y, X, 3).

    f32 runs K4 and f64 runs K5 on a CUDA tensor; a CPU tensor takes the
    plain torch version. ``weights`` must match ``g`` in dtype and device.
    """
    out = _launch("var_apply", _ENTRY, weights, g, 0)
    if out is None:
        from .curvilinear import curv_apply_grid

        return curv_apply_grid(weights, g)
    return out


def var_apply_slab(weights: torch.Tensor, g_ext: torch.Tensor) -> torch.Tensor:
    """``K @ u`` on one z slab of a grid: the slab's own weights
    (27, 3, 3, Zl, Y, X) and its state between the neighbours' edge
    planes, g_ext (Zl + 2, Y, X, 3) -> (Zl, Y, X, 3).

    Plane 0 of ``g_ext`` is the plane below the slab and plane Zl + 1 the
    one above (zeros past the grid's ends). The weights toward a plane
    past the grid are zero, and so are those of padding planes, as the
    assembled field has them. f32 runs K4-slab and f64 runs K5-slab on a
    CUDA tensor; a CPU tensor takes the plain torch version.
    """
    out = _launch("var_apply_slab", _SLAB_ENTRY, weights, g_ext, 2)
    if out is None:
        from .curvilinear import curv_apply_slab_grid

        return curv_apply_slab_grid(weights, g_ext)
    return out
