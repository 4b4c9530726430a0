"""K4 and K5: the variable-weight block stencil as CUDA kernels, whole
and on one z slab, raw and masked.

``var_apply(weights, g)`` applies the stencil to a whole grid and
``var_apply_slab(weights, g_ext)`` to one z slab of a sharded grid
(``parallel/curv.py``); ``var_apply_masked(weights, free, g)`` and
``var_apply_slab_masked(weights, free_ext, g_ext)`` compute the operator
with Dirichlet rows, ``F * K(F * g) + (1 - F) * g``, in the same launch.
For a CPU tensor each runs its plain torch version
(:func:`fea_tpu_torch.ops.curvilinear.curv_apply_grid`,
:func:`~fea_tpu_torch.ops.curvilinear.curv_apply_slab_grid`, and the
masked expression written out around them). For a CUDA tensor each
launches its hand-written kernel of ``csrc/varstencil.cu`` (K4 / K4-slab
for f32, K5 / K5-slab for f64) or raises: nothing falls back to the plain
version on the card.

The kernels read 14 of the 27 weight blocks a node and take the other 13
as their mirrors, so every wrapper's input contract is an exactly
block-symmetric field, ``W_{26-d}[n + d] = W_d[n]^T`` wherever n + d is
inside the grid (``curvilinear.symmetrize_field``). On another field the
card computes a different product than the CPU's plain version, which
reads all 27 blocks. The wrappers do not check it (a pass over the field
at every apply); every producer of the port makes such fields, and
``CurvilinearOperator`` and ``build_curv_multigrid`` refuse any other
(``curvilinear.mirror_defect``). The kernels are built at first use by
:mod:`fea_tpu_torch.ops.nvcc`.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import sanitize
from .nvcc import CSRC, launch_on, load_library

__all__ = ["LAUNCHES", "build", "var_apply", "var_apply_masked", "var_apply_slab", "var_apply_slab_masked"]

# Launches of each kernel, counted where the wrapper launches it and
# nowhere else: a run shows through these that it went through K4 / K5
# and their slab forms (a masked launch counts under its kernel's key).
LAUNCHES = {"var_f32": 0, "var_f64": 0, "var_slab_f32": 0, "var_slab_f64": 0}

_LIB: Optional[ctypes.CDLL] = None
_ENTRY = {torch.float32: ("var_f32", "fea_var_apply_f32"),
          torch.float64: ("var_f64", "fea_var_apply_f64")}
_SLAB_ENTRY = {torch.float32: ("var_slab_f32", "fea_var_apply_slab_f32"),
               torch.float64: ("var_slab_f64", "fea_var_apply_slab_f64")}
_MASKED_ENTRY = {torch.float32: ("var_f32", "fea_var_apply_masked_f32"),
                 torch.float64: ("var_f64", "fea_var_apply_masked_f64")}
_SLAB_MASKED_ENTRY = {torch.float32: ("var_slab_f32", "fea_var_apply_slab_masked_f32"),
                      torch.float64: ("var_slab_f64", "fea_var_apply_slab_masked_f64")}


def build() -> ctypes.CDLL:
    """Compile ``csrc/varstencil.cu`` (once per source version) and load it."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = load_library(CSRC / "varstencil.cu", "feavarstencil_cuda")
    for pointers, entries in ((3, (_ENTRY, _SLAB_ENTRY)), (4, (_MASKED_ENTRY, _SLAB_MASKED_ENTRY))):
        for _, fn in (v for e in entries for v in e.values()):
            f = getattr(lib, fn)
            f.argtypes = [ctypes.c_void_p] * pointers + [ctypes.c_int64] * 3 + [ctypes.c_void_p]
            f.restype = ctypes.c_int
    _LIB = lib
    return lib


def _launch(name: str, entry: dict, weights: torch.Tensor, g: torch.Tensor, halo: int,
            free: Optional[torch.Tensor] = None) -> Optional[torch.Tensor]:
    """Check the arguments of a wrapper and launch ``entry``'s kernel for
    g's dtype on the card: output planes are g's less ``halo`` (0 whole, 2
    a slab); ``free``, the masked forms' 0/1 mask, has g's shape. None for
    a CPU tensor, where the caller takes the plain version; raises on
    anything the kernel does not take."""
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
    if free is not None:
        if free.shape != g.shape or free.dtype != g.dtype or free.device != g.device:
            raise ValueError(f"{name}: the mask must match g in shape, dtype and device, got "
                             f"{tuple(free.shape)} {free.dtype} on {free.device}")
    if g.device.type == "cpu":
        return None
    if g.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {g.device}")
    if not (g.is_contiguous() and weights.is_contiguous() and (free is None or free.is_contiguous())):
        raise ValueError(f"{name}: g, the weights and the mask must be contiguous")
    key, fn = entry[g.dtype]
    lib = build()
    out = torch.empty((planes, Y, X, 3), dtype=g.dtype, device=g.device)
    ptrs = (weights.data_ptr(), g.data_ptr()) + (() if free is None else (free.data_ptr(),)) + (out.data_ptr(),)
    err = launch_on(g.device, getattr(lib, fn), *ptrs, X, Y, planes)
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
    plain torch version. ``weights`` must match ``g`` in dtype and device,
    and be exactly block-symmetric (the module's contract; not checked).
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
    CUDA tensor; a CPU tensor takes the plain torch version. The slab must
    be cut from an exactly block-symmetric field (the module's contract;
    not checked): on its first plane the kernel reads the slab's own dz = -1
    blocks, elsewhere the mirrors of its upper blocks.
    """
    out = _launch("var_apply_slab", _SLAB_ENTRY, weights, g_ext, 2)
    if out is None:
        from .curvilinear import curv_apply_slab_grid

        return curv_apply_slab_grid(weights, g_ext)
    return out


def var_apply_masked(weights: torch.Tensor, free: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The operator with Dirichlet rows, ``F * K(F * g) + (1 - F) * g``, in
    one launch: weights (27, 3, 3, Z, Y, X), the 0/1 mask ``free`` and g
    both (Z, Y, X, 3) -> (Z, Y, X, 3). On the card it is, value for value,
    that expression around :func:`var_apply` (the products by a 0/1 mask
    are exact); a CPU tensor takes the expression itself. ``weights`` must
    be exactly block-symmetric (the module's contract; not checked)."""
    out = _launch("var_apply_masked", _MASKED_ENTRY, weights, g, 0, free)
    if out is None:
        from .curvilinear import curv_apply_grid

        return free * curv_apply_grid(weights, free * g) + (1.0 - free) * g
    return out


def var_apply_slab_masked(weights: torch.Tensor, free_ext: torch.Tensor, g_ext: torch.Tensor) -> torch.Tensor:
    """:func:`var_apply_masked` on one z slab: the slab's weights
    (27, 3, 3, Zl, Y, X), and its mask and state between the neighbours'
    edge planes, both (Zl + 2, Y, X, 3) -> (Zl, Y, X, 3). The neighbours'
    edge planes enter as ``free_ext * g_ext``, the slab's own rows as
    ``F * K(F g) + (1 - F) g`` with F and g the middle Zl planes. The
    weights are under :func:`var_apply_slab`'s contract (not checked)."""
    out = _launch("var_apply_slab_masked", _SLAB_MASKED_ENTRY, weights, g_ext, 2, free_ext)
    if out is None:
        from .curvilinear import curv_apply_slab_grid

        F, g = free_ext[1:-1], g_ext[1:-1]
        return F * curv_apply_slab_grid(weights, free_ext * g_ext) + (1.0 - F) * g
    return out
