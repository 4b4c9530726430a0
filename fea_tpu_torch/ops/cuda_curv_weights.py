"""The curvilinear weight field's assembly as one CUDA kernel.

``curv_weights(nodes, dims, material, dtype=, valid=)`` launches the
hand-written kernel of ``csrc/curv_weights.cu`` (f32 or f64) once a parity
colour, 8 launches, on a CUDA tensor, and raises for any other: it returns
the (27, 3, 3, Z, Y, X) weight field of a box-grid hex8 mesh with free node
positions and its least detJ as a 0-d tensor. The kernel adds only the 14
upper blocks (offset index >= 13) and leaves the 13 lower ones zero, for
``symmetrize_field`` to write. ``curvilinear.assemble_curv_weights`` calls
it on the card and its plain version
(``curvilinear.assemble_curv_weights_plain``: all 27 blocks, in chunks of
element layers) on the CPU, and symmetrizes either; the two agree once
symmetrized, to the rounding of their sums. It is built at first use by
:mod:`fea_tpu_torch.ops.nvcc`.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from .. import sanitize
from ..materials import Material, lame_parameters
from .nvcc import CSRC, launch_on, load_library

__all__ = ["LAUNCHES", "build", "curv_weights"]

# Launches of the kernel, 8 an assembly (one a parity colour), counted
# where the wrapper launches them and nowhere else: a run shows through
# these that its assembly went through the kernel.
LAUNCHES = {"weights_f32": 0, "weights_f64": 0}

_LIB: Optional[ctypes.CDLL] = None
_ENTRY = {torch.float32: ("weights_f32", "fea_curv_weights_f32"),
          torch.float64: ("weights_f64", "fea_curv_weights_f64")}


def build() -> ctypes.CDLL:
    """Compile ``csrc/curv_weights.cu`` (once per source version) and load it."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = load_library(CSRC / "curv_weights.cu", "feacurvweights_cuda")
    for _, fn in _ENTRY.values():
        f = getattr(lib, fn)
        f.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_double] * 2 + [ctypes.c_int64] * 3 + [ctypes.c_void_p]
        f.restype = ctypes.c_int
    _LIB = lib
    return lib


def curv_weights(
    nodes: torch.Tensor,
    dims: tuple[int, int, int],
    material: Material,
    *,
    dtype: torch.dtype = torch.float64,
    valid=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The weight field (27, 3, 3, Zn, Yn, Xn) in ``dtype`` on the nodes'
    card, its 14 upper blocks assembled and its 13 lower ones zero (before
    ``symmetrize_field``), and the least detJ over every quadrature point
    as a 0-d tensor there.

    ``nodes`` (N, 3) on a CUDA device, in box grid order; ``valid`` an
    optional (nz, ny, nx) 0/1 host mask of the cells that exist (the
    embedded route): a void cell adds exactly zero and its detJ stays out
    of the minimum. ``dtype`` is float32 or float64 (TypeError
    otherwise); nodes on another device raise ValueError.
    """
    if dtype not in _ENTRY:
        raise TypeError(f"curv_weights: dtype {dtype} is neither float32 nor float64")
    nx, ny, nz = dims
    if min(dims) < 1 or tuple(nodes.shape) != ((nx + 1) * (ny + 1) * (nz + 1), 3):
        raise ValueError(f"curv_weights: nodes must be ({(nx + 1) * (ny + 1) * (nz + 1)}, 3) for dims {dims}, "
                         f"got {tuple(nodes.shape)}")
    if valid is not None and np.asarray(valid).size != nx * ny * nz:
        raise ValueError(f"curv_weights: valid must hold {nx * ny * nz} cells, got {np.asarray(valid).size}")
    if nodes.device.type != "cuda":
        raise ValueError(f"curv_weights: no kernel for device {nodes.device}")
    key, fn = _ENTRY[dtype]
    lib = build()
    dev = nodes.device
    xyz = nodes.to(dtype).contiguous()
    live = None if valid is None else torch.as_tensor(np.asarray(valid).reshape(-1) != 0, device=dev)
    w = torch.zeros((27, 3, 3, nz + 1, ny + 1, nx + 1), dtype=dtype, device=dev)
    detj = torch.empty(nx * ny * nz, dtype=dtype, device=dev)
    lam, mu = lame_parameters(material)
    err = launch_on(dev, getattr(lib, fn), xyz.data_ptr(), None if live is None else live.data_ptr(),
                    w.data_ptr(), detj.data_ptr(), lam, mu, nx, ny, nz)
    if err != 0:
        raise RuntimeError(f"{fn}: CUDA error {err} at launch ({nx}x{ny}x{nz} elements)")
    LAUNCHES[key] += 8
    if sanitize.active():
        sanitize.check(fn, w)
    return w, detj.amin()
