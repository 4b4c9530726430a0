"""The block-Thomas solve as one CUDA kernel.

``thomas_solve(uinv, G, rf)`` launches the hand-written kernel of
``csrc/thomas.cu`` once on a CUDA tensor and raises for any other: the
solve of ``extruded_mg._thomas_addmv`` (forward y_l = r_l - G_{l-1}^T
y_{l-1}, diagonal u = Uinv y, back x_l = u_l - G_l x_{l+1}) on the same
f32 factors, with f32 sums in another fixed order, by a cluster of 8 thread
blocks that passes each layer's values through distributed shared memory
in place of 2 (L - 1) dependent launches. :func:`takes` is the dispatch
rule of ``extruded_mg._thomas_solve``: f32 on the card, a block width b
even and at most :data:`MAX_B` (a block's row slices of the factors are
streamed through shared memory). It is built at first use by
:mod:`fea_tpu_torch.ops.nvcc`; ``exchange_probe_ms`` times the kernel's
per-layer exchange alone, its floor.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import sanitize
from .nvcc import CSRC, launch_on, load_library

__all__ = ["MAX_B", "build", "exchange_probe_ms", "takes", "thomas_solve"]

MAX_B = 256  # one column a thread of a block's 256, and 32 rows a block of 8

_LIB: Optional[ctypes.CDLL] = None


def build() -> ctypes.CDLL:
    """Compile ``csrc/thomas.cu`` (once per source version) and load it."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = load_library(CSRC / "thomas.cu", "feathomas_cuda")
    lib.fea_thomas_solve_f32.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 2 + [ctypes.c_void_p]
    lib.fea_thomas_solve_f32.restype = ctypes.c_int
    lib.fea_thomas_exchange_probe.argtypes = [ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p]
    lib.fea_thomas_exchange_probe.restype = ctypes.c_int
    _LIB = lib
    return lib


def takes(uinv: torch.Tensor, G: torch.Tensor, rf: torch.Tensor) -> bool:
    """Whether the kernel solves these factors: f32 on the card and an even
    block width of at most :data:`MAX_B`. Elsewhere (the CPU, f64, the wide
    blocks of a z-coarsest level) the ``addmv_`` chain does."""
    b = uinv.shape[-1]
    return (rf.is_cuda and rf.dtype == uinv.dtype == G.dtype == torch.float32
            and b % 2 == 0 and b <= MAX_B)


def _check(uinv: torch.Tensor, G: torch.Tensor, rf: torch.Tensor) -> tuple[int, int]:
    """(L, b), or raise for what the kernel does not take; the device last,
    so that every other check can be made on the CPU."""
    for name, t in (("uinv", uinv), ("G", G), ("rf", rf)):
        if t.dtype != torch.float32:
            raise TypeError(f"thomas_solve: {name} is {t.dtype}, the kernel takes float32")
    if rf.dim() != 2 or rf.shape[0] < 1:
        raise ValueError(f"thomas_solve: rf must be (L, b) with L >= 1, got {tuple(rf.shape)}")
    L, b = rf.shape
    if tuple(uinv.shape) != (L, b, b) or tuple(G.shape) != (L - 1, b, b):
        raise ValueError(f"thomas_solve: uinv {tuple(uinv.shape)} and G {tuple(G.shape)} do not fit rf (L, b) = "
                         f"({L}, {b}): want ({L}, {b}, {b}) and ({L - 1}, {b}, {b})")
    if b % 2 or not 2 <= b <= MAX_B:
        raise ValueError(f"thomas_solve: block width {b} is not even in [2, {MAX_B}]")
    for name, t in (("uinv", uinv), ("G", G), ("rf", rf)):
        if not t.is_contiguous():
            raise ValueError(f"thomas_solve: {name} is not contiguous")
        if t.numel() and t.data_ptr() % 16:
            raise ValueError(f"thomas_solve: {name} is not 16-byte aligned")
    for name, t in (("uinv", uinv), ("G", G), ("rf", rf)):
        if t.device.type != "cuda" or t.device != rf.device:
            raise ValueError(f"thomas_solve: {name} on {t.device}: the kernel takes one CUDA device")
    return L, b


def thomas_solve(uinv: torch.Tensor, G: torch.Tensor, rf: torch.Tensor) -> torch.Tensor:
    """x (L, b) of the block-tridiagonal system whose Thomas factors are
    ``uinv`` (L, b, b) and ``G`` (L - 1, b, b), for ``rf`` (L, b): one
    launch on the current stream. All three f32 (TypeError otherwise),
    contiguous and 16-byte aligned on one CUDA device, b even and at most
    :data:`MAX_B` (ValueError otherwise, before anything is built)."""
    L, b = _check(uinv, G, rf)
    lib = build()
    x = torch.empty_like(rf)
    err = launch_on(rf.device, lib.fea_thomas_solve_f32, uinv.data_ptr(), G.data_ptr(), rf.data_ptr(), x.data_ptr(),
                    L, b)
    if err != 0:
        raise RuntimeError(f"fea_thomas_solve_f32: CUDA error {err} at launch ({L} layers of {b})")
    if sanitize.active():
        sanitize.check("fea_thomas_solve_f32", x)
    return x


def exchange_probe_ms(steps: int, device, reps: int = 20) -> float:
    """Card ms of ``steps`` exchange steps of the kernel's cluster without
    its arithmetic (each thread stores one value into another block, then
    the cluster barrier), the median of ``reps`` CUDA-event timings."""
    lib = build()
    out = torch.empty(1, dtype=torch.float32, device=device)
    times = []
    for _ in range(reps + 1):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        err = launch_on(out.device, lib.fea_thomas_exchange_probe, steps, out.data_ptr())
        stop.record()
        if err != 0:
            raise RuntimeError(f"fea_thomas_exchange_probe: CUDA error {err} at launch")
        torch.cuda.synchronize(out.device)
        times.append(start.elapsed_time(stop))
    return sorted(times[1:])[reps // 2]
