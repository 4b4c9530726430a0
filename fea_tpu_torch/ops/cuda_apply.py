"""K6 and K7: the batched element apply f_e = Ke u_e as CUDA kernels.

``batched_matvec_stored(ke, u_e)`` (K6, ke (E, k, k)) and
``batched_matvec_uniform(ke, u_e)`` (K7, one ke (k, k)) are the element
applies of the ``stored`` and ``uniform`` operator kinds. For a CPU
tensor each runs its plain torch version (``*_plain`` below). For a CUDA
f32 or f64 tensor it launches the hand-written kernel of
``csrc/element_apply.cu``, or raises: nothing falls back to the plain
version on the card. Counterpart of ``fea_tpu/ops/pallas_apply.py``,
which the JAX package runs only under ``build_operator(use_pallas=True)``;
here the kernels are the applies themselves.

The kernels are built at first use by :mod:`fea_tpu_torch.ops.nvcc`.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import sanitize
from .nvcc import CSRC, launch_on, load_library

__all__ = [
    "LAUNCHES",
    "MAX_K",
    "batched_matvec_stored",
    "batched_matvec_stored_plain",
    "batched_matvec_uniform",
    "batched_matvec_uniform_plain",
    "build",
]

MAX_K = 32  # element DOFs a kernel takes: one warp covers a row

# Launches of each kernel, counted where the wrapper launches it and
# nowhere else: a run shows through these that it went through K6 / K7.
LAUNCHES = {"stored_f32": 0, "stored_f64": 0, "uniform_f32": 0, "uniform_f64": 0}

_LIB: Optional[ctypes.CDLL] = None
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def batched_matvec_stored_plain(ke: torch.Tensor, u_e: torch.Tensor) -> torch.Tensor:
    """K6's plain version: f_e[e] = ke[e] @ u_e[e]."""
    return torch.einsum("eab,eb->ea", ke, u_e)


def batched_matvec_uniform_plain(ke: torch.Tensor, u_e: torch.Tensor) -> torch.Tensor:
    """K7's plain version: f_e = u_e @ ke^T."""
    return u_e @ ke.T


def build() -> ctypes.CDLL:
    """Compile ``csrc/element_apply.cu`` (once per source version) and load it."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = load_library(CSRC / "element_apply.cu", "feaapply_cuda")
    for kind in ("stored", "uniform"):
        for suffix in _SUFFIX.values():
            f = getattr(lib, f"fea_batched_matvec_{kind}_{suffix}")
            f.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
            f.restype = ctypes.c_int
    _LIB = lib
    return lib


def _check_kernel_args(name: str, kind: str, ke: torch.Tensor, u_e: torch.Tensor, out: torch.Tensor) -> None:
    """Raise on what the kernels do not take: a tensor that is not
    contiguous, and for K7 at k = 24 a ``u_e`` or an output whose memory
    does not start at a multiple of 16 bytes (its tile kernel moves both in
    16-byte pieces; a view cut at an odd offset must be copied by the
    caller, never by a slower path here). K6 and K7 at any other k read and
    write value by value and take any contiguous view."""
    if not (ke.is_contiguous() and u_e.is_contiguous() and out.is_contiguous()):
        raise ValueError(f"{name}: ke, u_e and the output must be contiguous")
    if kind == "uniform" and u_e.shape[1] == 24 and (u_e.data_ptr() % 16 or out.data_ptr() % 16):
        raise ValueError(f"{name}: at k = 24 u_e and the output must start at a 16-byte aligned address")


def _dispatch(kind: str, ke: torch.Tensor, u_e: torch.Tensor) -> torch.Tensor:
    name = f"batched_matvec_{kind}"
    if u_e.dtype not in _SUFFIX:
        raise TypeError(f"{name}: dtype {u_e.dtype} is neither float32 nor float64")
    if ke.dtype != u_e.dtype:
        raise TypeError(f"{name}: ke is {ke.dtype}, u_e is {u_e.dtype}")
    if ke.device != u_e.device:
        raise ValueError(f"{name}: ke on {ke.device}, u_e on {u_e.device}")
    if u_e.ndim != 2 or not (1 <= u_e.shape[0] and 1 <= u_e.shape[1] <= MAX_K):
        raise ValueError(f"{name}: u_e must be (E, k) with E >= 1 and 1 <= k <= {MAX_K}, got {tuple(u_e.shape)}")
    E, k = u_e.shape
    ke_shape = (E, k, k) if kind == "stored" else (k, k)
    if tuple(ke.shape) != ke_shape:
        raise ValueError(f"{name}: ke must be {ke_shape} for u_e {tuple(u_e.shape)}, got {tuple(ke.shape)}")
    if u_e.device.type == "cpu":
        plain = batched_matvec_stored_plain if kind == "stored" else batched_matvec_uniform_plain
        return plain(ke, u_e)
    if u_e.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {u_e.device}")
    out = torch.empty_like(u_e)
    _check_kernel_args(name, kind, ke, u_e, out)
    suffix = _SUFFIX[u_e.dtype]
    fn = f"fea_{name}_{suffix}"
    lib = build()
    err = launch_on(u_e.device, getattr(lib, fn), ke.data_ptr(), u_e.data_ptr(), out.data_ptr(), E, k)
    if err != 0:
        raise RuntimeError(f"{fn}: CUDA error {err} at launch (E={E}, k={k})")
    LAUNCHES[f"{kind}_{suffix}"] += 1
    if sanitize.active():
        sanitize.check(fn, out)
    return out


def batched_matvec_stored(ke: torch.Tensor, u_e: torch.Tensor) -> torch.Tensor:
    """f_e[e, a] = sum_b ke[e, a, b] u_e[e, b]: ke (E, k, k), u_e (E, k).

    K6 on a CUDA tensor (f32 or f64), the plain version on a CPU tensor.
    """
    return _dispatch("stored", ke, u_e)


def batched_matvec_uniform(ke: torch.Tensor, u_e: torch.Tensor) -> torch.Tensor:
    """f_e[e, a] = sum_b ke[a, b] u_e[e, b]: one ke (k, k), u_e (E, k).

    K7 on a CUDA tensor (f32 or f64), the plain version on a CPU tensor.
    """
    return _dispatch("uniform", ke, u_e)
