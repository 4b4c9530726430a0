"""Native (C++) host-side checks: exact IEEE-f64 stencil applies and
masked residuals on the host.

A copy of the reference's ``fea_tpu/native`` (its C++ source is
``stencil.cpp`` beside this file), built at first use with the system
``g++`` into ``fea_tpu_torch/native/_build/`` and loaded through
:mod:`ctypes`. It never runs on the card: it checks on the host what the
card computed, independently of the kernels, at ~20x the speed of the
NumPy twin :func:`fea_tpu_torch.ops.structured.stencil_apply_np`.

Every function takes NumPy arrays or tensors (a tensor is copied to the
host). As in the reference, a library caller never needs a compiler:
without one :func:`available` is false, :func:`stencil_apply_host` takes
the NumPy twin and the other functions return None.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

__all__ = [
    "available",
    "get_lib",
    "pack_var_weights",
    "region_weight_table",
    "stencil_apply_host",
    "stencil_residual_host",
    "stencil_residual_slab_host",
    "var_stencil_apply_host",
    "var_stencil_residual_host",
]

_LIB: Optional[ctypes.CDLL] = None
_LIB_TRIED = False
_WTABLES: dict[bytes, np.ndarray] = {}


def _build_and_load() -> Optional[ctypes.CDLL]:
    """Compile stencil.cpp into a .so keyed by its content and the host's
    CPU flags (a ``-march=native`` build must not reach another CPU), and
    load it. Concurrent processes are safe (a temporary name, then an
    atomic rename). Any failure returns None."""
    from ..utils.cache import _cpu_flags

    src = Path(__file__).resolve().parent / "stencil.cpp"
    try:
        code = src.read_bytes()
    except OSError:
        return None
    tag = hashlib.sha256(code + _cpu_flags().encode()).hexdigest()[:16]
    build_dir = src.parent / "_build"
    so = build_dir / f"libfeastencil_{tag}.so"
    if not so.exists():
        tmp_name = None
        try:
            build_dir.mkdir(parents=True, exist_ok=True)
            with tempfile.NamedTemporaryFile(dir=build_dir, suffix=".so", delete=False) as tmp:
                tmp_name = tmp.name
            cmd = ["g++", "-O3", "-march=native", "-funroll-loops", "-shared", "-fPIC", str(src), "-o", tmp_name]
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
            if proc.returncode != 0:
                return None
            os.replace(tmp_name, so)
            tmp_name = None
        except Exception:  # noqa: BLE001 - no compiler, a read-only tree: the caller falls back
            return None
        finally:
            if tmp_name is not None:
                try:
                    os.unlink(tmp_name)
                except OSError:
                    pass
    try:
        lib = ctypes.CDLL(str(so))
    except OSError:
        return None
    dp = ctypes.POINTER(ctypes.c_double)
    i64 = ctypes.c_int64
    lib.fea_stencil_apply_f64.argtypes = [dp, dp, dp] + [i64] * 3
    lib.fea_stencil_apply_f64.restype = None
    lib.fea_stencil_residual_f64.argtypes = [dp] * 6 + [i64] * 3
    lib.fea_stencil_residual_f64.restype = ctypes.c_double
    lib.fea_varstencil_apply_f64.argtypes = [dp, dp, dp] + [i64] * 3
    lib.fea_varstencil_apply_f64.restype = None
    lib.fea_varstencil_residual_f64.argtypes = [dp] * 6 + [i64] * 3
    lib.fea_varstencil_residual_f64.restype = ctypes.c_double
    lib.fea_stencil_residual_slab_f64.argtypes = [dp] * 6 + [i64] * 6
    lib.fea_stencil_residual_slab_f64.restype = ctypes.c_double
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built at the first call; None without one."""
    global _LIB, _LIB_TRIED
    if not _LIB_TRIED:
        _LIB_TRIED = True
        _LIB = _build_and_load()
    return _LIB


def available() -> bool:
    return get_lib() is not None


def _f64(a) -> np.ndarray:
    """A contiguous f64 host array of a NumPy array or a tensor."""
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.ascontiguousarray(a, np.float64)


def region_weight_table(ke) -> np.ndarray:
    """(27 regions, 27 offsets, 3, 3) f64 node-stencil weights of Ke
    (``ops/cuda_stencil.py::region_weight_table``), cached on Ke's bytes."""
    from ..ops.cuda_stencil import region_weight_table as table

    ke = _f64(ke)
    key = ke.tobytes()
    W = _WTABLES.get(key)
    if W is None:
        W = _WTABLES[key] = table(ke)
    return W


def _dp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def stencil_apply_host(ke, g, dims: tuple[int, int, int]) -> np.ndarray:
    """Exact-f64 ``K @ u`` on the (nz+1, ny+1, nx+1, 3) node grid ``g`` of
    a voxel box of ``dims`` elements. Agrees with
    :func:`fea_tpu_torch.ops.structured.stencil_apply_np` to f64 rounding,
    which it falls back to without the library."""
    nx, ny, nz = dims
    Z, Y, X = nz + 1, ny + 1, nx + 1
    g = _f64(g)
    if g.shape != (Z, Y, X, 3):
        raise ValueError(f"g must be {(Z, Y, X, 3)} for dims {dims}, got {g.shape}")
    lib = get_lib()
    if lib is None:
        from ..ops.structured import stencil_apply_np

        return stencil_apply_np(_f64(ke), g, dims)
    out = np.empty_like(g)
    lib.fea_stencil_apply_f64(_dp(region_weight_table(ke)), _dp(g), _dp(out), X, Y, Z)
    return out


def stencil_residual_host(ke, u, b, free, dims: tuple[int, int, int]):
    """The masked residual ``r = free * (b - K u)``, its norm, and ``K u``,
    in one pass over the grid, each returned flat (N, 3); None without
    the library."""
    lib = get_lib()
    if lib is None:
        return None
    nx, ny, nz = dims
    Z, Y, X = nz + 1, ny + 1, nx + 1
    u, b, free = (_f64(a).reshape(Z, Y, X, 3) for a in (u, b, free))
    r = np.empty_like(u)
    au = np.empty_like(u)
    nrm2 = lib.fea_stencil_residual_f64(_dp(region_weight_table(ke)), _dp(u), _dp(b), _dp(free), _dp(r), _dp(au),
                                        X, Y, Z)
    return r.reshape(-1, 3), float(np.sqrt(nrm2)), au.reshape(-1, 3)


def pack_var_weights(w) -> np.ndarray:
    """Node-major packing of a curvilinear weight field for the native
    variable-weight functions: (27, Z, Y, X, 3, 3), the reference's
    layout (a port field: ``ops.curvilinear.grid_view(w)``) ->
    contiguous (Z, Y, X, 27, 3, 3), each node's 27x9 block row one
    stream."""
    w = _f64(w)
    if w.ndim != 6 or w.shape[0] != 27 or w.shape[4:] != (3, 3):
        raise ValueError(f"w must be (27, Z, Y, X, 3, 3), got {w.shape}")
    return np.ascontiguousarray(np.moveaxis(w, 0, 3))


def var_stencil_apply_host(Wn: np.ndarray, g) -> Optional[np.ndarray]:
    """Exact-f64 curvilinear ``K @ u`` on the host: ``Wn`` from
    :func:`pack_var_weights`, ``g`` the (Z, Y, X, 3) node grid. None
    without the library."""
    lib = get_lib()
    if lib is None:
        return None
    g, Wn = _f64(g), _f64(Wn)
    Z, Y, X = g.shape[:3]
    if Wn.shape != (Z, Y, X, 27, 3, 3):
        raise ValueError(f"Wn must be {(Z, Y, X, 27, 3, 3)} for g {g.shape}, got {Wn.shape}")
    out = np.empty_like(g)
    lib.fea_varstencil_apply_f64(_dp(Wn), _dp(g), _dp(out), X, Y, Z)
    return out


def var_stencil_residual_host(Wn: np.ndarray, u, b, free):
    """The masked residual, its norm and ``K u`` of the curvilinear
    family in one pass, each flat (N, 3); None without the library."""
    lib = get_lib()
    if lib is None:
        return None
    Wn = _f64(Wn)
    if Wn.ndim != 6 or Wn.shape[3:] != (27, 3, 3):
        raise ValueError(f"Wn must be (Z, Y, X, 27, 3, 3), got {Wn.shape}")
    Z, Y, X = Wn.shape[:3]
    u, b, free = (_f64(a).reshape(Z, Y, X, 3) for a in (u, b, free))
    r = np.empty_like(u)
    au = np.empty_like(u)
    nrm2 = lib.fea_varstencil_residual_f64(_dp(Wn), _dp(u), _dp(b), _dp(free), _dp(r), _dp(au), X, Y, Z)
    return r.reshape(-1, 3), float(np.sqrt(nrm2)), au.reshape(-1, 3)


def stencil_residual_slab_host(ke, g_slab, b_slab, free_slab, r_slab: np.ndarray, au_slab: np.ndarray,
                               dims: tuple[int, int, int], z0: int, g0: int) -> Optional[float]:
    """Rows ``[z0, z0 + nz_loc)`` of the masked residual from a ``g_slab``
    that starts at plane ``g0``, written into the caller's ``r_slab`` and
    ``au_slab`` (contiguous f64 views); returns the slab's squared norm,
    None without the library."""
    lib = get_lib()
    if lib is None:
        return None
    nx, ny, nz = dims
    Z, Y, X = nz + 1, ny + 1, nx + 1
    g_slab, b_slab, free_slab = (_f64(a) for a in (g_slab, b_slab, free_slab))
    nz_loc = b_slab.shape[0]
    if g_slab.shape[1:] != (Y, X, 3) or b_slab.shape[1:] != (Y, X, 3):
        raise ValueError(f"slabs must be (planes, {Y}, {X}, 3)")
    for name, out in (("r_slab", r_slab), ("au_slab", au_slab)):
        if out.shape != b_slab.shape or out.dtype != np.float64 or not out.flags.c_contiguous:
            raise ValueError(f"{name} must be a contiguous f64 array of b_slab's shape {b_slab.shape}")
    return float(lib.fea_stencil_residual_slab_f64(
        _dp(region_weight_table(ke)), _dp(g_slab), _dp(b_slab), _dp(free_slab), _dp(r_slab), _dp(au_slab),
        X, Y, Z, z0, nz_loc, g0,
    ))
