"""Build a CUDA source of the package with nvcc at first use, and load it.

Each source under ``fea_tpu_torch/csrc/`` is compiled on its own for
``sm_90a`` into a shared library with a plain C interface, in
``fea_tpu_torch/_build/`` (or the directory of :func:`set_build_dir`)
and keyed by the source's content and flags, and loaded with
:mod:`ctypes`. Sources build independently, so callers that
need several may build them in parallel threads. A failed build raises
with the compiler's output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

__all__ = ["CSRC", "NVCC_FLAGS", "build_dir", "find_nvcc", "launch_on", "load_library", "set_build_dir"]

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
_BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)


def build_dir() -> Path:
    """Where the libraries are built."""
    return _BUILD_DIR


def set_build_dir(path) -> None:
    """Build (and look for) the libraries in ``path`` from now on; a
    library already loaded stays loaded
    (``utils.cache.setup_compilation_cache`` keys the directory)."""
    global _BUILD_DIR
    _BUILD_DIR = Path(path)


def find_nvcc() -> str:
    """Path of nvcc: on PATH, else in $CUDA_HOME/bin (default /usr/local/cuda)."""
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found on PATH or in $CUDA_HOME/bin: cannot build the CUDA kernels")


def load_library(source: Path, stem: str) -> ctypes.CDLL:
    """Compile ``source`` (once per content and flags) and load it.

    Concurrent builds are safe: each compiles to a temporary name and
    renames it into place. Any failure raises.
    """
    code = source.read_bytes()
    tag = hashlib.sha256(code + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    so = _BUILD_DIR / f"lib{stem}_{tag}.so"
    if not so.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=_BUILD_DIR, suffix=".so")
        os.close(fd)
        try:
            cmd = [find_nvcc(), *NVCC_FLAGS, str(source), "-o", tmp]
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                    f"{proc.stdout}\n{proc.stderr}"
                )
            os.replace(tmp, so)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return ctypes.CDLL(str(so))


def launch_on(device: torch.device, entry, *args) -> int:
    """``entry(*args, stream)`` with ``device`` current and ``stream`` its
    current stream: how every kernel wrapper calls its C entry. The device
    guard is taken only when another device is current; it costs the host
    several microseconds, and a Krylov loop pays the host for every launch."""
    if torch.cuda.current_device() == device.index:
        return entry(*args, torch.cuda.current_stream(device).cuda_stream)
    with torch.cuda.device(device):
        return entry(*args, torch.cuda.current_stream(device).cuda_stream)
