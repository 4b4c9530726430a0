"""Where the CUDA kernels' build goes. Counterpart of
``fea_tpu/utils/cache.py``: the port's compiled artifacts are the nvcc
libraries of ``fea_tpu_torch/csrc``, so :func:`setup_compilation_cache`
points ``ops/nvcc.py``'s build directory at a subdirectory of a base
directory, keyed by a fingerprint of what the libraries depend on: nvcc's
version, the CUDA version torch was built for, the card's compute
capability and the host CPU's feature flags. Same machine, same
directory; any change of these, a fresh one. Without a call the build
directory is ``fea_tpu_torch/_build/``.
"""
from __future__ import annotations

import hashlib
import os
import subprocess

import torch

__all__ = ["setup_compilation_cache"]


def _cpu_flags() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    return " ".join(sorted(line.split(":", 1)[1].split()))
    except OSError:
        pass
    import platform

    return platform.processor() or platform.machine()


def _nvcc_version() -> str:
    from ..ops.nvcc import find_nvcc

    try:
        out = subprocess.run([find_nvcc(), "--version"], capture_output=True, text=True, timeout=60)
    except (RuntimeError, OSError, subprocess.SubprocessError):
        return "no nvcc"
    lines = out.stdout.strip().splitlines()
    return lines[-1] if lines else "no nvcc"


def _capability() -> str:
    if not torch.cuda.is_available():
        return "no card"
    return "sm_%d%d" % torch.cuda.get_device_capability(0)


def fingerprint() -> str:
    """What the built libraries depend on, as one string."""
    return "|".join([_nvcc_version(), str(torch.version.cuda), _capability(), _cpu_flags()])


def setup_compilation_cache(base_dir: str) -> str:
    """Build the CUDA kernels into a fingerprint-keyed subdirectory of
    ``base_dir`` (see the module's note); returns that directory."""
    from ..ops import nvcc

    key = hashlib.sha256(fingerprint().encode()).hexdigest()[:16]
    path = os.path.join(os.path.abspath(base_dir), key)
    os.makedirs(path, exist_ok=True)
    nvcc.set_build_dir(path)
    return path
