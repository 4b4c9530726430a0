"""What the port's tests share: the JAX package's scripts run as child
processes on the CPU, all at once, the check that a port record came from
the CPU with no kernel launched, and an operator whose right-hand side is
moved, to force certification's correction passes.

A test file builds its module fixture from :func:`run_all` over its own
table of scripts: ``name -> (script relative to the repo root, arguments)``.
"""
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# the port modules' arguments for an in-process run on the CPU
CPU = ["--device", "cpu", "--deadline-s", "0"]


def run_script(script: str, args: list) -> subprocess.CompletedProcess:
    """``script`` (a JAX script, relative to the repo root) with ``--cpu``
    under ``JAX_PLATFORMS=cpu``."""
    return subprocess.run([sys.executable, str(ROOT / script), "--cpu", *args], cwd=ROOT, capture_output=True,
                          text=True, timeout=600, env={**os.environ, "JAX_PLATFORMS": "cpu"})


def run_all(scripts: dict) -> dict:
    """Every script of ``scripts`` at once: name -> (its last line's
    record, its stderr). A script that exits non-zero fails the caller."""
    with ThreadPoolExecutor(max_workers=len(scripts)) as pool:
        procs = {name: pool.submit(run_script, *job) for name, job in scripts.items()}
        out = {}
        for name, fut in procs.items():
            proc = fut.result()
            assert proc.returncode == 0, proc.stderr[-2000:]
            out[name] = (json.loads(proc.stdout.strip().splitlines()[-1]), proc.stderr)
        return out


def no_kernel_ran(rec: dict) -> bool:
    """A port record made on the CPU, with every launch count zero."""
    return rec["device"] == "cpu" and not any(rec["launches"].values())


class ShiftedRhs:
    """The operator ``op`` with its right-hand side moved by ``shift``: the
    first FCG pass converges on a system ``shift`` away from the loads', so
    that its true residual lands above tol by a known amount and only the
    correction passes, which take the true residual as their rhs, can
    certify it."""

    def __init__(self, op, shift):
        self._op, self._shift = op, shift

    def __getattr__(self, name):
        return getattr(self._op, name)

    def rhs(self, loads, prescribed):
        return self._op.rhs(loads, prescribed) + self._shift
