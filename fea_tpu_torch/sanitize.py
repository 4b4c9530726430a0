"""The NaN sanitizer of ``solve(debug_nans=True)``, the counterpart of the
reference's ``jax.debug_nans``.

Inside :func:`debug_nans` every torch operation's floating outputs are
checked as the operation returns, and the first one that holds a NaN
raises ``FloatingPointError`` naming the operation, where the reference's
first NaN-producing primitive raises. Infs pass, as in JAX. Not checked:
views (their data was checked where it was made) and the allocations
whose memory nothing has written yet (``empty`` and its kin).

torch's dispatcher does not see the CUDA kernels bound through ctypes
(K1-K7), so their wrappers call :func:`check` on their output while
:func:`active` is true; nor does it see the operations inside a CUDA graph
replay, so the staged FCG loop runs its step eagerly while the sanitizer
is on. For debugging only: every check reads a flag back from the
device, so the host waits for the card after every operation.
"""
from __future__ import annotations

import contextlib

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

__all__ = ["active", "check", "debug_nans"]

_aten = torch.ops.aten
# operations whose output is memory that nothing has written yet
_UNWRITTEN = frozenset({
    _aten.empty.memory_format, _aten.empty_like.default, _aten.empty_strided.default,
    _aten.new_empty.default, _aten.new_empty_strided.default, _aten.resize_.default,
})
_DEPTH = 0


def active() -> bool:
    """True inside :func:`debug_nans`."""
    return _DEPTH > 0


def check(name: str, t: torch.Tensor) -> None:
    """Raise ``FloatingPointError`` if the floating tensor ``t`` holds a NaN."""
    if t.is_floating_point() and t.numel() and bool(torch.isnan(t).any()):
        raise FloatingPointError(f"invalid value (nan) produced by {name}, shape {tuple(t.shape)}, on {t.device}")


class _NanCheck(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view and func not in _UNWRITTEN:
            for t in tree_leaves(out):
                if isinstance(t, torch.Tensor):
                    check(str(func), t)
        return out


@contextlib.contextmanager
def debug_nans():
    """Run the block under the sanitizer (see the module's note)."""
    global _DEPTH
    _DEPTH += 1
    try:
        with _NanCheck():
            yield
    finally:
        _DEPTH -= 1
