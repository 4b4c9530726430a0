"""Wall-clock timers that wait for the card, and ``torch.profiler``
traces. Counterpart of ``fea_tpu/utils/profiling.py``."""
from __future__ import annotations

import contextlib
import dataclasses
import os
import time

import torch

__all__ = ["Timer", "trace"]


def _tensors(value):
    """The tensors in ``value``: a tensor, a dataclass (a Solution), or a
    tuple, list or dict of them."""
    if isinstance(value, torch.Tensor):
        yield value
    elif dataclasses.is_dataclass(value) and not isinstance(value, type):
        for f in dataclasses.fields(value):
            yield from _tensors(getattr(value, f.name))
    elif isinstance(value, (tuple, list)):
        for v in value:
            yield from _tensors(v)
    elif isinstance(value, dict):
        for v in value.values():
            yield from _tensors(v)


class Timer:
    """Wall-clock context manager. A result registered by
    :meth:`set_result` is waited for on exit (every card that holds one
    of its tensors is synchronized) before the clock stops, so that
    asynchronous launches do not fake the time."""

    def __init__(self):
        self.elapsed = 0.0
        self._result = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def set_result(self, value):
        """Register tensors to wait for before stopping the clock."""
        self._result = value
        return value

    def __exit__(self, *exc):
        for device in {t.device for t in _tensors(self._result) if t.device.type == "cuda"}:
            torch.cuda.synchronize(device)
        self.elapsed = time.perf_counter() - self._t0
        return False


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` over the block, CPU activities and, where a card
    is visible, CUDA ones; the Chrome trace is written into ``log_dir`` as
    ``trace_<pid>_<ns>.json`` (open it in Perfetto or chrome://tracing).
    Yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
