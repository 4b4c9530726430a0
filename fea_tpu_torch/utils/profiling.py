"""Wall-clock timers that wait for the card, ``torch.profiler`` traces,
and the program's spans and counters. Counterpart of
``fea_tpu/utils/profiling.py``, which has the timer and the trace; the
spans and counters are the port's own.

**Spans.** ``with span("fea.route"): ...`` (or ``@span(name)`` on a
function) times a stage of a call on ``time.perf_counter()``'s clock. A
span opened while no other is open on its thread is a root: its own index,
a new number from a process-wide count, is the request id, and every span
opened inside it carries that id and the index of the span around it, its
parent. Each finished span is one
:class:`SpanRecord` in a bounded ring (the newest ``RING_SIZE``), read by
:func:`spans`. While a ``torch.profiler`` records, each span also opens
``record_function(name)``, so the stages show in the profiler's Chrome
trace (``trace(dir)``) as ``user_annotation`` events on the profiler's
clock; while none records, a span costs two clock reads and an append.
The program opens them at its layer boundaries:

  ``fea.solve``, ``fea.solve_many``   the entry (the roots)
  ``fea.route``                      routing (the grid detectors)
  ``fea.build.operator``             the operator build of each route
  ``fea.build.hierarchy``            the preconditioner build of each route
  ``fea.build.curv.*``               inside those, the curvilinear build's
                                     stages on the card: ``jacobians``,
                                     ``weights``, ``rap`` (one a level),
                                     ``levels``, ``coarse``
  ``fea.fcg.capture``                the staged FCG's graph captures
  ``fea.fcg.run``, ``fea.fcg.wait``  a staged FCG pass; its waits for the card
  ``fea.certify``, ``fea.certify.pass``  certification of a case; a correction pass

**Counters.** :func:`count` adds to a named counter, :func:`counters`
reads them all: ``certify.passes`` (correction passes run),
``certify.stalled`` (converged passes that left the true residual no
lower), ``certify.uncertified`` (cases handed back above tol),
``build_cache.hit.<kind>`` / ``build_cache.miss.<kind>`` and
``curv.coarse.cholesky`` / ``curv.coarse.lu`` (a curvilinear build whose
coarsest dense matrix was inverted by Cholesky, or by LU where it was
not positive definite). :func:`reset` clears the ring and the counters.

Beside them, outside this module's counters and kept as process totals
(zero them before a solve, read them after): the kernels' launch counts
(``ops.cuda_stencil.LAUNCHES``, ``ops.cuda_varstencil.LAUNCHES``,
``ops.cuda_apply.LAUNCHES``, ``ops.cuda_curv_weights.LAUNCHES``, the
extruded apply's ``ops.cuda_extruded.LAUNCHES``), the
extruded route's block-Thomas solves (``ops.extruded_mg.LAUNCHES["thomas"]``:
one a launch of the block-Thomas kernel on the card, where it takes the
factors, else one an ``addmv_``, 2 (L - 1) a solve of L layers; two solves
an extruded preconditioner's apply; ``LAUNCHES["thomas_kernel"]`` the
kernel's alone) and the staged FCG's ``solve.staged.COUNTS``
(``steps``: replays or eager steps). The V-cycle runs inside the captured
FCG step, where no span sees it: its launch counts, credited to every
replay, are its record there.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import itertools
import os
import threading
import time
from collections import deque
from typing import NamedTuple, Optional

import torch

__all__ = ["RING_SIZE", "SpanRecord", "Timer", "count", "counters", "reset", "span", "spans", "trace"]

RING_SIZE = 65536  # finished spans kept, the newest


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


class SpanRecord(NamedTuple):
    """One finished span: ``name``; ``request``, the id of its call (its
    root's index); ``index``, its own serial number, and ``parent``, the
    index of the span it opened in (None at a root); ``start`` and ``end``,
    in seconds on ``time.perf_counter()``'s clock. On one thread the spans
    of a request take consecutive indices, its root's the first."""

    name: str
    request: int
    index: int
    parent: Optional[int]
    start: float
    end: float

    @property
    def seconds(self) -> float:
        return self.end - self.start


# The ring and the open spans hold plain tuples of numbers and names, which
# the garbage collector stops tracking: a full ring costs its passes nothing.
_RING: deque = deque(maxlen=RING_SIZE)
_COUNTS: dict = {}
_INDICES = itertools.count()  # span indices; a root's is its request id
_profiler_enabled = torch._C._autograd._profiler_enabled  # true while any torch profiler records


class _Open(threading.local):
    def __init__(self):
        # (name, request, index, parent, record_function or None, start) of
        # each span open on this thread, the innermost last
        self.stack: list = []


_OPEN = _Open()


class span:
    """A named span: a context manager (``as`` gives the span itself,
    whose :attr:`seconds` read after the block is its time) or a decorator
    that opens it around each call. Its state lives on its thread's stack
    of open spans, so one span serves nested and concurrent uses."""

    __slots__ = ("name", "last")

    def __init__(self, name: str):
        self.name = name
        self.last = None  # the span's latest record, as a tuple

    def __enter__(self) -> "span":
        stack = _OPEN.stack
        rf = None
        if _profiler_enabled():
            rf = torch.profiler.record_function(self.name)
            rf.__enter__()
        index = next(_INDICES)
        if stack:
            top = stack[-1]
            stack.append((self.name, top[1], index, top[2], rf, time.perf_counter()))
        else:
            stack.append((self.name, index, index, None, rf, time.perf_counter()))
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        end = time.perf_counter()
        name, request, index, parent, rf, start = _OPEN.stack.pop()
        if rf is not None:
            rf.__exit__(exc_type, exc, tb)
        self.last = record = (name, request, index, parent, start, end)
        _RING.append(record)
        return False

    @property
    def seconds(self) -> float:
        """Seconds of this span's latest use."""
        return self.last[5] - self.last[4]

    def __call__(self, fn):
        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with self:
                return fn(*args, **kwargs)

        return spanned


def spans() -> list:
    """The finished spans in the ring as :class:`SpanRecord`, oldest first
    (in the order they closed: a parent after its children)."""
    return list(map(SpanRecord._make, _RING))


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    _COUNTS[name] = _COUNTS.get(name, 0) + n


def counters() -> dict:
    """Every counter by name."""
    return dict(_COUNTS)


def reset() -> None:
    """Clear the ring of spans and the counters."""
    _RING.clear()
    _COUNTS.clear()
