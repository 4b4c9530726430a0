"""Observability: solve records, timers that wait for the card, profiler
traces, the program's spans and counters, and the build cache's
directory. Counterpart of ``fea_tpu/utils/``."""
from .metrics import SolveRecord, record_solve, records  # noqa: F401
from .profiling import SpanRecord, Timer, count, counters, reset, span, spans, trace  # noqa: F401

__all__ = ["SolveRecord", "record_solve", "records", "Timer", "trace", "SpanRecord", "span", "spans", "count",
           "counters", "reset"]
