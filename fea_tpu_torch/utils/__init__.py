"""Observability: solve records, timers that wait for the card, profiler
traces, and the build cache's directory. Counterpart of
``fea_tpu/utils/``."""
from .metrics import SolveRecord, record_solve, records  # noqa: F401
from .profiling import Timer, trace  # noqa: F401

__all__ = ["SolveRecord", "record_solve", "records", "Timer", "trace"]
