"""The program's own spans, read by the per-layer readers of its stages.

``fea_tpu_torch`` keeps the spans it finished in a bounded ring
(``fea_tpu_torch.utils.spans()``): each has a name, the request id of its
root (one ``fea.solve`` or ``fea.solve_many`` a call), its own index and
its parent's, and its start and end on ``time.perf_counter()``, the clock
of the client's ``Record``. After the window this module gives each of the
window's requests outside the traced slice its root span and the spans
under it. It reads the program through ``sys.modules``, as the client
reads ``staged.COUNTS``, and imports nothing of it; a program without spans
reads None, and so does a window whose requests do not each hold exactly
one root with every span of it still in the ring.
"""
from __future__ import annotations

import dataclasses
import statistics
import sys

PROGRAM = "fea_tpu_torch"


@dataclasses.dataclass
class Call:
    record: object  # the client's Record of the request
    root: object  # its root span
    spans: list  # every span of the request, its root included

    def named(self, name: str) -> list:
        return [s for s in self.spans if s.name == name]

    def ms(self, name: str) -> float:
        """Milliseconds in the spans named ``name``, summed."""
        return ms(self.named(name))

    def children(self, parent) -> list:
        return [s for s in self.spans if s.parent == parent.index]


def ms(spans) -> float:
    """Milliseconds in ``spans``, summed."""
    return 1e3 * sum(s.end - s.start for s in spans)


def _ring():
    utils = getattr(sys.modules.get(PROGRAM), "utils", None)
    read = getattr(utils, "spans", None)
    return None if read is None else read()


def calls(run):
    """A :class:`Call` for each request of the window outside the traced
    slice, or None."""
    ring = _ring()
    records = [rec for rec in run.requests if not rec.profiled]
    if not ring or not records:
        return None
    by_request: dict = {}
    for s in ring:
        by_request.setdefault(s.request, []).append(s)
    roots = [s for s in ring if s.parent is None]
    out = []
    for rec in records:
        t0, t1 = rec.done_at - rec.latency_s, rec.done_at
        inside = [s for s in roots if t0 <= s.start and s.end <= t1]
        if len(inside) != 1:
            return None
        root = inside[0]
        spans = by_request[root.request]
        # one request on one thread takes consecutive indices from its root's:
        # a gap means the ring dropped part of it
        if sorted(s.index for s in spans) != list(range(root.index, root.index + len(spans))):
            return None
        out.append(Call(rec, root, spans))
    return out


def median(run, per_call):
    """The median over the window's requests of ``per_call(call)``, or
    None where :func:`calls` reads None."""
    found = calls(run)
    return None if found is None else statistics.median(per_call(c) for c in found)


def self_ms(call: Call) -> float:
    """Milliseconds of the root span that no direct child covers."""
    covered, last = 0.0, call.root.start
    for s in sorted(call.children(call.root), key=lambda s: s.start):
        start, end = max(s.start, last), min(s.end, call.root.end)
        if end > start:
            covered += end - start
            last = end
    return 1e3 * (call.root.end - call.root.start - covered)
