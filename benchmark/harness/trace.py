"""From a ``torch.profiler`` trace of the traced slice to what the
per-layer readers and the result line take: the device's activities
(kernels, copies, sets; not the device-side ranges of host annotations)
inside the slice, each with its launch's thread blocks where the trace
gives them, the seconds the device was busy
(the union of their intervals), the slice's length, and a breakdown: the
device operations that took most time, and the longest idle gaps of the
device by what the host was doing meanwhile (the innermost host event
around the gap's middle).
"""
from __future__ import annotations

import dataclasses

import numpy as np

SLICE = "bench.slice"  # the host span around the traced slice
TOP = 10
NAME_CHARS = 120


@dataclasses.dataclass
class Trace:
    kernels: list  # (name, microseconds, thread blocks or None) of every device activity in the slice
    busy_s: float
    window_s: float
    breakdown: dict


def _merge(intervals: list) -> list:
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _short(name: str) -> str:
    return name if len(name) <= NAME_CHARS else name[:NAME_CHARS - 3] + "..."


DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")  # the trace's categories of device activity


def reduce(chrome: dict) -> Trace:
    """Reduce the Chrome trace (``export_chrome_trace``'s JSON, loaded) of
    one traced slice."""
    events = [e for e in chrome["traceEvents"] if e.get("ph") == "X" and "dur" in e]
    spans = [e for e in events if e["name"] == SLICE and e.get("cat") == "user_annotation"]
    if len(spans) != 1:
        raise RuntimeError(f"trace: {len(spans)} '{SLICE}' spans, expected 1")
    t0, t1 = float(spans[0]["ts"]), float(spans[0]["ts"]) + float(spans[0]["dur"])
    dev = []
    for e in events:
        if e.get("cat") in DEVICE:
            s, t = max(float(e["ts"]), t0), min(float(e["ts"]) + float(e["dur"]), t1)
            grid = e.get("args", {}).get("grid")
            if t > s:
                dev.append((e["name"], s, t, int(np.prod(grid)) if grid else None))
    merged = _merge([[s, e] for _, s, e, _ in dev])
    busy_us = sum(e - s for s, e in merged)
    edges = [t0] + [x for iv in merged for x in iv] + [t1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]

    by_op: dict = {}
    for n, s, e, _ in dev:
        by_op[n] = by_op.get(n, 0.0) + (e - s)
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP]

    # the host's innermost event around the middle of each of the longest gaps
    host = [e for e in events if e.get("cat") not in DEVICE + ("gpu_user_annotation",) and e["name"] != SLICE]
    hs = np.array([float(e["ts"]) for e in host], np.float64)
    he = hs + np.array([float(e["dur"]) for e in host], np.float64)
    by_gap: dict = {}
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:500]:
        mid = 0.5 * (s + e)
        around = np.nonzero((hs <= mid) & (he >= mid))[0]
        label = host[around[np.argmin(he[around] - hs[around])]]["name"] if around.size else "(no host event)"
        by_gap[label] = by_gap.get(label, 0.0) + (e - s)
    idle = sorted(by_gap.items(), key=lambda kv: -kv[1])[:TOP]
    return Trace(
        kernels=[(n, e - s, b) for n, s, e, b in dev],
        busy_s=busy_us * 1e-6,
        window_s=(t1 - t0) * 1e-6,
        breakdown={"device_ops": [[_short(n), us * 1e-6] for n, us in ops],
                   "idle_gaps": [[_short(n), us * 1e-6] for n, us in idle]},
    )
