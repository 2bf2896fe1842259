"""The arithmetic of the benchmark's numbers: intervals, percentiles,
rates, and the device's busy time in a ``torch.profiler`` chrome trace.

The busy time is the union of the kernel, copy and set intervals that
API calls inside a window launched, and the idle share is one less busy
over the window's span (the port's ``utils/trace.layer_breakdown``,
icer_compression_tpu_torch/utils/trace.py:84-146, copied here so that the
program cannot move it).
"""

from __future__ import annotations

import json
import math

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def union(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, -math.inf
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def clipped(intervals, lo: float, hi: float) -> list:
    """The parts of ``intervals`` inside [lo, hi]."""
    return [(max(a, lo), min(b, hi)) for a, b in intervals
            if b > lo and a < hi]


def percentile(values, q: float) -> float:
    """The nearest-rank ``q``-th percentile of all ``values``: the
    smallest value with at least q% of the values at or below it."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    return v[max(0, math.ceil(q / 100 * len(v)) - 1)]


def rate(amount: float, seconds: float) -> float:
    """All the work over all of the window."""
    if seconds <= 0:
        raise ValueError("empty window")
    return amount / seconds


class Trace:
    """A chrome trace exported by ``torch.profiler``: host ranges
    (``record_function``), the API calls and the device work they
    launched.  Times in seconds, on the trace's clock."""

    def __init__(self, events: list):
        self.events = events
        self.ranges = [e for e in events
                       if e.get("cat") == "user_annotation"]
        # the CUDA API calls (runtime and lower level) that launched work
        self.api = {e["args"]["correlation"]: e for e in events
                    if str(e.get("cat", "")).startswith("cuda_")
                    and "correlation" in e.get("args", {})}
        self.work = [e for e in events if e.get("cat") in DEVICE_CATS]

    @classmethod
    def load(cls, path) -> "Trace":
        with open(path) as f:
            data = json.load(f)
        return cls(data["traceEvents"] if isinstance(data, dict) else data)

    def spans(self, name: str) -> list:
        """(start, end) of every host range called ``name``."""
        return [(e["ts"] / 1e6, (e["ts"] + e["dur"]) / 1e6)
                for e in self.ranges if e.get("name") == name]

    def launched(self, lo: float, hi: float) -> list:
        """Device work whose launching API call lies in [lo, hi]:
        (name, start, end)."""
        out = []
        for e in self.work:
            run = self.api.get(e.get("args", {}).get("correlation"))
            if run is not None and lo <= run["ts"] / 1e6 <= hi:
                out.append((e.get("name", ""), e["ts"] / 1e6,
                            (e["ts"] + e["dur"]) / 1e6))
        return out

    def busy(self, work, lo: float, hi: float) -> float:
        """Seconds of [lo, hi] in which some of ``work`` ran."""
        return union(clipped([(a, b) for _, a, b in work], lo, hi))


def kernel_seconds(work, fragments) -> float:
    """Device seconds of the kernels whose name holds any of
    ``fragments``."""
    return sum(b - a for n, a, b in work
               if any(f in n for f in fragments))


def top_ops(work, n: int = 10) -> list:
    """The ``n`` device operations by name that took the most seconds."""
    by: dict = {}
    for name, a, b in work:
        by[name] = by.get(name, 0.0) + (b - a)
    return sorted(([k, v] for k, v in by.items()),
                  key=lambda kv: -kv[1])[:n]


def idle_gaps(work, lo: float, hi: float, spans: dict, n: int = 10) -> list:
    """The ``n`` longest stretches of [lo, hi] with no device work, each
    named by the innermost harness span around its middle ("other" when
    none): [[name, seconds], ...]."""
    gaps, end = [], lo
    for a, b in sorted((a, b) for _, a, b in work):
        if a > end:
            gaps.append((end, min(a, hi)))
        end = max(end, b)
        if end >= hi:
            break
    if end < hi:
        gaps.append((end, hi))
    out = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:n]:
        mid = (a + b) / 2
        inner = [(e - s, name) for name, iv in spans.items()
                 for s, e in iv if s <= mid <= e]
        out.append([min(inner)[1] if inner else "other", b - a])
    return out
