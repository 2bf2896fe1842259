"""The program's own spans, counts and stage marks in a traced window.

The port records, while ``torch.profiler`` records (its ``utils/trace``):
host ranges ``icer.<name>`` at its layer boundaries, zero-length ranges
``count:<name>=<n>``, and on the card one-thread kernels
``icer_mark<stage>`` inside every device pass, eager or replayed, so that
each device record of a pass belongs to the stage that the last mark
before it (by start time) opened, until the pass's ``end`` mark.  This
module reads them from ``run.trace`` (a ``tracemath.Trace``) within the
traced window ``run.trace_window``, with its own copy of the stage
numbers, so that the program cannot move them.
A program without them (an older commit) leaves nothing to read: every
function returns None (or an empty result) and raises nothing.
"""

from __future__ import annotations

import collections
import re

from .tracemath import union

PREFIX = "icer."
COUNT = re.compile(r"^count:(.+)=(-?\d+)$")
MARK = re.compile(r"icer_mark<(\d+)>")
# the program's stage ids (icer_compression_tpu_torch/utils/trace.STAGES)
STAGES = {"transform": 0, "context_model": 1, "coder_input": 2,
          "coder_kernel": 3, "sort_pack": 4, "k2": 5, "finalize": 6,
          "end": 7}


def _window_ranges(run) -> list:
    if run.trace is None:
        return []
    lo, hi = run.trace_window
    return [e for e in run.trace.ranges if lo <= e["ts"] / 1e6 <= hi]


def spans(run, name: str | None = None) -> list:
    """The program's span events in the window (``icer.<name>``, or every
    one)."""
    return [e for e in _window_ranges(run)
            if e.get("name", "").startswith(PREFIX)
            and (name is None or e["name"] == PREFIX + name)]


def counts(run) -> dict:
    """{name: sum} of the program's counts in the window."""
    out: dict = collections.Counter()
    for e in _window_ranges(run):
        m = COUNT.match(e.get("name", ""))
        if m:
            out[m.group(1)] += int(m.group(2))
    return dict(out)


def self_seconds(run, name: str):
    """Host seconds inside the spans ``icer.<name>`` of the window outside
    the program's spans nested in them (same thread), or None when the
    window has none."""
    evs = spans(run)
    own = {id(e): e["dur"] for e in evs}
    stack: list = []
    for e in sorted(evs, key=lambda e: (e.get("tid"), e["ts"], -e["dur"])):
        while stack and (stack[-1].get("tid") != e.get("tid")
                         or e["ts"] >= stack[-1]["ts"] + stack[-1]["dur"]):
            stack.pop()
        if stack:
            own[id(stack[-1])] -= e["dur"]
        stack.append(e)
    mine = [e for e in evs if e["name"] == PREFIX + name]
    if not mine:
        return None
    return sum(own[id(e)] for e in mine) / 1e6


def replays(run) -> list:
    """The device records of each graph replay launched in the window: a
    list per replay of (name, start, end) in seconds, by start time."""
    if run.trace is None:
        return []
    lo, hi = run.trace_window
    by: dict = collections.defaultdict(list)
    for e in run.trace.work:
        corr = e.get("args", {}).get("correlation")
        api = run.trace.api.get(corr)
        if api is None or "GraphLaunch" not in api.get("name", "") \
                or not lo <= api["ts"] / 1e6 <= hi:
            continue
        by[corr].append((e.get("name", ""), e["ts"] / 1e6,
                         (e["ts"] + e["dur"]) / 1e6))
    return [sorted(recs, key=lambda r: r[1]) for recs in by.values()]


def stage_split(records) -> tuple:
    """(name, start, end) records in start order by stage: ({stage id:
    [(start, end)]}, the records outside a pass: before a first mark or
    after an ``end`` mark, which itself counts in neither)."""
    by: dict = collections.defaultdict(list)
    stage, outside = None, []
    for name, a, b in records:
        m = MARK.search(name)
        if m:
            stage = int(m.group(1))
            if stage == STAGES["end"]:
                stage = None
                continue
        if stage is None:
            outside.append((a, b))
        else:
            by[stage].append((a, b))
    return by, outside


def stage_seconds(run):
    """{stage id: device seconds} of the window's device passes, eager or
    replayed: each stage's records by start time (``stage_split``), the
    union of their intervals; None when the window holds no mark."""
    if run.trace is None:
        return None
    by, _outside = stage_split(sorted(run.work, key=lambda r: r[1]))
    if not by:
        return None
    return {stage: union(iv) for stage, iv in by.items()}


def stage_ms_per_mp(run, stage: str, mp: float):
    """Device ms of ``stage`` in the window's passes per MP of ``mp``."""
    secs = stage_seconds(run)
    if secs is None or not mp:
        return None
    return 1e3 * secs.get(STAGES[stage], 0.0) / mp


def idle_gaps(work, lo: float, hi: float) -> list:
    """The stretches of [lo, hi] with none of ``work`` running."""
    gaps, end = [], lo
    for a, b in sorted((a, b) for _, a, b in work):
        if a > end:
            gaps.append((end, min(a, hi)))
        end = max(end, b)
        if end >= hi:
            break
    if end < hi:
        gaps.append((end, hi))
    return [(a, b) for a, b in gaps if b > a]


def _covered(gap, intervals) -> float:
    """Seconds of ``gap`` inside the sorted, disjoint ``intervals``."""
    a, b = gap
    return sum(max(0.0, min(b, e) - max(a, s)) for s, e in intervals
               if e > a and s < b)


def idle_unattributed_share(run):
    """% of the window's idle seconds (no device work running) under no
    program span, or None when the window has no program span or no
    idle time."""
    evs = spans(run)
    if run.trace is None or not evs:
        return None
    lo, hi = run.trace_window
    gaps = idle_gaps(run.work, lo, hi)
    idle = sum(b - a for a, b in gaps)
    if idle <= 0:
        return None
    merged, end = [], None
    for a, b in sorted((e["ts"] / 1e6, (e["ts"] + e["dur"]) / 1e6)
                       for e in evs):
        if merged and a <= end:
            end = max(end, b)
            merged[-1] = (merged[-1][0], end)
        else:
            merged.append((a, b))
            end = b
    covered = sum(_covered(g, merged) for g in gaps)
    return 100 * (idle - covered) / idle


def count_share(run, part: str, whole) -> float | None:
    """100 * count ``part`` over the sum of the counts ``whole`` (a name
    or a tuple of names), or None when the window counted none of
    ``whole``."""
    c = counts(run)
    names = (whole,) if isinstance(whole, str) else whole
    base = sum(c.get(n, 0) for n in names)
    if not base:
        return None
    return 100 * c.get(part, 0) / base
