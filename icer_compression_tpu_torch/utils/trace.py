"""Spans, counts and stage marks inside the codec, and their accounting
in a ``torch.profiler`` trace.

Recording.  ``span(name)`` (a context manager) and ``count(name, n)``
record only while a ``torch.profiler`` session records, read from
``torch.autograd.profiler._is_profiler_enabled`` (one attribute read).
Otherwise a call returns at once: no allocation, no ``record_function``,
no clock read.  While the profiler records, a span is a
``record_function`` range ``icer.<name>``, on the trace's clock with the
device records, so an idle stretch of the card can be put down to the
innermost program span around it; a count is a zero-length range
``count:<name>=<n>`` (the chrome export keeps a range's name, not its
argument).  The spans sit at layer boundaries only, never inside a loop
over images, planes or lanes.

Stage marks.  ``mark(stage, t)`` launches ``icer_mark<stage>``
(``csrc/stage_mark.cu``), a one-thread kernel that adds one to the
stage's slot of the device's ``mark_counts``, on the current stream of
``t``'s CUDA device; on the CPU it does nothing.  A mark is launched
whether or not the profiler records, so a captured pass (captured with
the profiler off) holds its marks and a replay, which runs no host code,
still shows its stages: in a trace each device record of a pass, eager
or replayed, belongs to the stage that the last mark before it (by start
time, across the pass's streams) opened, and ``END``, the pass's last
mark, closes the pass, so the copies and uploads between passes belong
to none.  ``STAGES`` names them: the encode's device pass
(``ops/encode.TorchGrayscaleEncoder.device_pass``) marks the transform
and forward DWT, the context model, each bucket's coder input, its coder
kernel (K1; K4 with ``entropy="pallas"``) and its sort and pack; the
decode's (``models/decode.DecodePlan.device_pass``) kernel 2, marked on
the capturing stream before the fork of its unit streams, and the
finalize with the inverse DWT, marked after their join.

Accounting.  ``layer_breakdown`` reads an exported chrome trace: each
device record launched inside a host range goes to its replay's stage,
or else to the innermost program span around the call that launched it,
with each span's host time outside the spans nested in it and the sum
of each count.  ``chip_smoke.py``, ``bench.py`` and
``scripts/decode_after_encode.py`` trace the replayed path with it.
"""

from __future__ import annotations

import collections
import functools
import re

import torch
from torch.autograd import profiler as _profiler
from torch.profiler import record_function

PREFIX = "icer."
COUNT_PREFIX = "count:"

# the stages of a device pass, by mark id (csrc/stage_mark.cu kStages)
STAGES = ("transform and forward DWT", "context model", "coder input",
          "coder kernel", "sort and pack", "K2", "finalize", "end")
(TRANSFORM, CONTEXT_MODEL, CODER_INPUT, CODER_KERNEL, SORT_PACK, K2,
 FINALIZE, END) = range(len(STAGES))
MARK_KERNEL = re.compile(r"icer_mark<(\d+)>")


class _Off:
    """The span of a call made while the profiler does not record."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, typ, value, tb):
        return False


OFF = _Off()


def span(name: str):
    """A context manager: the range ``icer.<name>`` while the profiler
    records, else ``OFF``."""
    if not _profiler._is_profiler_enabled:
        return OFF
    return record_function(PREFIX + name)


def count(name: str, n: int = 1) -> None:
    """Record ``n`` of ``name`` (a zero-length range ``count:<name>=<n>``)
    while the profiler records."""
    if not _profiler._is_profiler_enabled:
        return
    with record_function(f"{COUNT_PREFIX}{name}={int(n)}"):
        pass


# ---- stage marks ----------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _mark_counts(device: str) -> torch.Tensor:
    return torch.zeros(len(STAGES), dtype=torch.int64, device=device)


def mark_counts(device) -> torch.Tensor:
    """The marks run on ``device`` per stage, int64, made at its first
    mark (an eager one: a pass is captured only after it ran eagerly) and
    kept for the process."""
    from .. import kernels
    return _mark_counts(kernels._device(device))


def mark_into(stage: int, counts: torch.Tensor) -> None:
    """Add one to ``counts[stage]``: ``icer_mark<stage>`` on a CUDA
    tensor, queued on its device's current stream; the plain version on
    a CPU tensor (the first-use check's)."""
    if not 0 <= stage < len(STAGES):
        raise ValueError(f"no stage {stage}")
    if counts.device.type == "cpu":
        counts[stage] += 1
        return
    import ctypes

    from .. import kernels
    fn = kernels.load("stage_mark").stage_mark_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    with torch.cuda.device(counts.device):
        cs = torch.cuda.current_stream(counts.device).cuda_stream
        kernels.check(fn(stage, counts.data_ptr(), cs), "stage_mark")


def mark(stage: int, t: torch.Tensor) -> None:
    """Mark the start of ``stage`` on the current stream of ``t``'s CUDA
    device (nothing for a CPU tensor)."""
    if t.device.type == "cuda":
        mark_into(stage, mark_counts(t.device))


# ---- accounting -------------------------------------------------------------

def _self_times(spans) -> dict:
    """Host µs of each range of ``spans`` (chrome events) outside the
    ranges of ``spans`` nested in it, by id."""
    own = {id(s): s["dur"] for s in spans}
    stack: list = []
    for s in sorted(spans, key=lambda s: (s.get("tid"), s["ts"], -s["dur"])):
        while stack and (stack[-1].get("tid") != s.get("tid")
                         or s["ts"] >= stack[-1]["ts"] + stack[-1]["dur"]):
            stack.pop()
        if stack:
            own[id(stack[-1])] -= s["dur"]
        stack.append(s)
    return own


def count_sums(events, lo: float = float("-inf"),
               hi: float = float("inf")) -> dict:
    """{name: sum} of the count ranges of ``events`` in [lo, hi] (µs)."""
    out: dict = collections.Counter()
    for e in events:
        name = e.get("name", "")
        if e.get("cat") == "user_annotation" \
                and name.startswith(COUNT_PREFIX) and lo <= e["ts"] <= hi:
            key, _, n = name[len(COUNT_PREFIX):].rpartition("=")
            out[key] += int(n)
    return dict(out)


def pass_stages(work) -> dict:
    """{device record id: stage name} for the device records ``work``
    (chrome events) that lie inside a pass: by start time, each record
    belongs to the stage of the last mark before it, the ``END`` mark to
    the stage "end"; records outside a pass (before its first mark, after
    its end) are left out."""
    out = {}
    stage = None
    for e in sorted(work, key=lambda e: e["ts"]):
        m = MARK_KERNEL.search(e.get("name", ""))
        if m:
            stage = STAGES[int(m.group(1))]
        if stage is not None:
            out[id(e)] = stage
        if stage == STAGES[END]:
            stage = None
    return out


def layer_breakdown(events, window: str) -> dict:
    """The device work launched inside the host range ``window`` of a
    chrome trace's events, grouped by layer: a device pass's records by
    the stage of the mark before each (``pass_stages``), every other
    record by the innermost program span (``icer.<name>``) around the
    call that launched it ("other" outside any).  Per layer the device
    ms, the records and, for a span, the host ms outside the spans nested
    in it; the window's wall, the device's busy ms (the union of its
    intervals) and idle share, the API calls that launched the work (one
    per graph replay), the kernels by name, the mean host time between
    launches, the counts recorded in the window (``count_sums``) and the
    replay records that no mark precedes (``unmarked``)."""
    (win,) = [e for e in events if e.get("cat") == "user_annotation"
              and e.get("name") == window]
    t0, t1 = win["ts"], win["ts"] + win["dur"]
    spans = [e for e in events if e.get("cat") == "user_annotation"
             and e.get("name", "").startswith(PREFIX)
             and t0 <= e["ts"] <= t1]
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and t0 <= e["ts"] <= t1
                and "correlation" in e.get("args", {})}
    work = [e for e in events
            if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
            and e.get("args", {}).get("correlation") in launches]
    if not work:
        raise AssertionError(f"the trace of {window} holds no device work")
    stages = pass_stages(work)

    def layer_of(ts):
        inner = [s for s in spans if s["ts"] <= ts <= s["ts"] + s["dur"]]
        return min(inner, key=lambda s: s["dur"])["name"][len(PREFIX):] \
            if inner else "other"

    def group(name):
        return groups.setdefault(name, {"device_ms": 0.0, "launches": 0,
                                        "host_ms": 0.0})

    groups: dict = {}
    unmarked = 0
    for e in work:
        run = launches[e["args"]["correlation"]]
        name = stages.get(id(e))
        if name is None:
            unmarked += "GraphLaunch" in run.get("name", "")
            name = layer_of(run["ts"])
        g = group(name)
        g["device_ms"] += e["dur"] / 1e3
        g["launches"] += 1
    own = _self_times(spans)
    for s in spans:
        group(s["name"][len(PREFIX):])["host_ms"] += own[id(s)] / 1e3
    busy, end = 0.0, -1.0
    for a, b in sorted((e["ts"], e["ts"] + e["dur"]) for e in work):
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    span_us = max(t1, end) - t0
    ts = sorted(launches[e["args"]["correlation"]]["ts"] for e in work)
    return {"wall_ms": span_us / 1e3, "busy_ms": busy / 1e3,
            "idle_share": 1 - busy / span_us, "launches": len(work),
            "api_launches": len({e["args"]["correlation"] for e in work}),
            "kernels": dict(collections.Counter(
                e["name"] for e in work if e["cat"] == "kernel")),
            "host_gap_us": (ts[-1] - ts[0]) / max(1, len(ts) - 1),
            "layers": groups, "counts": count_sums(events, t0, t1),
            "unmarked": unmarked}
