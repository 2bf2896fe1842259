"""The arithmetic that the metric readers (``metrics/<name>.py``) share.

Each reader module defines ``read(run)``: the metric's value from what a
run recorded (``load.Run``), or None when the run has nothing to read, in
which case the harness leaves the metric out of the result line.
"""

from __future__ import annotations

import numpy as np

from . import check
from .load import DECODE, ENCODE
from .reference import codec as R
from .roofline import K1_NAMES, K2_NAMES, W1_NAMES, inverse_dwt_work
from .roofline import k1_bound, k2_bound, w1_bound
from .tracemath import kernel_seconds, percentile, rate


def mp_rate(run, kind: str):
    """Megapixels of ``kind`` requests answered in the window, over the
    window's seconds (host clock)."""
    mp = run.frame_mp(kind)
    return rate(mp, run.window[1] - run.window[0]) if mp else None


def p95_ms(run, kind: str):
    """Nearest-rank 95th percentile of the wall of every ``kind`` request
    of the window, ms (host clock)."""
    walls = [1e3 * (b - a) for k, a, b, _ in run.requests if k == kind]
    return percentile(walls, 95) if walls else None


def span_ms_per_mp(run, span: str, kind: str):
    """Host ms inside the harness's ``span`` per MP of ``kind`` requests."""
    spans = run.spans.host.get(span, [])
    mp = run.frame_mp(kind)
    if not spans or not mp:
        return None
    return 1e3 * sum(b - a for a, b in spans) / mp


def span_ms_per_request(run, span: str, kind: str):
    """Mean host ms inside the harness's ``span`` per ``kind`` request."""
    spans = run.spans.host.get(span, [])
    n = sum(1 for r in run.requests if r[0] == kind)
    if not spans or not n:
        return None
    return 1e3 * sum(b - a for a, b in spans) / n


def peak_device_gb(run):
    """The allocator's peak over the window plus the graph pools' bytes,
    GB."""
    c = run.counters
    if "peak_allocated_window" not in c:
        return None
    return (c["peak_allocated_window"] + c["graph_reserved_bytes"]) / 1e9


def idle_share(run):
    """% of the traced window with none of its device work running."""
    if run.trace is None:
        return None
    lo, hi = run.trace_window
    return 100 * (1 - run.trace.busy(run.work, lo, hi) / (hi - lo))


def idle_share_of(run, span: str):
    """% of the union of the harness's ``span`` intervals (requests, which
    do not overlap) with none of the window's device work running."""
    if run.trace is None:
        return None
    reqs = run.trace.spans(f"bench:{span}")
    total = sum(b - a for a, b in reqs)
    if total <= 0:
        return None
    busy = sum(run.trace.busy(run.work, a, b) for a, b in reqs)
    return 100 * (1 - busy / total)


def k1_roofline_share(run):
    """K1's bound for the frames encoded in the traced window (every plane
    coded) over its records' device time, %."""
    if run.trace is None or not run.encoded_frames:
        return None
    t = kernel_seconds(run.work, K1_NAMES)
    if t <= 0:
        return None
    codec = check.reference_codec(run.config)
    bp = codec.bitplanes
    nnz = {}
    for k in set(run.encoded_frames):
        coeffs, _ = R.transform(run.pool[k], codec)
        mag = coeffs & ((1 << codec.mag_bits) - 1)
        nnz[k] = int(np.count_nonzero((mag != 0) & (mag < (1 << bp))))
    npx = run.config["width"] * run.config["height"]
    return 100 * sum(k1_bound(bp * npx, bp * npx + nnz[k])
                     for k in run.encoded_frames) / t


def k2_roofline_share(run):
    """K2's bound for the streams decoded in the traced window over its
    records' device time, %."""
    if run.trace is None or not run.decoded_frames:
        return None
    t = kernel_seconds(run.work, K2_NAMES)
    if t <= 0:
        return None
    codec = check.reference_codec(run.config)
    npx = run.config["width"] * run.config["height"]
    work = {k: check.stream_work(run.streams[k], codec)
            for k in set(run.decoded_frames)}
    return 100 * sum(k2_bound(work[k][0], work[k][1], npx)
                     for k in run.decoded_frames) / t


def w1_roofline_share(run):
    """W1's bound for the inverse DWTs of the traced window over its
    records' device time, %."""
    if run.trace is None or not run.decoded_frames:
        return None
    t = kernel_seconds(run.work, W1_NAMES)
    if t <= 0:
        return None
    c = run.config
    samples, pairs = inverse_dwt_work(c["width"], c["height"], c["stages"])
    return 100 * len(run.decoded_frames) * w1_bound(samples, pairs) / t

