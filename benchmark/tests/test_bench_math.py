"""The benchmark's arithmetic: interval union, percentiles over all
requests, rates over the window, the trace's busy time and the bounds."""

import math

import pytest

from benchmark import roofline, tracemath


@pytest.mark.parametrize("intervals, want", [
    ([], 0.0),
    ([(0, 1)], 1.0),
    ([(0, 1), (2, 3)], 2.0),
    ([(0, 2), (1, 3)], 3.0),
    ([(1, 3), (0, 2), (0.5, 0.7)], 3.0),
    ([(0, 10), (2, 3), (4, 5)], 10.0),
])
def test_union(intervals, want):
    assert tracemath.union(intervals) == pytest.approx(want)


def test_clipped():
    assert tracemath.clipped([(0, 2), (3, 5), (6, 7)], 1, 4) == \
        [(1, 2), (3, 4)]


def test_percentile_is_over_all_requests():
    v = list(range(1, 101))                  # 1..100
    assert tracemath.percentile(v, 95) == 95
    assert tracemath.percentile(v, 100) == 100
    assert tracemath.percentile([5.0], 95) == 5.0
    # one slow request in twenty sets the p95 of twenty, not of chunks
    walls = [10.0] * 19 + [500.0]
    assert tracemath.percentile(walls, 95) == 10.0
    assert tracemath.percentile(walls + [500.0], 95) == 500.0
    with pytest.raises(ValueError):
        tracemath.percentile([], 95)


def test_rate_is_all_work_over_the_window():
    assert tracemath.rate(60.0, 2.0) == 30.0
    with pytest.raises(ValueError):
        tracemath.rate(1.0, 0.0)


def _trace():
    # two API calls in the window launch a kernel each; one launched
    # outside it does not count
    ev = [{"cat": "user_annotation", "name": "bench:window", "ts": 0,
           "dur": 100},
          {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 10,
           "dur": 1, "args": {"correlation": 1}},
          {"cat": "cuda_runtime", "name": "cudaGraphLaunch", "ts": 20,
           "dur": 1, "args": {"correlation": 2}},
          {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 150,
           "dur": 1, "args": {"correlation": 3}},
          {"cat": "kernel", "name": "slim_encode_kernel", "ts": 30,
           "dur": 20, "args": {"correlation": 1}},
          {"cat": "kernel", "name": "other", "ts": 40, "dur": 20,
           "args": {"correlation": 2}},
          {"cat": "kernel", "name": "late", "ts": 160, "dur": 5,
           "args": {"correlation": 3}}]
    return tracemath.Trace(ev)


def test_trace_busy_and_idle():
    tr = _trace()
    (win,) = tr.spans("bench:window")
    assert win == pytest.approx((0.0, 100e-6))
    work = tr.launched(*win)
    assert sorted(n for n, _, _ in work) == ["other", "slim_encode_kernel"]
    assert tr.busy(work, *win) == pytest.approx(30e-6)
    assert tracemath.kernel_seconds(work, ("slim_encode",)) == \
        pytest.approx(20e-6)
    assert tracemath.top_ops(work)[0][0] in ("other", "slim_encode_kernel")
    gaps = tracemath.idle_gaps(work, *win, {"plan": [(60e-6, 100e-6)]})
    assert gaps[0][0] == "plan" and gaps[0][1] == pytest.approx(40e-6)


def test_bounds():
    # bytes-bound and operations-bound cases
    assert roofline.bound_seconds(3.35e12, 0) == pytest.approx(1.0)
    assert roofline.bound_seconds(0, roofline.INT32_OPS_PER_S) == \
        pytest.approx(1.0)
    assert roofline.k1_bound(10, 0) == pytest.approx(
        160 / roofline.HBM_BYTES_PER_S)
    s, p = roofline.inverse_dwt_work(8, 8, 1)
    assert (s, p) == (128, 64)
    s, p = roofline.inverse_dwt_work(5, 3, 2)
    # stage at full size 5x3 then 3x2
    assert s == 2 * (15 + 6)
    assert p == (3 * 2 + 5 * 1) + (2 * 1 + 3 * 1)
    assert math.isfinite(roofline.w1_bound(s, p))
