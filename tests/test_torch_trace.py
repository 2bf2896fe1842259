"""The port's own spans, counts and stage marks (``utils/trace``) and the
benchmark's readers of them (``benchmark/program_trace``).

On the CPU the codec runs under ``torch.profiler`` with CPU activity: the
spans of an encode batch and its collector, of ``compress_batch`` with
its widening steps and of ``decompress_batch`` are there and nested as the
modules say, the counts carry the amounts of work the calls did (lanes
coded, host re-encodes, decode passes, graph replays),
and with the profiler off the recorder allocates nothing, calls no
``record_function`` and the streams and pixels are the same bytes.  The
readers are held to a synthetic chrome trace.  The marks' kernel runs
only on a card: one test captures it in a CUDA graph and finds it in the
trace of the replay (skipped without a card)."""

import itertools
import json
import tracemalloc
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import program_trace as PT
from benchmark.tracemath import Trace
from icer_compression_tpu_torch import kernel_check
from icer_compression_tpu_torch.backend import graph_cache as GC
from icer_compression_tpu_torch.models import decode as D
from icer_compression_tpu_torch.models import grayscale as T
from icer_compression_tpu_torch.ops import entropy_slim as ES
from icer_compression_tpu_torch.utils import trace


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    """Skips unless a CUDA device is present (decided here, not at
    import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the stage mark is a CUDA kernel")


def image(h=40, w=48, seed=0, top=256):
    rng = np.random.default_rng(seed)
    base = np.add.outer(np.arange(h) * 3, np.arange(w)) % (top // 2)
    return (base + rng.integers(0, top // 2, (h, w))).astype(np.uint16)


def profiled(fn, tmp_path):
    """(fn(), the chrome trace's events) with the CPU profiled."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return out, json.loads(path.read_text())["traceEvents"]


def spans(events, name):
    """(start, end) in µs of every ``icer.<name>`` range, in order."""
    return sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                  if e.get("cat") == "user_annotation"
                  and e.get("name") == trace.PREFIX + name)


def inside(inner, outer):
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def test_recorder_off_records_and_allocates_nothing(monkeypatch):
    """With the profiler off a span is the shared ``OFF`` and a count
    returns at once: neither allocates, and neither reaches
    ``record_function``."""
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with the "
                             "profiler off")
    monkeypatch.setattr(trace, "record_function", refuse)
    assert not torch.autograd.profiler._is_profiler_enabled
    assert trace.span("encode.collect") is trace.OFF
    with trace.span("encode.collect"):
        trace.count("encode.lanes", 56)

    def calls():
        trace.span("encode.collect")
        trace.count("encode.lanes", 56)

    it = itertools.repeat(None, 10_000)
    calls()
    tracemalloc.start()
    try:
        before, _ = tracemalloc.get_traced_memory()
        tracemalloc.reset_peak()
        for _ in it:
            calls()
        after, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert after == before and peak == before


def test_profiler_off_gives_the_same_bytes_and_records_nothing(
        monkeypatch, tmp_path):
    """An encode batch, ``compress_batch`` and a decode give the same
    streams and pixels with the profiler on and off; off, no range is
    opened at all."""
    imgs = np.stack([image(seed=s) for s in (1, 2)])
    cfg = T.CodecConfig(4, 0, 6, 1200)
    enc = T.make_encoder(48, 40, cfg, np.uint16, device="cpu")

    def run():
        hold = enc.encode_batch(imgs, defer=True)
        streams = T.allocate_streams(hold(), cfg, enc)
        streams += T.compress_batch(imgs, cfg, device="cpu")
        px = D.decompress_batch(streams, cfg, dtype=np.uint16,
                                device="cpu", pack8=True)
        return streams, px

    (s_on, px_on), events = profiled(run, tmp_path)
    assert spans(events, "encode.collect")

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with the "
                             "profiler off")
    monkeypatch.setattr(trace, "record_function", refuse)
    s_off, px_off = run()
    assert s_off == s_on
    assert all(a.dtype == b.dtype and np.array_equal(a, b)
               for a, b in zip(px_off, px_on))


def test_encode_batch_spans_and_lanes(tmp_path):
    """``encode_batch(defer=True)`` and its collector: the dispatch half's
    span, then the wait and the collect; ``encode.lanes`` is the number
    of lane tables the batch returned."""
    imgs = np.stack([image(seed=s) for s in (3, 4, 5)])
    cfg = T.CodecConfig(4, 0, 6, None)
    enc = T.make_encoder(48, 40, cfg, np.uint16, device="cpu")

    def run():
        hold = enc.encode_batch(imgs, defer=True)
        return hold()

    out, events = profiled(run, tmp_path)
    (dispatch,) = spans(events, "encode.dispatch")
    (wait,) = spans(events, "encode.wait")
    (collect,) = spans(events, "encode.collect")
    assert dispatch[1] <= wait[0] <= wait[1] <= collect[0]
    assert not spans(events, "encode.capture")     # no graph on the CPU
    counts = trace.count_sums(events)
    assert counts["encode.lanes"] == sum(len(t) for t, _m in out) \
        == 3 * enc.lanes_per_image
    assert "encode.host_reencode_lanes" not in counts


def test_flagged_lanes_count_their_host_reencode(monkeypatch, tmp_path):
    """Lanes the coder flags (the hook of the codec's flagged-lane test)
    re-encode on the host inside ``encode.collect`` and are counted as
    ``encode.fallback_lanes`` counts them."""
    real = ES.encode_lanes_slim

    def flag_every_third(words):
        rec, fstate, misc, ev = real(words)
        misc = misc.clone()
        misc[0, ::3] = 1
        return rec, fstate, misc, ev

    monkeypatch.setattr(ES, "encode_lanes_slim", flag_every_third)
    cfg = T.CodecConfig(2, 0, 6, None)
    enc = T.make_encoder(40, 48, cfg, np.uint16, "cpu")
    img = image(48, 40, seed=6)
    want = T.compress_batch(img[None], cfg, encoder=enc)
    before = enc.fallback_lanes
    got, events = profiled(
        lambda: T.compress_batch(img[None], cfg, encoder=enc), tmp_path)
    assert got == want
    counts = trace.count_sums(events)
    assert counts["encode.host_reencode_lanes"] \
        == enc.fallback_lanes - before > 0
    (collect,) = spans(events, "encode.collect")
    (redo,) = spans(events, "encode.host_reencode")
    assert inside(redo, collect)


def test_compress_batch_counts_each_widening_step(tmp_path):
    """A near-constant image whose quota class widens: one request, one
    ``compress.widen`` span per step, each holding its encode and its
    allocation."""
    rng = np.random.default_rng(3)
    img = (100 + (rng.random((64, 64)) < 0.01)).astype(np.uint8)
    cfg = T.CodecConfig(1, 0, 1, 816)
    stats = {}
    _out, events = profiled(
        lambda: T.compress_batch(img[None], cfg, device="cpu",
                                 stats=stats), tmp_path)
    counts = trace.count_sums(events)
    assert stats["escalations"] > 0
    assert counts["compress.requests"] == 1
    assert counts["compress.widenings"] == stats["escalations"]
    widen = spans(events, "compress.widen")
    assert len(widen) == stats["escalations"]
    allocs = spans(events, "alloc.streams")
    assert len(allocs) == 1 + stats["escalations"]
    for w in widen:
        assert sum(inside(a, w) for a in allocs) == 1
        assert any(inside(d, w) for d in spans(events, "encode.dispatch"))


@pytest.mark.parametrize("top,wide", [(256, 0), (1024, 1)])
def test_decode_spans_and_pack8_fallback(top, wide, tmp_path):
    """``decompress_batch(pack8=True)``: the plan, the dispatch, the wait
    and the unpack in that order, one pass counted; a uint16 decode with
    a pixel above 255 takes no other path (no fallback span or count)."""
    imgs = [image(seed=s, top=top) for s in (7, 8)]
    cfg = T.CodecConfig(4, 0, 6, None)
    streams = T.compress_batch(np.stack(imgs), cfg, device="cpu")
    want = D.decompress_batch(streams, cfg, dtype=np.uint16, device="cpu")
    assert (max(int(p.max()) for p in want) > 255) == bool(wide)
    px, events = profiled(
        lambda: D.decompress_batch(streams, cfg, dtype=np.uint16,
                                   device="cpu", pack8=True), tmp_path)
    assert all(np.array_equal(p, w) for p, w in zip(px, want))
    (plan,) = spans(events, "decode.plan")
    (dispatch,) = spans(events, "decode.dispatch")
    (wait,) = spans(events, "decode.wait")
    (unpack,) = spans(events, "decode.unpack")
    assert plan[1] <= dispatch[0] <= dispatch[1] <= wait[0] <= wait[1] \
        <= unpack[0]
    counts = trace.count_sums(events)
    assert counts["decode.passes"] == 1
    assert "decode.pack8_fallbacks" not in counts
    assert "decode.wide_copy_bytes" not in counts
    assert not spans(events, "decode.pack8_fallback")


class StandIn:
    """A graph's stand-in: each replay runs ``fn`` again into the capture's
    outputs."""

    def __init__(self, fn, static_x):
        self.fn, self.static_x = fn, static_x
        self.outs = tuple(fn(static_x))

    def replay(self):
        for o, t in zip(self.outs, self.fn(self.static_x)):
            o.copy_(t)


def test_graph_cache_counts_by_kind(tmp_path):
    """Three passes of an encode key and of a decode key: two eager, a
    capture (whose check replays once) and a replay each; a budget that
    holds one graph evicts the older on the second capture."""
    def capture(fn, static_x):
        g = StandIn(fn, static_x)
        return g, g.outs

    cache = GC.GraphCache(capture=capture, pool=lambda g, dev: 1 << 20,
                          counters=lambda: [], budget=(1 << 20) + 64)
    x = torch.arange(4)

    def passes():
        for key in ((48, 40, 4), ("decode", 48, 40)):
            for _ in range(3):
                outs, state = cache.run(key, lambda t: (t + 1,), x)
                if state == "capture":
                    cache.capture(key, lambda t: (t + 1,), x, outs)

    _none, events = profiled(passes, tmp_path)
    counts = trace.count_sums(events)
    for kind in ("encode", "decode"):
        assert counts[f"graph.eager.{kind}"] == 2
        assert counts[f"graph.capture.{kind}"] == 1
        assert counts[f"graph.replay.{kind}"] == 2
    assert counts["graph.evict"] == cache.evictions == 1
    assert sum(v for k, v in counts.items() if k.startswith("graph.replay")) \
        == cache.replays


def test_stage_marks_plain_version_and_cpu_no_op():
    """The first-use check's instance for the marks runs stage S S + 1
    times; on the CPU ``mark`` launches nothing and makes no counts."""
    assert kernel_check.check_library("stage_mark", device="cpu") \
        == ("stage marks",)
    (counts,) = kernel_check._marks(torch.device("cpu"))
    assert counts.tolist() == list(range(1, len(trace.STAGES) + 1))
    made = trace._mark_counts.cache_info().currsize
    trace.mark(trace.CONTEXT_MODEL, torch.zeros(1))
    assert trace._mark_counts.cache_info().currsize == made
    with pytest.raises(ValueError):
        trace.mark_into(len(trace.STAGES), torch.zeros(8, dtype=torch.int64))
    assert PT.STAGES == {
        "transform": trace.TRANSFORM, "context_model": trace.CONTEXT_MODEL,
        "coder_input": trace.CODER_INPUT, "coder_kernel": trace.CODER_KERNEL,
        "sort_pack": trace.SORT_PACK, "k2": trace.K2,
        "finalize": trace.FINALIZE, "end": trace.END}


def _ev(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": 1, "args": args}


def _synthetic_run():
    """A traced window of 0-1000 µs: spans, counts, one replay with two
    stage marks and a copy outside it."""
    ev = [
        _ev("user_annotation", "bench:window", 0, 1000),
        _ev("user_annotation", "icer.encode.dispatch", 0, 100),
        _ev("user_annotation", "icer.encode.collect", 300, 300),
        _ev("user_annotation", "icer.encode.host_reencode", 400, 100),
        _ev("user_annotation", "count:encode.lanes=56", 350, 0),
        _ev("user_annotation", "count:encode.host_reencode_lanes=7", 450, 0),
        _ev("user_annotation", "count:encode.lanes=56", 2000, 0),
        _ev("cuda_runtime", "cudaGraphLaunch", 50, 10, correlation=1),
        _ev("cuda_runtime", "cudaMemcpyAsync", 90, 5, correlation=2),
        _ev("kernel", "void icer_mark<1>(unsigned long long*)", 100, 2,
            correlation=1),
        _ev("kernel", "elementwise", 102, 98, correlation=1),
        _ev("kernel", "void icer_mark<4>(unsigned long long*)", 210, 2,
            correlation=1),
        _ev("kernel", "radix sort", 212, 58, correlation=1),
        _ev("gpu_memcpy", "pack copy", 250, 48, correlation=1),
        _ev("kernel", "void icer_mark<7>(unsigned long long*)", 298, 2,
            correlation=1),
        _ev("gpu_memcpy", "Memcpy DtoH", 300, 20, correlation=2),
    ]
    t = Trace(ev)
    lo, hi = 0.0, 1000e-6
    return SimpleNamespace(trace=t, trace_window=(lo, hi),
                           work=t.launched(lo, hi)), ev


def test_program_trace_readers_on_a_synthetic_trace():
    """Stage seconds by mark (the copy after the end mark in none), count
    sums, self times and the idle time left outside the program's
    spans."""
    run, ev = _synthetic_run()
    assert PT.counts(run) == {"encode.lanes": 56,
                              "encode.host_reencode_lanes": 7}
    assert trace.count_sums(ev, 0, 1000) == PT.counts(run)
    secs = PT.stage_seconds(run)
    assert secs == {1: pytest.approx(100e-6), 4: pytest.approx(88e-6)}
    (recs,) = PT.replays(run)
    by, outside = PT.stage_split(recs)
    assert not outside and sum(len(v) for v in by.values()) == 5
    assert PT.stage_split(sorted(run.work, key=lambda r: r[1]))[1] \
        == [(300e-6, 320e-6)]
    assert PT.stage_ms_per_mp(run, "sort_pack", 2.0) \
        == pytest.approx(1e3 * 88e-6 / 2)
    assert PT.self_seconds(run, "encode.collect") == pytest.approx(200e-6)
    assert PT.self_seconds(run, "encode.host_reencode") \
        == pytest.approx(100e-6)
    assert PT.self_seconds(run, "decode.plan") is None
    # idle: 0-100, 200-210, 320-1000 (790 µs); spans cover 0-100 and
    # 320-600 of it
    assert PT.idle_unattributed_share(run) \
        == pytest.approx(100 * (790 - 380) / 790)
    assert PT.count_share(run, "encode.host_reencode_lanes",
                          "encode.lanes") == pytest.approx(100 * 7 / 56)
    assert PT.count_share(run, "decode.pack8_fallbacks",
                          "decode.passes") is None


def test_program_trace_readers_find_nothing_in_an_older_program():
    """A window without the program's spans, counts and marks (the parent
    of this recorder): every reader gives None and raises nothing."""
    run, _ev_ = _synthetic_run()
    keep = [e for e in run.trace.events
            if not e["name"].startswith(("icer", "count:", "void icer"))]
    t = Trace(keep)
    old = SimpleNamespace(trace=t, trace_window=run.trace_window,
                          work=t.launched(*run.trace_window))
    assert PT.counts(old) == {} and PT.stage_seconds(old) is None
    assert PT.idle_unattributed_share(old) is None
    assert PT.self_seconds(old, "encode.collect") is None
    assert PT.stage_ms_per_mp(old, "finalize", 1.0) is None
    none = SimpleNamespace(trace=None, trace_window=(0, 1), work=[])
    assert PT.counts(none) == {} and PT.stage_seconds(none) is None


def test_stage_mark_kernel_in_a_captured_graph_shows_in_its_replay(
        card, tmp_path):
    """On the card: marks captured in a CUDA graph run at each replay
    (their counts rise) and appear in the replay's trace under the graph
    launch, so that every record after the first mark has its stage."""
    dev = torch.device("cuda")
    x = torch.zeros(1 << 16, device=dev)

    def fn(x):
        trace.mark(trace.CONTEXT_MODEL, x)
        y = x + 1
        trace.mark(trace.SORT_PACK, x)
        out = torch.sort(y * 2).values
        trace.mark(trace.END, x)
        return (out,)

    fn(x)                                   # builds the marks, eagerly
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = fn(x)
    torch.cuda.synchronize()
    before = trace.mark_counts(dev).clone()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        graph.replay()
        torch.cuda.synchronize()
    after = trace.mark_counts(dev).cpu()
    want = torch.zeros(len(trace.STAGES), dtype=torch.int64)
    want[[trace.CONTEXT_MODEL, trace.SORT_PACK, trace.END]] = 1
    assert torch.equal(after - before.cpu(), want)
    assert bool((outs[0] == 2).all())
    path = tmp_path / "trace.json"
    p.export_chrome_trace(str(path))
    t = Trace(json.loads(path.read_text())["traceEvents"])
    (recs,) = PT.replays(SimpleNamespace(trace=t, trace_window=(0, 1e12)))
    by, outside = PT.stage_split(recs)
    assert not outside
    assert set(by) == {trace.CONTEXT_MODEL, trace.SORT_PACK}
    names = [n for n, _a, _b in recs]
    assert sum("icer_mark<" in n for n in names) == 3 < len(names)
