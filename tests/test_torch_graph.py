"""The encoder's captured passes (``backend/graph_cache``) on the CPU.

A CUDA graph cannot be captured here, so a stand-in does its part: its
"capture" runs the pass once to make the static outputs, and each replay
runs it again on the static input and writes into those same tensors, as
a replay overwrites a graph's outputs.  Through it the split device pass
(``TorchGrayscaleEncoder.device_pass`` and its host edges) is held to
the JAX package's ``models/grayscale.compress`` byte for byte, eagerly
and through replays; the cache's key, memory bound, capture by the
collector of a key's second pass, first-replay check, launch counters,
allocator setting and refusals are held to their contract."""

import os

import numpy as np
import pytest
import torch

from icer_compression_tpu.models import grayscale as G
from icer_compression_tpu_torch.backend import graph_cache as GC
from icer_compression_tpu_torch.models import grayscale as T
from icer_compression_tpu_torch.ops import encode as E
from icer_compression_tpu_torch.ops import entropy_full as EF
from icer_compression_tpu_torch.utils.image_io import read_png
from test_torch_entropy_slim import one_torch_thread  # noqa: F401
from test_torch_pass_plan import pad_counts

BOAT = os.path.join(os.path.dirname(__file__), "data", "boat.512.png")


def boat_crop(side, dy=0, dx=0):
    c = 256 - side // 2
    return np.ascontiguousarray(read_png(BOAT)[c + dy:c + dy + side,
                                               c + dx:c + dx + side]
                                ).astype(np.uint16)


class Counted:
    """A stand-in for a counted kernel wrapper, ``Wrappers.kernel``."""
    launches = 0


class Wrappers:
    kernel = Counted


COUNTERS = [(Wrappers, "kernel")]


class FakeGraph:
    """A CUDA graph's stand-in on the CPU: built from one run of ``fn``
    (the capture's allocations), each replay runs ``fn`` on the static
    input again and copies into the same output tensors.  A replay runs
    Python, so it puts back the counters ``fn`` moved; ``bad`` flips the
    first output word of every replay."""

    def __init__(self, fn, static_x, counters, bad):
        self.fn, self.static_x = fn, static_x
        self.counters, self.bad = counters, bad
        self.outs = tuple(t.clone() for t in fn(static_x))

    def replay(self):
        saved = [getattr(o, n).launches for o, n in self.counters]
        new = self.fn(self.static_x)
        for (o, n), v in zip(self.counters, saved):
            getattr(o, n).launches = v
        for o, t in zip(self.outs, new):
            o.copy_(t)
        if self.bad:
            flat = self.outs[0].view(-1)
            flat[0] = ~flat[0] if flat.dtype == torch.bool else flat[0] + 1


def fake_cache(counters=(), bad_captures=0, budget=1 << 40, pools=None,
               pool=None):
    """A GraphCache whose captures are ``FakeGraph``s, each pool the size
    of its outputs (or ``pools[key]`` for a graph of that key's outputs'
    first value, or ``pool(graph, device)``); the first ``bad_captures``
    give wrong replays."""
    left = [bad_captures]

    def capture(fn, static_x):
        g = FakeGraph(fn, static_x, list(counters), left[0] > 0)
        left[0] -= 1
        return g, g.outs

    def pool_of(g, dev):
        if pool is not None:
            return pool(g, dev)
        if pools is None:
            return GC._nbytes(g.outs)
        return pools[int(g.outs[0].view(-1)[0])]

    return GC.GraphCache(capture=capture, pool=pool_of,
                         counters=lambda: list(counters), budget=budget)


def run_pass(cache, key, fn, x, estimate=0):
    """One pass through ``cache`` as the encoder makes it: the dispatch
    half, then the capture its collector makes when the pass is marked."""
    outs, state = cache.run(key, fn, x)
    if state == "capture":
        cache.capture(key, fn, x, outs, estimate=estimate)
    return outs, state


@pytest.fixture
def replays(monkeypatch):
    """Every encoder made inside runs its passes through a fake-graph
    cache (no encoder cached before is reused); yields the cache.  The
    copies back to the host are real copies, as on the card (a CPU tensor
    would otherwise pass through as the static output itself)."""
    cache = fake_cache()
    monkeypatch.setattr(GC, "CACHE", cache)
    monkeypatch.setattr(T, "_ENCODERS", {})
    monkeypatch.setattr(E, "to_host", torch.clone)
    real = E.TorchGrayscaleEncoder.__init__

    def init(self, *a, graph=None, **k):
        real(self, *a, graph=False, **k)
        self.graph = True
    monkeypatch.setattr(E.TorchGrayscaleEncoder, "__init__", init)
    return cache


def _runs(mode, fn):
    """``fn()`` once eagerly, or three times through the fake graphs (the
    key's eager pass, its capture and check, a replay); every result."""
    return [fn() for _ in range(1 if mode == "eager" else 3)]


MODES = ["eager", "replays"]


def _mode(request, mode):
    if mode == "replays":
        return request.getfixturevalue("replays")
    return None


@pytest.mark.parametrize("mode", MODES)
def test_boat_crop_equals_jax_package(request, mode):
    cache = _mode(request, mode)
    img = boat_crop(64)
    cfg = T.CodecConfig(4, 0, 6, None)
    want = G.compress(img, G.CodecConfig(4, 0, 6, None))
    for got in _runs(mode, lambda: T.compress(img, cfg, device="cpu")):
        assert got == want
    if cache is not None:
        assert cache.replays == 2 and len(cache.keys()) == 1
        assert [c["equal"] for c in cache.captures] == [True]


def _three_in_passes_of_two(monkeypatch):
    """Three 48x48 boat crops, their JAX package streams, and an encoder
    whose passes hold at most 2 of them (``PASS_WORDS`` lowered in the
    test), the sizes of its passes recorded as they are dispatched."""
    imgs = np.stack([boat_crop(48, dy, dx)
                     for dy, dx in ((0, 0), (40, -30), (-60, 50))])
    cfg = T.CodecConfig(3, 1, 4, None)
    words = T.make_encoder(48, 48, cfg, np.uint16, "cpu").words_per_image
    monkeypatch.setattr(E, "PASS_WORDS", 2 * words)
    enc = T.make_encoder(48, 48, cfg, np.uint16, "cpu")
    assert enc.pass_images == 2
    want = [G.compress(im, G.CodecConfig(3, 1, 4, None)) for im in imgs]
    enc.passes = []
    real = enc._dispatch
    monkeypatch.setattr(enc, "_dispatch",
                        lambda x: enc.passes.append(len(x)) or real(x))
    return imgs, cfg, enc, want


@pytest.mark.parametrize("mode", MODES)
def test_remainder_pass_equals_jax_package(request, mode, monkeypatch):
    """A batch of 3 in passes of at most 2: two passes of 2, the second
    padded with one all-zero image, so one key and one graph."""
    cache = _mode(request, mode)
    imgs, cfg, enc, want = _three_in_passes_of_two(monkeypatch)
    pads = pad_counts(monkeypatch)
    runs = _runs(mode, lambda: T.compress_batch(imgs, cfg, encoder=enc))
    for got in runs:
        assert got == want
    assert enc.passes == [2, 2] * len(runs)
    assert pads == [1] * len(runs)
    if cache is not None:
        assert [k[6] for k in cache.keys()] == [2]
        # the capture's check, then both passes of the next two batches
        assert cache.replays == 1 + 2 * 2


def test_one_key_fits_a_bound_of_one_pass(replays, monkeypatch):
    """The fake bound holds the pool of one pass of 2 and no more (pools
    of 2^30 B an image): the batch of 3, encoded three times, evicts
    nothing and replays every pass after its capture (passes of 2 and 1
    would be two keys whose pools evict each other)."""
    unit = 1 << 30
    cache = fake_cache(budget=2 * unit,
                       pool=lambda g, dev: unit * len(g.static_x))
    monkeypatch.setattr(GC, "CACHE", cache)
    imgs, cfg, enc, want = _three_in_passes_of_two(monkeypatch)
    for _ in range(3):
        assert T.compress_batch(imgs, cfg, encoder=enc) == want
    assert enc.passes == [2, 2] * 3
    assert cache.evictions == 0 and len(cache.captures) == 1
    assert cache.pool_total("cpu") == 2 * unit <= cache.bound("cpu")
    assert cache.replays == 1 + 2 * 2


@pytest.mark.parametrize("mode", MODES)
def test_plane_windows_equal_jax_package(request, mode):
    """Quota 5,000 on a 192x192 crop admits a prefix class: the encoders
    of its plane windows, each its own key."""
    cache = _mode(request, mode)
    img = boat_crop(192)
    cfg = T.CodecConfig(4, 0, 6, 5000)
    want = G.compress(img, G.CodecConfig(4, 0, 6, 5000))
    stats = {}
    for got in _runs(mode, lambda: T.compress_batch(
            img[None], cfg, device="cpu", stats=stats)[0]):
        assert got == want
    assert stats["first_class"] < stats["classes"] - 1
    if cache is not None:
        windows = {k[8] for k in cache.keys()}
        assert len(windows) == len(cache.keys()) >= 1
        assert any(lo > 0 for w in windows for lo, _hi in w)


def _flag_every_third(monkeypatch):
    """Kernel 4's tail flags every third lane, so those re-encode on the
    host from the pass's words."""
    real = EF.order_and_pack_lanes

    def flagged(code, nbits, opn, max_bits):
        payload, total, flag = real(code, nbits, opn, max_bits)
        flag = flag.clone()
        flag[::3] = True
        return payload, total, flag
    monkeypatch.setattr(EF, "order_and_pack_lanes", flagged)


@pytest.mark.parametrize("mode", MODES)
def test_pallas_deferred_with_flagged_lanes_equals_jax_package(
        request, mode, monkeypatch):
    """Two different batches through ``pallas`` with both collectors open:
    the second replay overwrites the graph's words, so the first
    collector re-encodes its flagged lanes from its pass run again on its
    own input, not from the graph's outputs."""
    cache = _mode(request, mode)
    _flag_every_third(monkeypatch)
    a, b = boat_crop(64), boat_crop(64, 100, -120)
    cfg = T.CodecConfig(4, 0, 6, None)
    jcfg = G.CodecConfig(4, 0, 6, None)
    want = [G.compress(a, jcfg), G.compress(b, jcfg)]
    enc = T.make_encoder(64, 64, cfg, np.uint16, "cpu", entropy="pallas")
    if cache is not None:
        for im in (a, b):     # the key's eager pass, then its capture
            assert T.allocate_streams(enc.encode_batch(im[None]), cfg,
                                      enc) == [G.compress(im, jcfg)]
    lanes = enc.fallback_lanes
    first = enc.encode_batch(a[None], defer=True)
    second = enc.encode_batch(b[None], defer=True)
    got_b = T.allocate_streams(second(), cfg, enc)
    got_a = T.allocate_streams(first(), cfg, enc)
    assert [got_a[0], got_b[0]] == want
    assert enc.fallback_lanes > lanes
    if cache is not None:
        assert cache.replays == 3


def _encoders(**kw):
    base = dict(image_w=40, image_h=48, stages=2, filt=0, segments=6,
                mag_bits=15, device="cpu")
    base.update(kw)
    return E.TorchGrayscaleEncoder(**base)


def test_pass_keys_hold_every_field_that_fixes_a_pass():
    """Plane windows, pass sizes, coders, record modes, call sizes and lane
    shares each give their own key: no two such passes share a graph."""
    x1, x2 = torch.zeros(1, 48, 40), torch.zeros(2, 48, 40)
    base = _encoders()
    keys = {
        "base": base.pass_key(x1),
        "pass size": base.pass_key(x2),
        "windows": _encoders(plane_cuts=((3, 5), 7)).pass_key(x1),
        "other windows": _encoders(plane_cuts=((5, 7), 7)).pass_key(x1),
        "coder": _encoders(entropy="pallas").pass_key(x1),
        "sorted": _encoders(entropy="sorted").pass_key(x1),
        "lane share": _encoders(lane_share=(2, 0)).pass_key(x1),
        "other share": _encoders(lane_share=(2, 1)).pass_key(x1),
        "filter": _encoders(filt=1).pass_key(x1),
        "uint8": _encoders(mag_bits=7).pass_key(x1),
    }
    assert len(set(keys.values())) == len(keys)
    assert _encoders().pass_key(x1) == keys["base"]
    small = _encoders()
    for b in small.buckets:
        b["call_rows"] = 1
    assert small.pass_key(x1) != keys["base"]


def test_pass_keys_follow_the_record_mode(monkeypatch):
    from icer_compression_tpu_torch.ops import entropy_slim as ES
    x = torch.zeros(1, 48, 40)
    enc = _encoders()
    key = enc.pass_key(x)
    monkeypatch.setattr(ES, "fused_key_ok", lambda L: False)
    assert enc.pass_key(x) != key


def test_distinct_keys_never_share_a_graph():
    cache = fake_cache()
    for key, n in (("a", 1), ("b", 1), ("a", 2), ("b", 2)):
        x = torch.full((n, 3), 7)
        for _ in range(3):
            out, _ = run_pass(cache, (key, n), lambda x: (x * 2, x.sum()), x)
            assert torch.equal(out[0], x * 2)
    # each key: the capture's check and one replay
    assert len(cache.keys()) == 4 and cache.replays == 4 * 2


def test_capture_at_the_second_pass():
    cache = fake_cache()
    calls = []

    def fn(x):
        calls.append(1)
        return (x + 1,)
    x = torch.arange(3)
    out, state = cache.run("k", fn, x)
    assert state == "eager" and "k" not in cache and len(calls) == 1
    out, state = cache.run("k", fn, x)
    # the dispatch half of the second pass runs it eagerly, no more
    assert state == "capture" and "k" not in cache and len(calls) == 2
    assert torch.equal(out[0], x + 1)
    # its collector captures (the stand-in runs fn) and replays once
    cache.capture("k", fn, x, out)
    assert "k" in cache and len(calls) == 4
    assert [(c["attempt"], c["equal"]) for c in cache.captures] == [(1, True)]
    out, state = cache.run("k", fn, x + 5)
    assert state == "replay" and torch.equal(out[0], x + 6) \
        and len(calls) == 5
    # a one-off key never captures
    cache.run("once", fn, x)
    assert "once" not in cache and len(cache.captures) == 1


def test_a_pass_dispatched_before_the_capture_does_not_capture_again():
    """Passes of a key in flight when its first capture is made (a batch
    of many passes, or several deferred batches): only the second is
    marked, so only it keeps its eager outputs for the capture; one
    capture."""
    cache = fake_cache()
    x = torch.arange(3)
    fn = lambda x: (x * 2,)     # noqa: E731
    cache.run("k", fn, x)
    passes = [cache.run("k", fn, x) for _ in range(3)]
    assert [state for _o, state in passes] == ["capture", "eager", "eager"]
    cache.capture("k", fn, x, passes[0][0])
    assert len(cache.captures) == 1 and cache.replays == 1
    assert cache.run("k", fn, x)[1] == "replay"


def test_a_marked_pass_freed_uncaptured_marks_the_next():
    """While the marked pass holds its outputs no other pass is marked;
    once they are freed uncaptured (its collector failed before the
    capture, or never ran), the key's next pass is marked and captures."""
    cache = fake_cache()
    x = torch.arange(3)
    fn = lambda x: (x * 2,)     # noqa: E731
    cache.run("k", fn, x)
    outs, state = cache.run("k", fn, x)
    assert state == "capture"
    assert cache.run("k", fn, x)[1] == "eager"
    del outs
    outs, state = cache.run("k", fn, x)
    assert state == "capture"
    cache.capture("k", fn, x, outs)
    assert "k" in cache and len(cache.captures) == 1
    assert cache.run("k", fn, x)[1] == "replay"


def test_a_collector_that_fails_before_its_capture_leaves_the_key_armed(
        replays, monkeypatch):
    """A batch of two passes whose collector raises on its first pass,
    before the second (marked) pass's capture: once that collector is
    dropped, the next batch's first pass is marked, its collector
    captures, and the batch after replays; the streams are the JAX
    package's."""
    imgs, cfg, enc, want = _three_in_passes_of_two(monkeypatch)
    real = enc._collect
    fail = [True]

    def collect_once(p):
        if fail.pop() if fail else False:
            raise RuntimeError("collector failed")
        return real(p)
    monkeypatch.setattr(enc, "_collect", collect_once)
    collect = enc.encode_batch(imgs, defer=True)
    with pytest.raises(RuntimeError, match="collector failed"):
        collect()
    del collect
    assert replays.captures == []
    assert T.compress_batch(imgs, cfg, encoder=enc) == want
    assert len(replays.captures) == 1
    assert T.compress_batch(imgs, cfg, encoder=enc) == want
    assert len(replays.captures) == 1 and replays.replays == 1 + 2


def test_the_dispatch_half_never_captures(replays):
    """``encode_batch(defer=True)`` on a key's second pass runs it eagerly;
    its collector captures, and the third pass replays."""
    img = boat_crop(32)
    cfg = T.CodecConfig(2, 0, 4, None)
    enc = T.make_encoder(32, 32, cfg, np.uint16, "cpu")
    want = T.allocate_streams(enc.encode_batch(img[None]), cfg, enc)
    collect = enc.encode_batch(img[None], defer=True)
    assert replays.keys() == [] and replays.captures == []
    assert T.allocate_streams(collect(), cfg, enc) == want
    assert len(replays.keys()) == 1 and replays.replays == 1
    assert T.allocate_streams(enc.encode_batch(img[None]), cfg, enc) == want
    assert replays.replays == 2 and len(replays.captures) == 1


def test_a_first_replay_mismatch_recaptures_once():
    cache = fake_cache(bad_captures=1)
    x = torch.arange(3)
    run_pass(cache, "k", lambda x: (x * 3,), x)
    out, _ = run_pass(cache, "k", lambda x: (x * 3,), x)
    assert torch.equal(out[0], x * 3)
    assert [(c["attempt"], c["equal"]) for c in cache.captures] == \
        [(1, False), (2, True)]
    assert "k" in cache
    out, state = cache.run("k", lambda x: (x * 3,), x)
    assert state == "replay" and torch.equal(out[0], x * 3)


def test_a_second_mismatch_raises_and_nothing_runs_eagerly_instead():
    cache = fake_cache(bad_captures=2)
    x = torch.arange(3)
    run_pass(cache, "k", lambda x: (x * 3,), x)
    with pytest.raises(RuntimeError, match="first replay twice"):
        run_pass(cache, "k", lambda x: (x * 3,), x)
    assert "k" not in cache and len(cache.captures) == 2


def test_a_failed_capture_raises(monkeypatch):
    def capture(fn, static_x):
        Counted.launches += 5
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")
    Counted.launches = 0
    cache = GC.GraphCache(capture=capture, counters=lambda: COUNTERS,
                          budget=0)
    x = torch.arange(3)
    run_pass(cache, "k", lambda x: (x,), x)
    with pytest.raises(RuntimeError, match="capturing"):
        run_pass(cache, "k", lambda x: (x,), x)
    assert "k" not in cache and Counted.launches == 0


def test_a_failed_capture_raises_from_the_encoder(monkeypatch, replays):
    def capture(fn, static_x):
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")
    monkeypatch.setattr(GC, "CACHE", GC.GraphCache(capture=capture,
                                                   budget=0))
    img = boat_crop(32)
    cfg = T.CodecConfig(2, 0, 4, None)
    enc = T.make_encoder(32, 32, cfg, np.uint16, "cpu")
    assert enc.graph
    T.compress_batch(img[None], cfg, encoder=enc)
    with pytest.raises(RuntimeError, match="capturing"):
        T.compress_batch(img[None], cfg, encoder=enc)


def test_launch_counters_count_only_what_the_host_launches():
    """A wrapper counts each launch the host issues: the eager passes'.
    A capture launches nothing then, and a replay runs no Python, so
    neither adds to the counts (the kernels count their runs on the
    device, ``kernels.device_runs``)."""
    Counted.launches = 0

    def fn(x):
        Counted.launches += 3
        return (x + 1,)
    cache = fake_cache(counters=COUNTERS)
    x = torch.arange(3)
    run_pass(cache, "k", fn, x)
    assert Counted.launches == 3
    # the second pass runs eagerly; its capture and check add nothing
    run_pass(cache, "k", fn, x)
    assert Counted.launches == 6 and "k" in cache
    for _ in range(3):
        assert run_pass(cache, "k", fn, x)[1] == "replay"
    assert Counted.launches == 6 and cache.replays == 4


def test_kernels_count_their_runs_per_device():
    """The device run counters: one int64 slot per counting kernel, reset
    and read per device (a CPU tensor's wrapper runs the plain version,
    which counts nothing)."""
    from icer_compression_tpu_torch import kernels
    from icer_compression_tpu_torch.ops import entropy_slim as ES
    t = kernels.run_counters("cpu")
    assert t.dtype == torch.int64 and len(t) == len(kernels.RUN_SLOTS)
    assert kernels.run_slot("cpu", "slim_encode_two_word") == \
        t.data_ptr() + 8
    t[2] = 5
    assert kernels.device_runs("cpu")["full_encode"] == 5
    kernels.reset_runs("cpu")
    ES.encode_lanes_slim(torch.zeros((ES.CHUNK, 2), dtype=torch.int32))
    assert set(kernels.device_runs("cpu").values()) == {0}


def test_eviction_bounds_the_pools():
    """Pools of 100 B a graph (static tensors 16 B: an 8-byte input and
    output), one pass budget of 300 B."""
    cache = fake_cache(budget=300, pools={1: 100, 2: 200, 3: 400})
    x = torch.zeros(1, dtype=torch.int64)

    def capture(key, n=1, estimate=0):
        for _ in range(2):
            run_pass(cache, key, lambda x: (x + n,), x, estimate)

    for key in "abc":
        capture(key)
    assert cache.keys() == ["a", "b", "c"] and cache.evictions == 0
    assert cache.pool_total("cpu") <= cache.bound("cpu")
    run_pass(cache, "a", lambda x: (x + 1,), x)       # a: most recently used
    capture("d")
    assert cache.keys() == ["c", "a", "d"] and cache.evictions == 1
    assert cache.pool_total("cpu") <= cache.bound("cpu")
    # a graph of two pools' bytes evicts the two least recently used
    capture("e", 2)
    assert cache.keys() == ["d", "e"] and cache.evictions == 3
    # an estimate of 250 B evicts both before the capture, where the
    # measured 100 B alone would evict d only
    capture("g", 1, estimate=250)
    assert cache.keys() == ["g"] and cache.evictions == 5
    # a graph past the bound is kept alone
    capture("f", 3)
    assert cache.keys() == ["f"] and cache.pool_total("cpu") == 400
    # an evicted key captures again at its next pass
    out, state = run_pass(cache, "b", lambda x: (x + 1,), x)
    assert state == "capture" and "b" in cache and cache.keys() == ["b"]
    assert [c["pool_bytes"] for c in cache.captures][-1] == 100


@pytest.mark.parametrize("env", ["", "expandable_segments:True"])
def test_a_capture_turns_expandable_segments_on_and_back(monkeypatch, env):
    calls = []
    monkeypatch.setattr(GC, "_set_allocator", calls.append)
    monkeypatch.setenv("PYTORCH_CUDA_ALLOC_CONF", env)
    with GC.expandable_segments():
        assert calls == ["expandable_segments:True"]
    assert calls == ["expandable_segments:True"] + (
        [] if env else ["expandable_segments:False"])


def test_pass_bytes_follow_the_budget():
    enc = _encoders()
    per = enc.pass_bytes(1)
    assert per == max(b["words"] for b in enc.buckets) \
        * E.PASS_PEAK_BYTES // E.PASS_WORDS
    assert enc.pass_bytes(3) == 3 * per
    assert enc.pass_bytes(10 ** 9) == E.PASS_PEAK_BYTES
    assert GC.GraphCache().bound("cpu") == E.PASS_PEAK_BYTES


def test_graph_true_on_the_cpu_raises():
    with pytest.raises(ValueError, match="CUDA"):
        _encoders(graph=True)
    with pytest.raises(ValueError, match="CUDA"):
        T.make_encoder(40, 48, T.CodecConfig(2, 0, 6, None), np.uint16,
                       "cpu", graph=True)
    assert not _encoders().graph and not _encoders(graph=False).graph
    assert not T.make_encoder(40, 48, T.CodecConfig(2, 0, 6, None),
                              np.uint16, "cpu").graph
