"""The decoder's captured passes (``models.decode`` through
``backend/graph_cache``) on the CPU.

As in ``test_torch_graph.py``, a stand-in graph does a CUDA graph's part:
its "capture" runs the pass once to make the static outputs, and each
replay runs it again on the static inputs and writes into those same
tensors, as a replay overwrites a graph's outputs.  Through it the split
decode pass (``DecodePlan.device_pass`` and its host edges) is held to the
eager CPU decode and to the JAX package's decode of the same streams,
pixel for pixel, with the third decode of a key a replay; the plan key,
the padded blob, the key tables kept by the cache under its bound, the
two-thread lock, collectors of passes that a later replay overwrote and
the bounded count of seen keys are held to their contract."""

import hashlib
import os
import sys
import threading

import numpy as np
import pytest
import torch

from icer_compression_tpu.models import color as JC
from icer_compression_tpu.models import grayscale as G
from icer_compression_tpu_torch import kernels
from icer_compression_tpu_torch.backend import graph_cache as GC
from icer_compression_tpu_torch.models import color as TC
from icer_compression_tpu_torch.models import decode as D
from icer_compression_tpu_torch.models import grayscale as T
from icer_compression_tpu_torch.parallel import sharded as SH
from icer_compression_tpu_torch.utils import faults as F
from icer_compression_tpu_torch.utils.image_io import read_png
from test_torch_entropy_slim import one_torch_thread  # noqa: F401
from test_torch_graph import fake_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")
BOAT = os.path.join(DATA, "boat.512.png")


def boat_crop(side, dy=0, dx=0, scale=1):
    c = 256 - side // 2
    return np.ascontiguousarray(read_png(BOAT)[c + dy:c + dy + side,
                                               c + dx:c + dx + side]
                                ).astype(np.uint16) * scale


@pytest.fixture
def replays(monkeypatch):
    """Every decode runs its passes through a fake-graph cache; yields the
    cache.  The copies back to the host are real copies, as on the card
    (a CPU tensor would otherwise pass through as the static output)."""
    cache = fake_cache()
    monkeypatch.setattr(GC, "CACHE", cache)
    monkeypatch.setattr(D, "to_host", torch.clone)
    monkeypatch.setattr(D, "_use_graph",
                        lambda graph, dev: graph is not False)
    return cache


def jax_cfg(cfg):
    return G.CodecConfig(cfg.stages, cfg.filt, cfg.segments, cfg.byte_quota)


def three(fn):
    """A key's three decodes through the fake graphs: its eager pass, the
    eager pass its collector captures and checks, a replay."""
    return [fn() for _ in range(3)]


def test_boat_crop_third_decode_replays_and_gives_the_input(replays):
    img = boat_crop(48)
    cfg = T.CodecConfig(4, 0, 6, None)
    stream = G.compress(img, jax_cfg(cfg))
    eager = T.decompress(stream, cfg, np.uint16, device="cpu", graph=False)
    want = G.decompress(stream, jax_cfg(cfg), dtype=np.uint16)
    assert replays.replays == 0 and replays.keys() == []
    for i, got in enumerate(three(lambda: T.decompress(
            stream, cfg, np.uint16, device="cpu"))):
        assert np.array_equal(got, eager) and np.array_equal(got, want)
        assert np.array_equal(got, img), i
    # the capture's check and the third decode
    assert replays.replays == 2 and len(replays.keys()) == 1
    assert [c["equal"] for c in replays.captures] == [True]
    (key,) = replays.keys()
    assert GC.is_decode(key) and key[-2] == D.STREAM_PAD


def test_two_streams_of_other_lengths_share_one_key(replays):
    cfg = T.CodecConfig(3, 0, 4, None)
    a, b = boat_crop(32), boat_crop(32, 90, -100)
    sa, sb = (G.compress(im, jax_cfg(cfg)) for im in (a, b))
    assert len(sa) != len(sb)
    for s, im in ((sa, a), (sa, a), (sb, b)):
        got = T.decompress(s, cfg, np.uint16, device="cpu")
        assert np.array_equal(got, im)
        assert np.array_equal(got, G.decompress(s, jax_cfg(cfg),
                                                dtype=np.uint16))
    # the second stream's first decode is the key's replay
    assert len(replays.keys()) == 1 and replays.replays == 2
    assert np.array_equal(T.decompress(sb, cfg, np.uint16, device="cpu",
                                       graph=False), b)


def _key(streams, cfg, nchan=1, dtype=np.uint16):
    w, h, ll, blob, units = D.plan_batch(streams, cfg, dtype, nchan,
                                         pad=True)
    return D.DecodePlan(w, h, ll, len(blob), units, cfg, dtype, nchan,
                        torch.device("cpu")).key


def test_a_truncated_stream_has_its_own_key(replays):
    """A quota that cuts the stream ends a unit's rounds earlier (or drops
    the unit): another key than the lossless stream's, and its decode
    equals the JAX package's."""
    img = boat_crop(32)
    cfg = T.CodecConfig(3, 0, 4, None)
    qcfg = T.CodecConfig(3, 0, 4, 600)
    full = G.compress(img, jax_cfg(cfg))
    cut = G.compress(img, jax_cfg(qcfg))
    assert len(cut) < len(full)
    kf, kc = _key([full], cfg), _key([cut], qcfg)
    assert kf != kc and kf[9] != kc[9]
    assert sum(r for _b, r, *_ in kc[9]) < sum(r for _b, r, *_ in kf[9])
    want = G.decompress(cut, jax_cfg(qcfg), dtype=np.uint16)
    eager = T.decompress(cut, qcfg, np.uint16, device="cpu", graph=False)
    for got in three(lambda: T.decompress(cut, qcfg, np.uint16,
                                          device="cpu")):
        assert np.array_equal(got, want) and np.array_equal(got, eager)
    assert replays.keys() == [kc] and replays.replays == 2


def _fault_cases(stream):
    sys.path.insert(0, REPO)
    try:
        from chip_smoke import fault_cases
    finally:
        sys.path.remove(REPO)
    return fault_cases(stream, F)


def _pins():
    with open(os.path.join(DATA, "golden_faults.sha256")) as f:
        return dict(ln.split(None, 1)[::-1] for ln in f.read().splitlines())


def test_the_fault_pins_as_one_batch(replays):
    """The 11 faulted streams of phase 22's 64x64 crop, decoded as one
    batch three times: each decode equals its pin (made with the JAX
    package), the JAX package's decode and the eager decode."""
    boat = read_png(BOAT).astype(np.uint16)
    crop = np.ascontiguousarray(boat[224:288, 224:288])
    cfg = T.CodecConfig(4, 0, 6, None)
    cases = _fault_cases(G.compress(crop, jax_cfg(cfg)))
    pins = _pins()
    assert len(cases) == 11
    for label, bad in cases:
        assert hashlib.sha256(bad).hexdigest() == \
            pins[f"crop64 {label} stream"]
    bads = [b for _l, b in cases]
    want = [G.decompress(b, jax_cfg(cfg), dtype=np.uint16) for b in bads]
    runs = three(lambda: D.decompress_batch(bads, cfg, np.uint16,
                                            device="cpu"))
    for got in runs:
        for (label, _b), px, ref in zip(cases, got, want):
            digest = hashlib.sha256(np.ascontiguousarray(
                px, "<u2").tobytes()).hexdigest()
            assert digest == pins[f"crop64 {label} decoded"], label
            assert np.array_equal(px, ref), label
    assert replays.replays == 2 and len(replays.keys()) == 1


def test_a_colour_stream_replays(replays):
    rgb = read_png(BOAT)[240:272, 240:272]
    r, g, b = (rgb.astype(np.int32) + k for k in (0, 17, 40))
    y, u, v = (np.clip(c, 0, 255).astype(np.uint16) for c in (r, g, b))
    cfg = T.CodecConfig(3, 0, 4, None)
    stream = JC.compress_yuv(y, u, v, jax_cfg(cfg))
    want = JC.decompress_yuv(stream, jax_cfg(cfg), dtype=np.uint16)
    eager = TC.decompress_yuv(stream, cfg, np.uint16, device="cpu",
                              graph=False)
    for got in three(lambda: TC.decompress_yuv(stream, cfg, np.uint16,
                                               device="cpu")):
        for a, e, w in zip(got, eager, want):
            assert np.array_equal(a, e) and np.array_equal(a, w)
    (key,) = replays.keys()
    assert key[7:9] == (3, 3)          # nchan, canvases
    assert replays.replays == 2


def test_a_deferred_pack8_fallback_reads_its_own_pass(replays):
    """Two 10-bit images of one key, decoded (``pack8`` set, which
    changes nothing) with both collectors open: the second replay
    overwrites the static pixels, and the first collector still returns
    its own pass exactly, from the copy queued with its replay."""
    cfg = T.CodecConfig(3, 0, 4, 1 << 20)
    a, b = boat_crop(32, scale=4), boat_crop(32, -80, 70, scale=4)
    sa, sb = (G.compress(im, jax_cfg(cfg)) for im in (a, b))
    want = [G.decompress(s, jax_cfg(cfg), dtype=np.uint16) for s in (sa, sb)]
    assert min(w.max() for w in want) > 255
    assert _key([sa], cfg) == _key([sb], cfg)
    for s, w in zip((sa, sb), want):      # the eager pass, the capture
        assert np.array_equal(D.decompress_batch(
            [s], cfg, np.uint16, device="cpu", pack8=True)[0], w)
    first = D.decompress_batch([sa], cfg, np.uint16, device="cpu",
                               pack8=True, defer=True)
    second = D.decompress_batch([sb], cfg, np.uint16, device="cpu",
                                pack8=True, defer=True)
    got_b, got_a = second()[0], first()[0]
    assert np.array_equal(got_a, want[0]) and np.array_equal(got_b, want[1])
    assert np.array_equal(got_a, D.decompress_batch(
        [sa], cfg, np.uint16, device="cpu", graph=False)[0])
    assert replays.replays == 3


def test_two_threads_share_one_capture(replays):
    """Two threads decode two streams of one key through one cache, four
    times each: one capture, and every output exact (the lock keeps a
    replay and the copies that read it together)."""
    cfg = T.CodecConfig(3, 0, 4, None)
    imgs = [boat_crop(32), boat_crop(32, 90, -100)]
    streams = [G.compress(im, jax_cfg(cfg)) for im in imgs]
    got = {0: [], 1: []}
    errors = []

    def work(i):
        try:
            for _ in range(4):
                got[i].append(T.decompress(streams[i], cfg, np.uint16,
                                           device="cpu"))
        except Exception as e:        # raised again below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    for i in (0, 1):
        assert len(got[i]) == 4
        assert all(np.array_equal(px, imgs[i]) for px in got[i])
    assert len(replays.captures) == 1 and replays.captures[0]["equal"]
    assert replays.replays >= 4


def test_the_sharded_decoder_runs_each_half_as_a_graph(replays):
    """A 1 x 1 mesh: kernel 2's share and the finalize are two keys, each
    replayed at the third batch, every batch equal to the single calls."""
    cfg = T.CodecConfig(3, 0, 4, None)
    imgs = [boat_crop(32), boat_crop(32, 90, -100)]
    streams = [G.compress(im, jax_cfg(cfg)) for im in imgs]
    mesh = SH.make_mesh(device="cpu")
    dec = SH.ShardedGrayscaleDecoder(mesh, 32, 32, cfg)
    assert dec.graph and not SH.ShardedGrayscaleDecoder(
        mesh, 32, 32, cfg, graph=False).graph
    for got in three(lambda: dec.decode_batch(streams)):
        assert all(np.array_equal(a, b) for a, b in zip(got, imgs))
    assert sorted(k[1] for k in replays.keys()) == ["finalize", "share"]
    assert replays.replays == 2 * 2


def test_seen_keys_stay_within_their_bound():
    cache = fake_cache()
    cache.seen_keys = 8
    x = (torch.arange(3), torch.ones(2))

    def fn(x):
        return (x[0] + x[1].sum(),)
    for k in range(100):
        assert cache.run(("decode", k), fn, x)[1] == "eager"
        assert len(cache._seen) <= 8
    # a forgotten key starts again at its first pass
    assert cache.run(("decode", 0), fn, x)[1] == "eager"
    assert cache.run(("decode", 0), fn, x)[1] == "capture"
    assert GC.GraphCache().seen_keys == GC.SEEN_KEYS


def test_several_static_inputs_are_copied_at_each_replay():
    cache = fake_cache()

    def fn(x):
        return (x[0] * 2 + x[1][:1], x[1].sum())
    x = (torch.arange(4), torch.tensor([10, 20]))
    for _ in range(2):
        out, state = cache.run("k", fn, x)
    cache.capture("k", fn, x, out)
    y = (torch.arange(4) + 5, torch.tensor([1, 2]))
    out, state = cache.run("k", fn, y)
    assert state == "replay"
    assert torch.equal(out[0], y[0] * 2 + 1) and int(out[1]) == 3
    assert cache.static_bytes("cpu") == 4 * 8 + 2 * 8 + 4 * 8 + 8


def test_the_lock_is_held_around_a_dispatch(monkeypatch, replays):
    """The decode's dispatch half holds the cache's lock: another thread
    cannot take it meanwhile."""
    cfg = T.CodecConfig(3, 0, 4, None)
    stream = G.compress(boat_crop(32), jax_cfg(cfg))
    seen = []
    real = D.DecodePlan.device_pass

    def probe(self, x):
        got = []
        t = threading.Thread(
            target=lambda: got.append(replays.lock.acquire(blocking=False)))
        t.start()
        t.join()
        seen.append(got[0])
        return real(self, x)
    monkeypatch.setattr(D.DecodePlan, "device_pass", probe)
    T.decompress(stream, cfg, np.uint16, device="cpu")
    assert seen == [False]


def test_plan_keys_hold_every_field_that_fixes_a_pass(replays):
    cfg = T.CodecConfig(3, 0, 4, None)
    a, b = boat_crop(32), boat_crop(48)
    sa, sb = (G.compress(im, jax_cfg(cfg)) for im in (a, b))
    base = _key([sa], cfg)
    # pack8 fixes nothing of a pass: both settings decode under one key
    for pack8 in (True, False):
        D.decompress_batch([sa], cfg, np.uint16, device="cpu", pack8=pack8)
    assert replays.keys() == [base]
    keys = {
        "base": base,
        "geometry": _key([sb], cfg),
        "canvases": _key([sa, sa], cfg),
        "filter": _key([sa], T.CodecConfig(3, 1, 4, None)),
        "uint8": _key([sa], cfg, dtype=np.uint8),
    }
    assert len(set(keys.values())) == len(keys)
    assert _key([sa], cfg) == base


def test_the_blob_pads_to_the_granularity_below_the_kernels_limit():
    from icer_compression_tpu_torch.ops.plane_decode import MAX_STREAM_BYTES
    assert D.padded(1) == D.STREAM_PAD
    assert D.padded(D.STREAM_PAD) == D.STREAM_PAD
    assert D.padded(D.STREAM_PAD + 1) == 2 * D.STREAM_PAD
    assert D.padded(MAX_STREAM_BYTES - 5) == MAX_STREAM_BYTES - 1
    cfg = T.CodecConfig(3, 0, 4, None)
    s = G.compress(boat_crop(32), jax_cfg(cfg))
    blob = D.plan_batch([s], cfg, np.uint16, pad=True)[3]
    assert len(blob) == D.STREAM_PAD and not blob[len(s):].any()
    assert bytes(blob[:len(s)]) == s
    assert len(D.plan_batch([s], cfg, np.uint16)[3]) == len(s)


def test_key_tables_are_made_once_per_plan_and_bounded(replays):
    """A key's tables are made at its first pass, kept with its record of
    passes, then with its graph; they count against the bound with the
    pools, the tables of keys not captured going first, and ``clear``
    drops them."""
    cfg = T.CodecConfig(3, 0, 4, None)
    s = G.compress(boat_crop(32), jax_cfg(cfg))
    w, h, ll, blob, units = D.plan_batch([s], cfg, np.uint16, pad=True)

    def plan():
        return D.DecodePlan(w, h, ll, len(blob), units, cfg, np.uint16, 1,
                            torch.device("cpu"))
    one = plan()
    assert plan().tables is one.tables and replays.tables_made == 1
    first, step = D._canvas_index(units, 1, 32, 32)
    assert np.array_equal(one.tables.first.numpy(), first)
    assert np.array_equal(one.tables.step.numpy(), step)
    assert replays.table_bytes("cpu") == one.tables.nbytes
    for _ in range(3):                 # eager, capture, replay
        T.decompress(s, cfg, np.uint16, device="cpu")
    (entry,) = replays._entries.values()
    assert entry.owner is one.tables and replays.tables_made == 1
    assert replays._seen[one.key].owner is None
    assert replays.table_bytes("cpu") == one.tables.nbytes
    # a bound that holds the graph and one key's tables: another key's
    # new tables drop the last one's, never the graph's
    replays.budget = replays.held_bytes("cpu") + one.tables.nbytes \
        - replays.static_bytes("cpu")
    ws, hs, lls, blobs, unitss = D.plan_batch([s, s], cfg, np.uint16,
                                              pad=True)
    two = D.DecodePlan(ws, hs, lls, len(blobs), unitss, cfg, np.uint16, 1,
                       torch.device("cpu"))
    three_ = D.DecodePlan(ws, hs, lls, len(blobs) + 1, unitss, cfg,
                          np.uint16, 1, torch.device("cpu"))
    assert replays._seen[two.key].owner is None
    assert replays._seen[three_.key].owner is three_.tables
    assert replays.tables_dropped == 1 and one.key in replays
    assert replays.held_bytes("cpu") <= replays.bound("cpu") \
        + three_.tables.nbytes
    replays.clear()
    assert replays.table_bytes("cpu") == 0


def test_a_wide_decode_holds_nothing_for_its_collector(replays):
    """The copy to the host is queued with the replay, so a later replay
    of the key, before the first collector runs, leaves its pixels
    whole."""
    cfg = T.CodecConfig(3, 0, 4, None)
    a, b = boat_crop(32), boat_crop(32, -80, 70)
    sa, sb = (G.compress(im, jax_cfg(cfg)) for im in (a, b))
    for _ in range(2):
        D.decompress_batch([sa], cfg, np.uint16, device="cpu")
    first = D.decompress_batch([sa], cfg, np.uint16, device="cpu",
                               defer=True)
    second = D.decompress_batch([sb], cfg, np.uint16, device="cpu",
                                defer=True)
    assert np.array_equal(second()[0], b) and np.array_equal(first()[0], a)
    assert replays.replays == 3


def test_two_threads_pack8_fallbacks_read_their_own_pass(replays):
    """A collector whose key another thread has replayed since (over the
    static pixels its pass wrote) returns its own pass exactly; then two
    threads of 10-bit decodes of the two streams, four each, with
    ``pack8`` set, are all exact."""
    cfg = T.CodecConfig(3, 0, 4, 1 << 20)
    imgs = [boat_crop(32, scale=4), boat_crop(32, -80, 70, scale=4)]
    streams = [G.compress(im, jax_cfg(cfg)) for im in imgs]
    want = [G.decompress(s, jax_cfg(cfg), dtype=np.uint16) for s in streams]
    assert min(w.max() for w in want) > 255

    def decode(i, defer=False):
        return D.decompress_batch([streams[i]], cfg, np.uint16,
                                  device="cpu", pack8=True, defer=defer)
    for i in (0, 1):                   # the eager pass, the capture
        decode(i)
    first = decode(0, defer=True)
    got = []
    t = threading.Thread(target=lambda: got.append(decode(1)[0]))
    t.start()
    t.join(60)
    assert not t.is_alive() and replays.replays == 3
    assert np.array_equal(first()[0], want[0])
    assert np.array_equal(got[0], want[1])

    out = {0: [], 1: []}
    errors = []

    def work(i):
        try:
            for _ in range(4):
                out[i].append(decode(i, defer=True)()[0])
        except Exception as e:        # raised again below
            errors.append(e)
    threads = [threading.Thread(target=work, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    for i in (0, 1):
        assert len(out[i]) == 4
        assert all(np.array_equal(px, want[i]) for px in out[i])
    assert len(replays.captures) == 1


def test_graph_true_on_the_cpu_raises():
    cfg = T.CodecConfig(3, 0, 4, None)
    s = G.compress(boat_crop(32), jax_cfg(cfg))
    with pytest.raises(ValueError, match="CUDA"):
        D.decompress_batch([s], cfg, np.uint16, device="cpu", graph=True)
    with pytest.raises(ValueError, match="CUDA"):
        TC.decompress_yuv(s, cfg, np.uint16, device="cpu", graph=True)


def test_decode_kernels_have_run_slots_and_pools_their_kind():
    for name in ("plane_decode", "plane_decode_seeded", "wavelet_inverse"):
        assert name in kernels.RUN_SLOTS
    assert kernels.RUN_SLOTS[:4] == ("slim_encode", "slim_encode_two_word",
                                     "full_encode", "full_encode_tiled")
    cache = fake_cache()
    x = torch.zeros(2, dtype=torch.int64)
    for key in (("decode", 1), "enc"):
        for _ in range(2):
            out, state = cache.run(key, lambda x: (x + 1,), x)
        cache.capture(key, lambda x: (x + 1,), x, out)
    assert cache.pool_total("cpu", "decode") == 16
    assert cache.pool_total("cpu", "encode") == 16
    assert cache.pool_total("cpu") == 32
