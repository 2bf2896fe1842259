"""The benchmark's plain colour reference (``benchmark/reference/color.py``)
against the port's colour path, on the CPU through the kernels' plain
versions: ``compress_yuv_batch`` streams byte for byte, and
``decompress_yuv_batch`` of them the reference's expected planes, at 2
bpp and lossless; the reference's colour conversion, packet list and
stream order against the port's; the colour spans and counts of a
profiled ``compress_yuv_batch``; and the colour cell's mode file
(``benchmark/modes/color_batch_encode.py``) end to end on a tiny frame,
with each of the check's controls failing through its reference hook."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import check, load, run
from benchmark.reference import codec as R
from benchmark.reference import color as RC
from benchmark.reference import packets as RP
from icer_compression_tpu_torch.core import packets as TP
from icer_compression_tpu_torch.models import color as TC
from icer_compression_tpu_torch.models import decode as D
from icer_compression_tpu_torch.models import grayscale as T
from icer_compression_tpu_torch.ops import encode as E
from icer_compression_tpu_torch.utils import colorspace as TCS
from icer_compression_tpu_torch.utils import trace

ROOT = Path(__file__).resolve().parents[1]
MODES = ROOT / "benchmark" / "modes"
SEED = 2 ** 31 + 11
CODEC = R.Codec()


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def mode():
    return load.mode_file("color_batch_encode", MODES)


def rgb_frames(h, w, n, seed=SEED):
    """``n`` seeded RGB frames of the colour cell's recipe at (h, w)."""
    cfg = {"width": w, "height": h, "noise": 6}
    return mode().rgb_pool(cfg, seed, n)


def port_planes(rgb):
    """The frames' (y, u, v) uint16 plane lists, as the CLI makes them."""
    planes = [[c.astype(np.uint16) for c in TCS.rgb_to_ycbcr(f)]
              for f in rgb]
    return [[p[c] for p in planes] for c in range(3)]


# (h, w, frames, quota in bits per frame pixel; None: lossless)
CASES = [(64, 96, 3, 2.0), (61, 99, 2, 2.0), (64, 96, 2, None),
         (61, 99, 2, None)]


@pytest.fixture(scope="module", params=range(len(CASES)),
                ids=[f"{h}x{w}-{q or 'lossless'}" for h, w, _n, q in CASES])
def encoded(request):
    """(config, the port's streams, the reference's results) of a case."""
    h, w, n, bpp = CASES[request.param]
    quota = None if bpp is None else int(bpp * h * w) // 8
    rgb = rgb_frames(h, w, n)
    cfg = T.CodecConfig(4, 0, 6, quota)
    torch.set_num_threads(1)
    streams = TC.compress_yuv_batch(*port_planes(rgb), cfg, device="cpu")
    return cfg, streams, RC.encode_color(list(rgb), quota, CODEC)


def test_compress_yuv_batch_equals_the_reference(encoded):
    _cfg, streams, ref = encoded
    assert [r["stream"] for r in ref] == streams
    for r in ref:          # every channel keeps segments at these quotas
        assert all(r["included"])


def test_decompress_yuv_batch_equals_the_reference_pixels(encoded):
    cfg, streams, ref = encoded
    dec = D.decompress_yuv_batch(streams, cfg, dtype=np.uint16,
                                 device="cpu")
    for planes, r in zip(dec, ref):
        assert np.array_equal(np.stack(planes),
                              RC.expected_pixels(r, CODEC))


def test_a_channel_the_quota_cuts_decodes_to_zeros():
    """At 200 bytes a channel keeps no segment: the reference's planes for
    it are zeros, as the port decodes them (LL mean 0)."""
    rgb = rgb_frames(40, 48, 1)
    cfg = T.CodecConfig(4, 0, 6, 200)
    (stream,) = TC.compress_yuv_batch(*port_planes(rgb), cfg, device="cpu")
    (r,) = RC.encode_color(list(rgb), 200, CODEC)
    assert r["stream"] == stream and not all(r["included"])
    (dec,) = D.decompress_yuv_batch([stream], cfg, dtype=np.uint16,
                                    device="cpu")
    want = RC.expected_pixels(r, CODEC)
    assert np.array_equal(np.stack(dec), want)
    assert not want[[not inc for inc in r["included"]]].any()


@pytest.mark.parametrize("kind", ["noise", "extremes", "grey"])
def test_rgb_to_ycbcr_equals_the_port(kind):
    rng = np.random.default_rng(7)
    if kind == "noise":
        rgb = rng.integers(0, 256, (37, 53, 3))
    elif kind == "extremes":
        rgb = rng.choice([0, 1, 254, 255], (37, 53, 3))
    else:
        rgb = np.repeat(rng.integers(0, 256, (37, 53, 1)), 3, axis=-1)
    rgb = rgb.astype(np.uint8)
    for a, b in zip(RC.rgb_to_ycbcr(rgb), TCS.rgb_to_ycbcr(rgb)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


FIELDS = ("subband_type", "decomp_level", "ll_mean_val", "lsb", "priority",
          "image_w", "image_h", "channel")


@pytest.mark.parametrize("stages,bitplanes,means", [
    (1, 9, (0, 0, 0)), (4, 9, (117, 300, 5)), (6, 9, (255, 128, 1)),
    (4, 7, (17, 18, 19))])
def test_colour_packets_and_order_equal_the_port(stages, bitplanes, means):
    """The packet list (creation order and sorted, the Y doubling
    included) and the uint16 stream order, field for field."""
    ref = RC.build_packets_color(99, 61, stages, list(means), bitplanes)
    port = TP.build_packets_color(99, 61, stages, list(means), bitplanes)
    for a, b in ((ref, port), (RP.sort_packets(ref),
                               TP.sort_packets(port))):
        assert [tuple(getattr(p, f) for f in FIELDS) for p in a] \
            == [tuple(getattr(p, f) for f in FIELDS) for p in b]
    assert RC.rearrange_order_color_uint16(bitplanes) \
        == TP.rearrange_order_color_uint16(bitplanes)


@pytest.mark.parametrize("colour", [False, True])
@pytest.mark.parametrize("stages,bitplanes", [(1, 9), (4, 9), (5, 15),
                                              (4, 7)])
def test_sorted_packets_equal_the_jax_packages(colour, stages, bitplanes):
    """The port sorts packets by a key, the JAX package through the
    reference's comparator: the same order, priority ties included."""
    from icer_compression_tpu.core import packets as JP
    if colour:
        lists = [m.build_packets_color(64, 48, stages, [3, 200, 77],
                                       bitplanes) for m in (JP, TP)]
    else:
        lists = [m.build_packets_grayscale(64, 48, stages, 91, bitplanes)
                 for m in (JP, TP)]
    want, got = JP.sort_packets(lists[0]), TP.sort_packets(lists[1])
    assert [tuple(getattr(p, f) for f in FIELDS) for p in want] \
        == [tuple(getattr(p, f) for f in FIELDS) for p in got]


def test_profiled_compress_yuv_batch_records_colour_spans(tmp_path,
                                                         monkeypatch):
    """``color.stack`` in the dispatch half before the encode's own
    dispatch; in the collector one ``alloc.yuv`` an image, each as soon as
    the pass holding its last canvas is collected (the 6 canvases of two
    images in passes of 3, ``PASS_WORDS`` lowered in this test: the first
    image's allocation comes before the second pass's collect); the
    counts of images and canvases; the streams are the same bytes as with
    the profiler off and as in one pass."""
    rgb = rgb_frames(40, 48, 2)
    cfg = T.CodecConfig(4, 0, 6, 2 * 40 * 48 // 8)
    planes = port_planes(rgb)
    monkeypatch.setattr(T, "_ENCODERS", {})
    want = TC.compress_yuv_batch(*planes, cfg, device="cpu")
    (enc,) = T._ENCODERS.values()
    monkeypatch.setattr(E, "PASS_WORDS", 3 * enc.words_per_image)
    monkeypatch.setattr(T, "_ENCODERS", {})
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = TC.compress_yuv_batch(*planes, cfg, device="cpu",
                                    defer=True)()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    assert got == want
    assert [e.pass_images for e in T._ENCODERS.values()] == [3]

    def spans(name):
        return sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                      if e.get("cat") == "user_annotation"
                      and e.get("name") == trace.PREFIX + name)

    (stack,), (dispatch,) = spans("color.stack"), spans("encode.dispatch")
    collects, allocs = spans("encode.collect"), spans("alloc.yuv")
    assert stack[1] <= dispatch[0]
    assert len(collects) == len(allocs) == 2
    assert collects[0][1] <= allocs[0][0] <= allocs[0][1] <= collects[1][0]
    assert collects[1][1] <= allocs[1][0]
    counts = trace.count_sums(events)
    assert counts["color.images"] == 2 and counts["color.canvases"] == 6


TINY = {"name": "tinycolor", "source": "test", "width": 48, "height": 40,
        "bit_depth": 8, "container": "uint16", "stages": 4, "filter": "A",
        "segments": 6, "noise": 6, "color_transform": "ycbcr",
        "reduced": []}
TRAFFIC = {"mode": "color_batch_encode", "batch": 2, "inflight": 2,
           "pool": 4, "quota_bpp": 2.0, "warm_serial": 1,
           "warm_pipelined": 1, "trace_batches": 2, "check_frames": 2}
CELL = "mastcamz1600.color_batch_encode_2bpp"


@pytest.fixture
def tiny(tmp_path):
    """(bench, traffic dir): BENCHMARK.json with a tiny 48x40 colour cell
    that reports the colour cell's metrics."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = tmp_path / "tinycolor.json"
    cfg.write_text(json.dumps(TINY))
    tdir = tmp_path / "traffic"
    tdir.mkdir()
    (tdir / "color.json").write_text(json.dumps(TRAFFIC))
    bench["configs"].append({"name": "tinycolor", "source": "t",
                             "file": str(cfg), "reduced": []})
    bench["workloads"].append({"name": "tiny.color", "config": "tinycolor",
                               "traffic": "color", "chips": 1, "why": "t"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if CELL in m.get("workloads", ()):
            m["workloads"].append("tiny.color")
    return bench, tdir


@pytest.mark.parametrize("traced", [False, True])
def test_the_mode_file_runs_end_to_end_on_the_cpu(tiny, traced):
    bench, tdir = tiny
    out = run.execute(bench, "tiny.color", SEED, 1.0, traced, dev="cpu",
                      workers=0, traffic_dir=tdir, modes_dir=MODES)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 2
    assert set(out["checks"]) == {"answers_missing", "streams_wrong"}
    metrics = out["metrics"]
    if traced:
        for name in ("host_alloc_ms_per_MP.color",
                     "host_stack_ms_per_MP.color"):
            assert metrics[name]["value"] > 0
    else:
        assert {"setup_s", "encode_MPps"} <= set(metrics)


@pytest.mark.parametrize("control,size,number", [
    # at 256x256 lossless a lane fills the codeword buffer
    ("unbounded_window", 256, "streams_wrong"),
    ("one_plane_short", 64, "pixels_wrong"),
])
def test_each_control_fails_through_the_colour_hook(control, size, number):
    """Each of ``check.CONTROLS`` through the mode file's ``reference``:
    the answers are the sound reference's, and the hook puts the fault
    in, so the check's numbers fail."""
    assert control in check.CONTROLS
    mod = mode()
    config = dict(TINY, width=size, height=size)
    r = load.Run({"name": "t"}, config, TRAFFIC, SEED, False)
    r.pool = mod.rgb_pool(config, SEED, 1)
    r.check_keys = {0}
    r.reference_hook = mod.reference
    quota = 3 * 2 * size * size
    sound = mod.reference(r, quota, 0, None)
    r.answers = [(0, "stream", sound[0]["stream"]),
                 (0, "pixels", tuple(sound[0]["pixels"]))]
    r.attempted = r.answered = 1
    assert all(v == 0 for _n, v, _lim in check.run_check(r, quota, 0))
    numbers = dict((n, v) for n, v, _ in
                   check.run_check(r, quota, 0, control=control))
    assert numbers[number] > 0
