"""The port's slice as a whole vs the JAX package: streams byte for byte,
decodes pixel for pixel (exact), on the CPU through the kernels' plain
versions."""

import hashlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import make_test_image
from icer_compression_tpu.models import grayscale as G
from icer_compression_tpu_torch.models import decode as TD
from icer_compression_tpu_torch.models import grayscale as T
from test_torch_entropy_slim import one_torch_thread  # noqa: F401

DATA = os.path.join(os.path.dirname(__file__), "data")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (h, w, dtype, filter, stages, segments, byte quota); quotas below the
# stream size truncate it
CASES = [
    (64, 64, np.uint16, 0, 4, 6, None),
    (80, 96, np.uint8, 1, 3, 6, 2500),
    (64, 64, np.uint8, 1, 1, 6, None),
    (64, 64, np.uint16, 0, 2, 1, 1200),
]


def _image(h, w, dtype, seed):
    rng = np.random.default_rng(seed)
    return make_test_image(h, w, rng, dtype=dtype, amplitude=100, noise=24)


@pytest.mark.parametrize("case", range(len(CASES)))
def test_compress_and_decompress_match_jax_package(case):
    h, w, dtype, filt, stages, segs, quota = CASES[case]
    img = _image(h, w, dtype, case)
    jcfg = G.CodecConfig(stages, filt, segs, quota)
    tcfg = T.CodecConfig(stages, filt, segs, quota)
    ref = G.compress(img, jcfg)
    out = T.compress(img, tcfg, device="cpu")
    assert out == ref
    if quota is not None:
        full = G.compress(img, G.CodecConfig(stages, filt, segs, None))
        assert len(ref) <= quota < len(full)
    dec = T.decompress(out, tcfg, dtype=dtype, device="cpu")
    ref_dec = G.decompress(ref, jcfg, dtype=dtype)
    assert dec.dtype == ref_dec.dtype
    assert np.array_equal(dec, ref_dec)
    if quota is None:
        assert np.array_equal(dec, img)


def test_corrupted_stream_decodes_like_jax_package():
    img = _image(64, 64, np.uint16, 9)
    cfg = T.CodecConfig(4, 0, 6, None)
    stream = bytearray(G.compress(img, G.CodecConfig(4, 0, 6, None)))
    rng = np.random.default_rng(9)
    for pos in rng.integers(len(stream) // 3, len(stream), 12):
        stream[pos] ^= 0x5A        # header and payload CRC failures
    stream = bytes(stream[:-700])  # and a cut tail
    ref = G.decompress(stream, G.CodecConfig(4, 0, 6, None))
    out = T.decompress(stream, cfg, device="cpu")
    assert np.array_equal(out, ref)
    assert not np.array_equal(out, img)


# the JAX package's round-5 over-read configs
# (tests/test_decode_jax_model.py::test_overread_hazard_color_regression)
OVERREAD = [(56, 88, 3, 2, 2, 0), (94, 93, 3, 2, 5, 2), (69, 63, 3, 2, 4, 0),
            (94, 82, 4, 3, 5, 0)]


def _overread_stream(h, w, st, g, f, seed):
    """(colour stream from the JAX package, its quota) of an over-read
    config, with the fuzz repro's draw order."""
    from icer_compression_tpu.models.color import compress_yuv
    rng = np.random.default_rng(seed)
    _ = [rng.integers(0, 100, (h, w)) + rng.integers(0, 26, (h, w))
         for _ in range(3)]
    planes = [rng.integers(0, 256, (h, w)).astype(np.uint16)
              for _ in range(3)]
    quota = max(256, int(h * w * 6 * 0.15))
    return compress_yuv(*planes, G.CodecConfig(st, f, g, quota)), quota


@pytest.mark.parametrize("h,w,st,g,f,seed", OVERREAD)
def test_overread_streams_decode_like_jax_package(h, w, st, g, f, seed):
    """The over-read configs (the reference's frozen bounds let a plane's
    decode read the following packets' bytes), as grayscale decodes of
    their streams: the kernel-2 lanes read the whole stream in place, so
    the over-read needs no window or re-decode."""
    from icer_compression_tpu_torch.ops import plane_decode as TPD
    stream, quota = _overread_stream(h, w, st, g, f, seed)
    ref = G.decompress(stream, G.CodecConfig(st, f, g, quota))
    cfg = T.CodecConfig(st, f, g, quota)
    assert np.array_equal(T.decompress(stream, cfg, device="cpu"), ref)
    _w, _h, _ll, blob, units = TD.plan_batch([stream], cfg, np.uint16)
    over = 0
    for u in units:
        args = [torch.as_tensor(u[k])
                for k in ("offs", "ebits", "lane_end", "geom")]
        _o, _e, pos = TPD.decode_planes(torch.as_tensor(blob), *args,
                                        u["hmax"], u["wmax"], 8, 15)
        over += int((pos.numpy() > u["ebits"]).sum())
    assert over > 0       # some plane decode read past its data_length


@pytest.mark.parametrize("h,w,st,g,f,seed", OVERREAD)
def test_overread_streams_decode_as_colour_like_jax_package(h, w, st, g, f,
                                                            seed):
    """The over-read configs through the colour decoder: the port's
    ``decompress_yuv`` equals the JAX package's, plane for plane."""
    from icer_compression_tpu.models.color import decompress_yuv
    from icer_compression_tpu_torch.models import color as TC
    stream, quota = _overread_stream(h, w, st, g, f, seed)
    ref = decompress_yuv(stream, G.CodecConfig(st, f, g, quota),
                         dtype=np.uint16)
    out = TC.decompress_yuv(stream, T.CodecConfig(st, f, g, quota),
                            np.uint16, device="cpu")
    assert len(out) == len(ref) == 3
    for a, b in zip(out, ref):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_batch_entry_points_match_single_calls():
    imgs = np.stack([_image(48, 40, np.uint8, s) for s in (1, 2, 3)])
    cfg = T.CodecConfig(2, 0, 6, None)
    streams = T.compress_batch(imgs, cfg, device="cpu")
    for i in range(3):
        assert streams[i] == G.compress(imgs[i], G.CodecConfig(2, 0, 6, None))
    decs = TD.decompress_batch(streams, cfg, np.uint8, device="cpu")
    for i in range(3):
        assert np.array_equal(decs[i], imgs[i])


def test_decode_batch_splits_at_the_blob_cap(monkeypatch):
    """Kernel 2 reads a pass's joined streams as one blob of fewer than
    ``PASS_BYTES`` bytes: a batch past it decodes in passes, equal to the
    single calls; a single stream that reaches it raises IcerError."""
    from icer_compression_tpu_torch.core.status import IcerError, IcerStatus
    imgs = [_image(48, 40, np.uint8, s) for s in (1, 2, 3)]
    cfg = T.CodecConfig(2, 0, 6, None)
    streams = [G.compress(im, G.CodecConfig(2, 0, 6, None)) for im in imgs]
    want = [T.decompress(s, cfg, np.uint8, device="cpu") for s in streams]
    monkeypatch.setattr(TD, "PASS_BYTES", max(map(len, streams)) + 1)
    assert len(TD._passes(streams)) >= 2
    decs = TD.decompress_batch(streams, cfg, np.uint8, device="cpu")
    for got, w, im in zip(decs, want, imgs):
        assert np.array_equal(got, w) and np.array_equal(got, im)
    monkeypatch.setattr(TD, "PASS_BYTES", len(streams[1]))
    with pytest.raises(IcerError) as e:
        TD.decompress_batch(streams, cfg, np.uint8, device="cpu")
    assert e.value.status == IcerStatus.INVALID_INPUT


def test_flagged_lanes_reencode_exactly_on_host(monkeypatch):
    """Lanes the coder kernel flags take the exact host re-encode."""
    from icer_compression_tpu_torch.ops import entropy_slim as ES
    real = ES.encode_lanes_slim

    def flag_every_third(words):
        rec, fstate, misc, ev = real(words)
        misc = misc.clone()
        misc[0, ::3] = 1
        return rec, fstate, misc, ev

    monkeypatch.setattr(ES, "encode_lanes_slim", flag_every_third)
    img = _image(48, 40, np.uint16, 4)
    cfg = T.CodecConfig(2, 0, 6, None)
    enc = T.make_encoder(40, 48, cfg, np.uint16, "cpu")
    out = T.compress_batch(img[None], cfg, encoder=enc)[0]
    assert out == G.compress(img, G.CodecConfig(2, 0, 6, None))
    assert enc.fallback_lanes > 0


def test_compress_matches_compress_jax():
    img = _image(24, 24, np.uint16, 5)
    ref = G.compress_jax(img, G.CodecConfig(1, 0, 1, None))
    assert T.compress(img, T.CodecConfig(1, 0, 1, None), device="cpu") == ref


def test_entry_points_need_cuda_or_an_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    img = _image(32, 32, np.uint8, 0)
    cfg = T.CodecConfig(1, 0, 1, None)
    stream = T.compress(img, cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        T.compress(img, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        T.decompress(stream, cfg, dtype=np.uint8)
    with pytest.raises(RuntimeError, match="CUDA"):
        TD.decompress_batch([stream], cfg, np.uint8)


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import icer_compression_tpu_torch as P\n"
        "for m in pkgutil.walk_packages(P.__path__, P.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.startswith('icer_compression_tpu.')"
        " or m == 'icer_compression_tpu']\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith(P.__name__)]))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout) >= 15


def test_pinned_boat_references():
    """The pins chip_smoke.py holds the port to, recomputed with the JAX
    package's host path."""
    from PIL import Image
    boat = np.asarray(Image.open(os.path.join(DATA, "boat.512.png"))
                      .convert("L")).astype(np.uint16)
    with open(os.path.join(DATA, "golden_boat512_q50000.sha256")) as f:
        pins = [ln.split()[0] for ln in f.read().splitlines()]
    cfg = G.CodecConfig(4, 0, 6, 50000)
    stream = G.compress(boat, cfg)
    px = G.decompress(stream, cfg, dtype=np.uint16)
    assert len(stream) == 48886
    assert hashlib.sha256(stream).hexdigest() == pins[0]
    assert hashlib.sha256(np.ascontiguousarray(px, "<u2").tobytes()) \
        .hexdigest() == pins[1]


# (h, w, dtype, stages, byte quota) for the coder backends
BACKEND_CASES = [
    (64, 64, np.uint8, 1, None),
    (64, 64, np.uint16, 3, 2000),
    (80, 96, np.uint8, 2, None),
    (80, 96, np.uint16, 3, None),
]
_JAX_STREAMS: dict = {}


def _jax_stream(case):
    """G.compress_jax of a backend case (compiled once per case)."""
    if case not in _JAX_STREAMS:
        h, w, dtype, stages, quota = BACKEND_CASES[case]
        _JAX_STREAMS[case] = G.compress_jax(
            _image(h, w, dtype, 30 + case), G.CodecConfig(stages, 0, 6, quota))
    return _JAX_STREAMS[case]


@pytest.mark.parametrize("entropy", ["pallas", "sorted"])
@pytest.mark.parametrize("case", range(len(BACKEND_CASES)))
def test_coder_backends_match_jax_package(case, entropy):
    h, w, dtype, stages, quota = BACKEND_CASES[case]
    img = _image(h, w, dtype, 30 + case)
    cfg = T.CodecConfig(stages, 0, 6, quota)
    enc = T.make_encoder(w, h, cfg, dtype, "cpu", entropy=entropy)
    assert enc.entropy == entropy
    out = T.compress_batch(img[None], cfg, encoder=enc)[0]
    assert out == G.compress(img, G.CodecConfig(stages, 0, 6, quota))
    if quota is None:
        assert out == _jax_stream(case)


def _flat_image():
    """A near-constant image: its planes code so few bytes that the
    quota prefix classes undershoot and have to widen."""
    rng = np.random.default_rng(3)
    return (100 + (rng.random((64, 64)) < 0.01)).astype(np.uint8)


@pytest.mark.parametrize("quota,escalates", [(300, False), (600, False),
                                             (816, True)])
def test_quota_classes_match_compress_jax(quota, escalates):
    img = _flat_image()
    cfg = T.CodecConfig(1, 0, 1, quota)
    stats = {}
    out = T.compress_batch(img[None], cfg, device="cpu", stats=stats)[0]
    assert out == G.compress_jax(img, G.CodecConfig(1, 0, 1, quota))
    assert (stats["escalations"] > 0) == escalates
    assert stats["first_class"] < stats["classes"] - 1
    # the full encode, then allocation, gives the same stream
    enc = T.make_encoder(64, 64, cfg, np.uint8, "cpu")
    assert out == T.allocate_streams(enc.encode_batch(img[None]), cfg,
                                     enc)[0]


def test_plane_window_encoder_returns_only_its_lanes():
    img = _image(48, 40, np.uint16, 6)
    cfg = T.CodecConfig(2, 0, 6, None)
    full, mean = T.make_encoder(40, 48, cfg, np.uint16, "cpu",
                                entropy="sorted").encode_batch(img[None])[0]
    part, mean2 = T.make_encoder(40, 48, cfg, np.uint16, "cpu",
                                 entropy="sorted",
                                 plane_cuts=((3, 5), 7)).encode_batch(
                                     img[None])[0]
    assert mean2 == mean
    assert set(part) == {k for k in full if
                         (3 <= k[2] < 5 if k[0] == 1 else k[2] >= 7)}
    assert all(part[k] == full[k] for k in part)


def _boat():
    from PIL import Image
    return np.asarray(Image.open(os.path.join(DATA, "boat.512.png"))
                      .convert("L")).astype(np.uint16)


def test_long_lane_pins_cover_lossless_decodes():
    """The unlimited decode pins of chip_smoke.py's long-lane phase are its
    input images."""
    sys.path.insert(0, REPO)
    import chip_smoke
    with open(os.path.join(DATA, "golden_long_lanes.sha256")) as f:
        pins = dict(ln.split(None, 1)[::-1] for ln in f.read().splitlines())
    images = chip_smoke.long_lane_images(_boat())
    for key in ("gray1024", "gray999x601"):
        assert pins[f"{key} v0 unlimited decoded"] \
            == chip_smoke.pixels_sha(images[key][0])
    assert pins["color1024 unlimited decoded"] == chip_smoke.planes_sha(
        chip_smoke.color_planes(images["color1024"], np.uint16))
    assert images["gray1024"].shape == (chip_smoke.LONG_LANE_BATCH, 1024,
                                        1024)
    assert images["gray999x601"].shape[1:] == (601, 999)


@pytest.mark.parametrize("entropy", ["slim", "pallas", "sorted"])
def test_long_lanes_need_a_backend_without_the_fused_key_limit(entropy):
    """A 256x256 image at one stage and one segment has lanes of 32,768
    emission slots, past the slim coder's fused-key limit: ``slim`` codes
    them in its two-word mode (boat's centre crop, byte for byte the JAX
    package's stream), the other two backends take them as they are
    (construction only).  Lanes of 2**17 slots (512x512 at one stage and
    one segment), which the JAX package's slim coder refuses, take the
    two-word mode too: its ordinals and side buffer have no length
    limit."""
    cfg = T.CodecConfig(1, 0, 1, None)
    enc = T.make_encoder(256, 256, cfg, np.uint16, "cpu", entropy=entropy)
    assert enc.buckets[0]["L"] == 2 * 128 * 128
    if entropy == "slim":
        crop = np.ascontiguousarray(_boat()[128:384, 128:384])
        assert T.compress(crop, cfg, device="cpu") \
            == G.compress(crop, G.CodecConfig(1, 0, 1, None))
        assert T.make_encoder(512, 512, cfg, np.uint16, "cpu",
                              entropy=entropy).bucket_coders == ("slim",)


def test_pinned_long_lane_references():
    """The 256x256 one-stage, one-segment entry of the pins chip_smoke.py
    holds the long-lane geometries to, recomputed with the JAX package's
    host codec."""
    with open(os.path.join(DATA, "golden_long_lanes.sha256")) as f:
        pins = dict(ln.split(None, 1)[::-1] for ln in f.read().splitlines())
    crop = np.ascontiguousarray(_boat()[128:384, 128:384])
    cfg = G.CodecConfig(1, 0, 1, None)
    stream = G.compress(crop, cfg)
    px = G.decompress(stream, cfg, dtype=np.uint16)
    assert np.array_equal(px, crop)
    assert pins["crop256 s1 g1 unlimited stream"] \
        == hashlib.sha256(stream).hexdigest()
    assert pins["crop256 s1 g1 unlimited decoded"] \
        == hashlib.sha256(np.ascontiguousarray(px, "<u2").tobytes()) \
        .hexdigest()


def test_unknown_entropy_backend_raises():
    with pytest.raises(ValueError, match="entropy"):
        T.make_encoder(32, 32, T.CodecConfig(1, 0, 1, None), np.uint8, "cpu",
                       entropy="fused")
