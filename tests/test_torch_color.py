"""The port's colour (YUV) codec vs the JAX package: streams byte for byte,
decodes pixel for pixel (exact), on the CPU through the kernels' plain
versions; and the port's copy of the colour-space conversion."""

import os
import sys

import numpy as np
import pytest

from conftest import make_test_image
from icer_compression_tpu.core.header import scan_bytestream
from icer_compression_tpu.models import color as CL
from icer_compression_tpu.models.grayscale import CodecConfig
from icer_compression_tpu.utils import colorspace as JC
from icer_compression_tpu_torch.core.status import IcerError, IcerStatus
from icer_compression_tpu_torch.models import color as TC
from icer_compression_tpu_torch.models import grayscale as T
from icer_compression_tpu_torch.utils import colorspace as TCS
from test_torch_entropy_slim import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _planes(seed=12345, h=40, w=48):
    """The JAX package's colour test planes (tests/test_codec_color.py)."""
    rng = np.random.default_rng(seed)
    rgb = (np.add.outer(np.arange(h) * 2, np.arange(w))[..., None] % 160
           + rng.integers(0, 60, (h, w, 3))).astype(np.uint8)
    return JC.rgb_to_ycbcr(rgb)


def _same_planes(a, b):
    return len(a) == len(b) == 3 and all(
        np.asarray(x).dtype == np.asarray(y).dtype
        and np.array_equal(x, y) for x, y in zip(a, b))


# the four uint16 cases of tests/test_codec_color.py: (filter, stages,
# segments, share of the raw size as quota), and its uint8 case
CASES = [(np.uint16, 0, 2, 3, 1.0), (np.uint16, 0, 2, 3, 0.3),
         (np.uint16, 1, 3, 2, 1.0), (np.uint16, 2, 2, 5, 1.0),
         (np.uint8, 0, 2, 3, 1.0)]


@pytest.mark.parametrize("case", range(len(CASES)))
def test_compress_and_decompress_yuv_match_jax_package(case):
    dtype, filt, stages, segs, share = CASES[case]
    y, u, v = _planes()
    if dtype == np.uint8:
        planes = [(c // 3).astype(np.uint8) for c in (y, u, v)]
    else:
        planes = [c.astype(np.uint16) for c in (y, u, v)]
    quota = int(y.size * 3 * share)
    ref = CL.compress_yuv(*planes, CodecConfig(stages, filt, segs, quota))
    tcfg = T.CodecConfig(stages, filt, segs, quota)
    out = TC.compress_yuv(*planes, tcfg, device="cpu")
    assert out == ref
    dec = TC.decompress_yuv(out, tcfg, dtype, device="cpu")
    assert _same_planes(dec, CL.decompress_yuv(
        ref, CodecConfig(stages, filt, segs, quota), dtype=dtype))


def test_full_range_uint8_colour_overflows_like_jax_package():
    y, u, v = (c.astype(np.uint8) for c in _planes())
    cfg = T.CodecConfig(2, 0, 3, 10000)
    with pytest.raises(IcerError) as ei:
        TC.compress_yuv(y, u, v, cfg, device="cpu")
    assert ei.value.status == IcerStatus.INTEGER_OVERFLOW


@pytest.mark.parametrize("bad", ["shape", "dtype", "kind"])
def test_channel_and_dtype_checks_raise_invalid_input(bad):
    y, u, v = (c.astype(np.uint16) for c in _planes())
    if bad == "shape":
        v = v[:, :-1]
    elif bad == "dtype":
        v = v.astype(np.uint8)
    else:
        y, u, v = (c.astype(np.int32) for c in (y, u, v))
    with pytest.raises(IcerError) as ei:
        TC.compress_yuv(y, u, v, T.CodecConfig(2, 0, 3, None), device="cpu")
    assert ei.value.status == IcerStatus.INVALID_INPUT


def test_compress_yuv_batch_matches_single():
    """The JAX package's test_compress_yuv_batch_matches_single, on the
    port: 3B channel canvases in one encode equal compress_yuv per image,
    lossless and truncated."""
    rng = np.random.default_rng(12345)
    h, w, B = 40, 32, 2
    ys = [make_test_image(h, w, rng) for _ in range(B)]
    us = [make_test_image(h, w, rng, amplitude=120) for _ in range(B)]
    vs = [make_test_image(h, w, rng, amplitude=90) for _ in range(B)]
    for quota in (h * w * 6, 900):
        cfg = T.CodecConfig(2, 0, 2, quota)
        streams = TC.compress_yuv_batch(ys, us, vs, cfg, device="cpu")
        for i in range(B):
            want = TC.compress_yuv(ys[i], us[i], vs[i], cfg, device="cpu")
            assert streams[i] == want, (quota, i)
            assert want == CL.compress_yuv(
                ys[i], us[i], vs[i], CodecConfig(2, 0, 2, quota))


def test_channel_cut_by_the_quota_decodes_with_mean_zero():
    """At 200 bytes the quota keeps no segment of V (channel 2): the
    decode matches the JAX package's, V all zeros (LL mean 0)."""
    y, u, v = (c.astype(np.uint16) for c in _planes())
    cfg = T.CodecConfig(2, 0, 3, 200)
    stream = TC.compress_yuv(y, u, v, cfg, device="cpu")
    chans = [hdr.channel for hdr, _p in scan_bytestream(stream)]
    assert chans.count(0) > 0 and chans.count(1) > 0 and chans.count(2) == 0
    dec = TC.decompress_yuv(stream, cfg, np.uint16, device="cpu")
    assert _same_planes(dec, CL.decompress_yuv(
        stream, CodecConfig(2, 0, 3, 200), dtype=np.uint16))
    assert not dec[2].any()


def test_decompress_yuv_max_pixels():
    y, u, v = (c.astype(np.uint16) for c in _planes())
    cfg = T.CodecConfig(2, 0, 3, None)
    stream = TC.compress_yuv(y, u, v, cfg, device="cpu")
    with pytest.raises(IcerError, match="max_pixels=1000") as ei:
        TC.decompress_yuv(stream, cfg, np.uint16, device="cpu",
                          max_pixels=1000)
    assert ei.value.status == IcerStatus.INVALID_INPUT
    assert _same_planes(TC.decompress_yuv(stream, cfg, np.uint16,
                                          device="cpu", max_pixels=40 * 48),
                        (y, u, v))


def test_yuv_quota_classes_match_jax_package():
    for w, h, stages, bitplanes in ((48, 40, 2, 9), (512, 512, 4, 9),
                                    (64, 64, 3, 7)):
        assert TC.yuv_quota_classes(w, h, stages, bitplanes) \
            == CL._yuv_quota_classes(w, h, stages, bitplanes)


def test_colorspace_matches_jax_package():
    rng = np.random.default_rng(2024)
    corners = np.array([[r, g, b] for r in (0, 255) for g in (0, 255)
                        for b in (0, 255)], np.uint8)
    rgb = np.concatenate([rng.integers(0, 256, (1 << 20, 3)).astype(np.uint8),
                          corners]).reshape(-1, 1, 3)
    want = JC.rgb_to_ycbcr(rgb)
    got = TCS.rgb_to_ycbcr(rgb)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    back = TCS.ycbcr_to_rgb(*got)
    assert back.dtype == np.uint8
    assert np.array_equal(back, JC.ycbcr_to_rgb(*want))
    # and on the corners of the YCbCr cube
    ycc = [np.asarray(c).reshape(-1, 1) for c in corners.T]
    assert np.array_equal(TCS.ycbcr_to_rgb(*ycc), JC.ycbcr_to_rgb(*ycc))


def test_pinned_colour_references():
    """The pins chip_smoke.py holds the colour path to, recomputed with the
    JAX package by scripts/pin_color512.py."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import pin_color512
    with open(os.path.join(REPO, "tests", "data",
                           "golden_color512.sha256")) as f:
        lines = [ln.split(None, 1) for ln in f.read().splitlines()]
    assert [(sha, label) for sha, label in lines] == pin_color512.pins()
    assert len(lines) == 6


def test_colour_pins_cover_a_lossless_decode():
    """The unlimited pins' decoded planes are the input planes."""
    sys.path.insert(0, REPO)
    import chip_smoke
    from icer_compression_tpu_torch.utils.image_io import read_png
    rgb = chip_smoke.color_boat(read_png(os.path.join(
        REPO, "tests", "data", "boat.512.png")))
    with open(os.path.join(REPO, "tests", "data",
                           "golden_color512.sha256")) as f:
        pins = [ln.split()[0] for ln in f.read().splitlines()]
    for i, (_label, dtype, quota) in enumerate(chip_smoke.COLOR_PINS):
        if quota is None:
            planes = chip_smoke.color_planes(rgb, dtype)
            assert chip_smoke.planes_sha(planes) == pins[2 * i + 1]


def test_compress_yuv_long_lanes_match_jax_package():
    """256x256 planes at one stage and one segment: every channel's lanes
    have 32,768 emission slots, past the fused-key limit, so kernel 1 runs
    in its two-word mode; the stream equals the JAX package's."""
    y, u, v = (c.astype(np.uint16) for c in _planes(h=256, w=256))
    assert TC.compress_yuv(y, u, v, T.CodecConfig(1, 0, 1, None),
                           device="cpu") \
        == CL.compress_yuv(y, u, v, CodecConfig(1, 0, 1, None))


def test_colour_entry_points_need_cuda_or_an_explicit_cpu():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from icer_compression_tpu_torch.models import decode as TD
    y, u, v = (c.astype(np.uint16) for c in _planes(h=24, w=24))
    cfg = T.CodecConfig(1, 0, 1, None)
    stream = TC.compress_yuv(y, u, v, cfg, device="cpu")
    for call in (lambda: TC.compress_yuv(y, u, v, cfg),
                 lambda: TC.compress_yuv_batch([y], [u], [v], cfg),
                 lambda: TC.decompress_yuv(stream, cfg),
                 lambda: TD.decompress_yuv_batch([stream], cfg)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
