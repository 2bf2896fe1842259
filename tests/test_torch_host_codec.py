"""The port's host codec (``backend="native"`` / ``"numpy"`` /
``"python"`` of ``compress``, ``decompress``, ``compress_yuv`` and
``decompress_yuv``) against the JAX package's host codec: streams byte
for byte, decodes pixel for pixel, on seeded 40x48 images, and the
quota-aware tranche allocator on boat 512 (the only size here whose
packets need several doubling tranches at a quota)."""

import hashlib
import os

import numpy as np
import pytest
import torch

from conftest import make_test_image
from icer_compression_tpu.models import color as JC
from icer_compression_tpu.models import grayscale as G
from icer_compression_tpu_torch.backend import native_backend as NB
from icer_compression_tpu_torch.core import constants as TCN
from icer_compression_tpu_torch.core.packets import (build_packets_grayscale,
                                                     sort_packets)
from icer_compression_tpu_torch.core.partition import partition_segments
from icer_compression_tpu_torch.core.subbands import subband_view
from icer_compression_tpu_torch.models import color as TC
from icer_compression_tpu_torch.models import decode as TD
from icer_compression_tpu_torch.models import grayscale as T
from icer_compression_tpu_torch.ops import plane_decode as TPD
from icer_compression_tpu_torch.utils import faults
from test_torch_entropy_slim import one_torch_thread  # noqa: F401

DATA = os.path.join(os.path.dirname(__file__), "data")
H, W = 40, 48


def _image(dtype, seed, amplitude=100):
    rng = np.random.default_rng(seed)
    return make_test_image(H, W, rng, dtype=dtype, amplitude=amplitude,
                           noise=24)


def _mid_plane_quota(img, config):
    """(quota, packet, segment): a quota whose allocation stops at a
    segment that is not its packet's first (the stop inside a plane,
    icer_partition.c:323-326), from the port's native payload table of
    the image."""
    mag_bits = T._mag_bits(img.dtype)
    bitplanes = T._bitplanes(mag_bits)
    img_t, ll_mean = T.transform_for_encode(img, config.stages, config.filt,
                                            mag_bits, native=True)
    table = T.encode_channel_native(img_t, config, mag_bits, bitplanes)
    used, seen = 0, 0
    for pkt in sort_packets(build_packets_grayscale(
            W, H, config.stages, ll_mean, bitplanes)):
        view = subband_view(W, H, pkt.decomp_level, pkt.subband_type)
        for rect in partition_segments(view.w, view.h, config.segments):
            nbits = table[(pkt.decomp_level, pkt.subband_type, pkt.lsb,
                           rect.index)][1]
            seen += 1
            if rect.index > 0 and nbits > 8 and seen > 40:
                return (used + TCN.HEADER_SIZE + (nbits + 7) // 8 - 1,
                        (pkt.decomp_level, pkt.subband_type, pkt.lsb),
                        rect.index)
            used += TCN.HEADER_SIZE + (nbits + 7) // 8
    raise AssertionError("no mid-plane stop")


# (dtype, quota): None is lossless, "mid" a stop inside a plane
QUOTAS = [(np.uint16, None), (np.uint8, 50000), (np.uint16, 5000),
          (np.uint8, "mid")]


@pytest.mark.parametrize("backend", ["native", "numpy"])
@pytest.mark.parametrize("case", range(len(QUOTAS)))
def test_compress_host_backends_match_jax(case, backend):
    dtype, quota = QUOTAS[case]
    img = _image(dtype, 40 + case)
    cfg = T.CodecConfig(4, 0, 6, None)
    if quota == "mid":
        quota, stop_packet, stop_seg = _mid_plane_quota(img, cfg)
    cfg.byte_quota = quota
    jcfg = G.CodecConfig(4, 0, 6, quota)
    ref = G.compress(img, jcfg, backend="native")
    out = T.compress(img, cfg, backend=backend)
    assert out == ref
    if backend == "numpy":
        assert ref == G.compress(img, jcfg,
                                 encode_plane=G.encode_plane_payload,
                                 backend="vectorized")
    if QUOTAS[case][1] == "mid":
        # the packet where coding stopped kept its first stop_seg segments
        from icer_compression_tpu_torch.core.header import scan_bytestream
        kept = sorted(h.segment_number for h, _p in scan_bytestream(out)
                      if (h.decomp_level, h.subband_type, h.lsb)
                      == stop_packet)
        assert kept == list(range(stop_seg)) and len(out) <= quota


@pytest.fixture(scope="module")
def boat():
    from PIL import Image
    return np.asarray(Image.open(os.path.join(DATA, "boat.512.png"))
                      .convert("L")).astype(np.uint16)


@pytest.mark.parametrize("quota", [None, 50000, 20000, 5000])
def test_tranche_allocator_on_boat(boat, quota, monkeypatch):
    """Boat 512 through the native tranche allocator: lossless hashes to
    the golden stream, quota 50,000 to its pin, and every quota equals the
    JAX package's native encode; a quota takes several tranches, each
    twice the last."""
    calls = []
    encode = NB.encode_segments_native

    def counted(image, tasks, nplanes, nthreads=0):
        calls.append(len(tasks))
        return encode(image, tasks, nplanes, nthreads)

    monkeypatch.setattr(NB, "encode_segments_native", counted)
    out = T.compress(boat, T.CodecConfig(4, 0, 6, quota), backend="native")
    assert out == G.compress(boat, G.CodecConfig(4, 0, 6, quota),
                             backend="native")
    sha = hashlib.sha256(out).hexdigest()
    if quota is None:
        with open(os.path.join(DATA, "golden_boat512.sha256")) as f:
            assert sha == f.read().split()[0]
        assert len(calls) == 1
    else:
        assert len(calls) >= 2 and calls[1] == 2 * calls[0]
    if quota == 50000:
        with open(os.path.join(DATA, "golden_boat512_q50000.sha256")) as f:
            assert sha == f.read().split()[0]


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_transform_and_channel_table_match_jax(dtype):
    img = _image(dtype, 3)
    cfg = T.CodecConfig(3, 2, 5, None)
    mag_bits = T._mag_bits(dtype)
    ref, ref_mean = G.transform_for_encode(img, 3, 2, mag_bits)
    for native in (False, True):
        got, mean = T.transform_for_encode(img, 3, 2, mag_bits,
                                           native=native)
        assert mean == ref_mean and np.array_equal(got, ref)
    bitplanes = T._bitplanes(mag_bits)
    assert T.encode_channel_native(ref, cfg, mag_bits, bitplanes) \
        == G.encode_channel_native(ref, G.CodecConfig(3, 2, 5, None),
                                   mag_bits, bitplanes)
    assert T.all_subbands(3) == G.all_subbands(3)
    for native in (False, True):
        back = T.inverse_transform(ref, 3, 2, mag_bits, native=native)
        assert np.array_equal(back, G.inverse_transform(ref, 3, 2, mag_bits))


def _planes(dtype, seed):
    amp = 60 if dtype == np.uint8 else 100
    return [_image(dtype, seed + c, amplitude=amp) for c in range(3)]


@pytest.mark.parametrize("backend,quota", [("native", None),
                                           ("native", 9000),
                                           ("numpy", 9000)])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_compress_yuv_host_backends_match_jax(dtype, backend, quota):
    planes = _planes(dtype, 20)
    ref = JC.compress_yuv(*planes, G.CodecConfig(3, 1, 5, quota),
                          backend="native")
    out = TC.compress_yuv(*planes, T.CodecConfig(3, 1, 5, quota),
                          backend=backend)
    assert out == ref


def _over_reads(stream, cfg) -> int:
    """Plane decodes of the stream that read past their data_length (the
    plain kernel 2 over its plan)."""
    _w, _h, _ll, blob, units = TD.plan_batch([stream], cfg, np.uint16)
    over = 0
    for u in units:
        args = [torch.as_tensor(u[k])
                for k in ("offs", "ebits", "lane_end", "geom")]
        _o, _e, pos = TPD.decode_planes(torch.as_tensor(blob), *args,
                                        u["hmax"], u["wmax"], 8, 15)
        over += int((pos.numpy() > u["ebits"]).sum())
    return over


def _gray_streams():
    """(name, stream, config): lossless, truncated, content past the 9
    coded bitplanes whose decodes read into the following packets, and
    that at a quota with random bytes corrupted."""
    img = _image(np.uint16, 11)
    noise = np.random.default_rng(1024).integers(0, 1024, (H, W)) \
        .astype(np.uint16)
    loud = np.random.default_rng(4096).integers(0, 4096, (H, W)) \
        .astype(np.uint16)
    out = []
    for name, im, cfg in (("lossless", img, G.CodecConfig(3, 0, 4, None)),
                          ("quota", img, G.CodecConfig(3, 0, 4, 2000)),
                          ("over-read", noise, G.CodecConfig(3, 0, 4, None)),
                          ("faulted", loud, G.CodecConfig(3, 0, 4, 576))):
        s = G.compress(im, cfg)
        if name == "faulted":
            s = faults.corrupt_random(s, 4, 0)
        out.append((name, s, cfg))
    return out


@pytest.mark.parametrize("backend", ["native", "python"])
def test_decompress_host_backends_match_jax(backend):
    for name, stream, jcfg in _gray_streams():
        cfg = T.CodecConfig(jcfg.stages, jcfg.filt, jcfg.segments,
                            jcfg.byte_quota)
        ref = G.decompress(stream, jcfg, backend="native")
        assert np.array_equal(ref, G.decompress(stream, jcfg,
                                                backend="python"))
        out = T.decompress(stream, cfg, backend=backend)
        assert out.dtype == ref.dtype and np.array_equal(out, ref), name
        if name == "over-read" and backend == "native":
            assert _over_reads(stream, cfg) > 0


@pytest.mark.parametrize("backend", ["native", "python"])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_decompress_yuv_host_backends_match_jax(dtype, backend):
    planes = _planes(dtype, 30)
    loud = [np.random.default_rng(c).integers(0, 4096, (H, W))
            .astype(np.uint16) for c in range(3)]
    cases = [(planes, G.CodecConfig(3, 1, 5, None)),
             (planes, G.CodecConfig(3, 1, 5, 4000))]
    if dtype == np.uint16:
        cases.append((loud, G.CodecConfig(3, 1, 5, 1800)))
    for chans, jcfg in cases:
        stream = JC.compress_yuv(*chans, jcfg)
        cfg = T.CodecConfig(jcfg.stages, jcfg.filt, jcfg.segments,
                            jcfg.byte_quota)
        ref = JC.decompress_yuv(stream, jcfg, dtype=dtype)
        out = TC.decompress_yuv(stream, cfg, dtype=dtype, backend=backend)
        for a, b in zip(out, ref):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        if jcfg.byte_quota is None:
            assert all(np.array_equal(a, c) for a, c in zip(out, chans))


def test_encode_and_decode_hooks():
    """A custom ``encode_plane`` runs the per-plane path and a custom
    ``decode_partition`` the segment loop, once per segment plane and
    segment, as in the JAX package; a hook with another backend is an
    error."""
    img = _image(np.uint8, 5)
    cfg = T.CodecConfig(2, 0, 3, 3000)
    calls = {"enc": 0, "dec": 0}

    def enc(seg, sb, lsb, mag_bits):
        calls["enc"] += 1
        return T.encode_plane_payload_sequential(seg, sb, lsb, mag_bits)

    def dec(seg, sb, mag_bits, planes, bitplanes):
        from icer_compression_tpu_torch.backend.decode_plane import \
            decode_segment_planes
        calls["dec"] += 1
        assert all(isinstance(p, memoryview) for p, _n in planes.values())
        decode_segment_planes(seg, sb, mag_bits, planes, bitplanes)

    stream = T.compress(img, cfg, encode_plane=enc)
    assert stream == G.compress(img, G.CodecConfig(2, 0, 3, 3000))
    assert calls["enc"] > 0
    out = T.decompress(stream, cfg, dtype=np.uint8, decode_partition=dec)
    assert np.array_equal(out, G.decompress(
        stream, G.CodecConfig(2, 0, 3, 3000), dtype=np.uint8))
    assert calls["dec"] == 7 * 3
    planes = _planes(np.uint8, 8)
    assert TC.compress_yuv(*planes, cfg, encode_plane=enc) \
        == JC.compress_yuv(*planes, G.CodecConfig(2, 0, 3, 3000))
    for bad in (lambda: T.compress(img, cfg, encode_plane=enc,
                                   backend="native"),
                lambda: T.decompress(stream, cfg, decode_partition=dec,
                                     backend="device"),
                lambda: T.compress(img, cfg, backend="auto"),
                lambda: TC.decompress_yuv(stream, cfg, backend="numpy")):
        with pytest.raises(ValueError):
            bad()


def test_native_raises_when_its_build_fails(tmp_path, monkeypatch):
    """No fallback: with a runtime that does not build, every native entry
    point raises; the numpy and python paths do not need the runtime."""
    img = _image(np.uint16, 6)
    cfg = T.CodecConfig(2, 0, 3, 2000)
    stream = G.compress(img, G.CodecConfig(2, 0, 3, 2000))
    src = tmp_path / "icer_runtime.cpp"
    src.write_text("int broken( {\n")
    monkeypatch.setattr(NB, "SRC", src)
    monkeypatch.setattr(NB, "BUILD", tmp_path / "build")
    monkeypatch.setattr(NB, "_lib", None)
    planes = [img, img, img]
    for call in (lambda: T.compress(img, cfg, backend="native"),
                 lambda: T.decompress(stream, cfg, backend="native"),
                 lambda: TC.compress_yuv(*planes, cfg, backend="native"),
                 lambda: TC.decompress_yuv(stream, cfg, backend="native")):
        with pytest.raises(RuntimeError, match="native runtime build failed"):
            call()
    assert T.compress(img, cfg, backend="numpy") == stream
    assert np.array_equal(T.decompress(stream, cfg, backend="python"),
                          G.decompress(stream, G.CodecConfig(2, 0, 3, 2000)))
