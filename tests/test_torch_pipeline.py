"""Deferred (pipelined) batches of the port on the CPU: ``defer``
collectors of the encoder and the decoders equal the synchronous calls,
the uint8 and uint16 uploads give the same streams, ``pack8`` and
``max_pixels`` behave as in the JAX package (exact)."""

import numpy as np
import pytest
import torch

from conftest import make_test_image
from icer_compression_tpu.models import color as CL
from icer_compression_tpu.models import grayscale as G
from icer_compression_tpu_torch import device as TDEV
from icer_compression_tpu_torch.core.status import IcerError, IcerStatus
from icer_compression_tpu_torch.models import color as TC
from icer_compression_tpu_torch.models import decode as TD
from icer_compression_tpu_torch.models import grayscale as T
from test_torch_entropy_slim import one_torch_thread  # noqa: F401

H, W = 40, 32
CFG = T.CodecConfig(2, 0, 4, None)


def _batches(k=3, b=2, dtype=np.uint16):
    rng = np.random.default_rng(77)
    return [np.stack([make_test_image(H, W, rng, dtype=dtype, amplitude=120,
                                      noise=30) for _ in range(b)])
            for _ in range(k)]


def test_deferred_encode_and_decode_equal_the_synchronous_calls():
    """K = 3 collectors open at once, collected out of order."""
    batches = _batches()
    enc = T.make_encoder(W, H, CFG, np.uint16, "cpu")
    want = [enc.encode_batch(b) for b in batches]
    holds = [enc.encode_batch(b, defer=True) for b in batches]
    got = {i: holds[i]() for i in (2, 0, 1)}
    assert [got[i] for i in range(3)] == want
    streams = [T.allocate_streams(r, CFG, enc) for r in want]
    for s, b in zip(streams, batches):
        assert s == [G.compress(img, G.CodecConfig(2, 0, 4, None))
                     for img in b]
    want_px = [TD.decompress_batch(s, CFG, np.uint16, device="cpu")
               for s in streams]
    holds = [TD.decompress_batch(s, CFG, np.uint16, device="cpu", defer=True)
             for s in streams]
    got_px = {i: holds[i]() for i in (1, 2, 0)}
    for i, (px, b) in enumerate(zip(want_px, batches)):
        assert all(np.array_equal(a, c) and np.array_equal(a, d)
                   and a.dtype == np.uint16
                   for a, c, d in zip(got_px[i], px, b))


def test_deferred_colour_batches_equal_the_synchronous_calls():
    rng = np.random.default_rng(5)
    planes = [[make_test_image(H, W, rng, amplitude=a) for _ in range(2)]
              for a in (200, 120, 90)]
    cfg = T.CodecConfig(2, 0, 2, 2000)
    want = TC.compress_yuv_batch(*planes, cfg, device="cpu")
    hold = TC.compress_yuv_batch(*planes, cfg, device="cpu", defer=True)
    assert hold() == want
    want_px = TD.decompress_yuv_batch(want, cfg, np.uint16, device="cpu")
    hold = TD.decompress_yuv_batch(want, cfg, np.uint16, device="cpu",
                                   defer=True)
    got = hold()
    assert len(got) == 2 and all(len(t) == 3 for t in got)
    for g, w, s in zip(got, want_px, want):
        assert all(np.array_equal(a, b) for a, b in zip(g, w))
        ref = CL.decompress_yuv(s, G.CodecConfig(2, 0, 2, 2000),
                                dtype=np.uint16)
        assert all(np.array_equal(a, b) for a, b in zip(g, ref))


def test_overflow_raises_from_the_collector():
    """The dispatch half does not wait for the card, so a wavelet overflow
    raises where the results are collected, as in the JAX encoder."""
    img = np.zeros((1, H, W), np.uint8)
    img[0, ::2] = 255
    enc = T.make_encoder(W, H, CFG, np.uint8, "cpu")
    hold = enc.encode_batch(img, defer=True)
    with pytest.raises(IcerError) as ei:
        hold()
    assert ei.value.status == IcerStatus.INTEGER_OVERFLOW
    with pytest.raises(IcerError):
        enc.encode_batch(img)


def test_device_passes_give_the_same_tables():
    """A batch split into device passes (here one image each) gives the
    tables of one pass, deferred or not."""
    batch = _batches(k=1, b=3)[0]
    enc = T.make_encoder(W, H, CFG, np.uint16, "cpu")
    assert enc.pass_images >= 3
    want = enc.encode_batch(batch)
    enc.pass_images = 1
    assert enc.encode_batch(batch) == want
    assert enc.encode_batch(batch, defer=True)() == want


def test_uint8_and_uint16_uploads_give_the_same_streams():
    """8-bit values go up as uint8, wider ones as uint16; both widen to the
    images' values, so the streams equal those of an int32 upload."""
    imgs = _batches(k=1, b=2)[0]            # uint16 values below 256
    wide = imgs * 150                       # past 8 bits: uint16 upload
    assert imgs.max() < 256 < wide.max()
    enc = T.make_encoder(W, H, CFG, np.uint16, "cpu")
    for batch in (imgs, wide):
        x = enc._upload(batch)
        assert x.dtype == torch.int32
        assert torch.equal(x, torch.as_tensor(batch.astype(np.int32)))
        assert enc.encode_batch(batch) == enc.encode_batch(
            batch.astype(np.int32))


def test_uploads_widen_to_the_images_values():
    enc = T.make_encoder(W, H, CFG, np.uint16, "cpu")
    imgs = np.full((1, H, W), 65535, np.uint16)
    for batch in (imgs, imgs.astype(np.int32)):
        x = enc._upload(batch)
        assert x.dtype == torch.int32 and int(x.min()) == 65535


def test_pack8_gives_the_wide_result_past_a_byte():
    rng = np.random.default_rng(9)
    img = make_test_image(H, W, rng, amplitude=120, noise=30)
    img[3, 5] = 1000
    jcfg = G.CodecConfig(2, 0, 4, None)
    stream = T.compress(img, CFG, device="cpu")
    ref = G.decompress(stream, jcfg)
    assert ref.max() > 255
    for pack8 in (None, False, True):
        out = T.decompress(stream, CFG, np.uint16, device="cpu", pack8=pack8)
        assert out.dtype == np.uint16 and np.array_equal(out, ref)
    small = np.clip(img, 0, 255)
    s2 = T.compress(small, CFG, device="cpu")
    ref2 = G.decompress(s2, jcfg)
    assert ref2.max() <= 255
    out = TD.decompress_batch([s2, stream], CFG, np.uint16, device="cpu",
                              pack8=True)
    assert np.array_equal(out[0], ref2) and np.array_equal(out[1], ref)
    out = T.decompress(s2, CFG, np.uint16, device="cpu", pack8=True)
    assert out.dtype == np.uint16 and np.array_equal(out, ref2)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_the_pixels_come_back_once_at_the_callers_width(dtype, monkeypatch):
    """``narrow`` keeps the bits that NumPy's ``astype`` of the wide
    pixels keeps, past a byte and past 16 bits; ``device_pass`` returns one
    tensor, of the caller's width; ``decompress_batch`` equals the JAX
    package's decode whatever ``pack8`` says."""
    from icer_compression_tpu_torch.backend import graph_cache as GC
    mag_bits, narrow_dt = ((7, torch.uint8) if dtype == np.uint8
                           else (15, torch.int16))
    rng = np.random.default_rng(12)
    wide = np.concatenate([
        [0, 1, 255, 256, 1000, 32767, 32768, 65535, 65536, 70000,
         (1 << 20) - 1, 1 << 20],
        rng.integers(0, (1 << 20) + 1, 500)]).astype(np.int32)
    got = TD.narrow(torch.from_numpy(wide), mag_bits)
    assert got.dtype == narrow_dt
    assert np.array_equal(got.numpy().view(dtype), wide.astype(dtype))

    monkeypatch.setattr(GC, "CACHE", GC.GraphCache())
    # the uint8 path's transform holds 7 magnitude bits without overflow
    img = make_test_image(H, W, rng, dtype=dtype, amplitude=60, noise=20)
    if dtype == np.uint16:
        img[3, 5] = 1000
    stream = T.compress(img, CFG, device="cpu")
    ref = G.decompress(stream, G.CodecConfig(2, 0, 4, None), dtype=dtype)
    assert (ref.max() > 255) == (dtype == np.uint16)
    cpu = torch.device("cpu")
    w, h, ll, blob, units = TD.plan_batch([stream], CFG, dtype, pad=True)
    plan = TD.DecodePlan(w, h, ll, len(blob), units, CFG, dtype, 1, cpu)
    (px,) = plan.device_pass(TD._upload(blob, plan.meta(ll, units), cpu))
    assert px.dtype == narrow_dt and px.shape == (1, H, W)
    assert np.array_equal(px.numpy().view(dtype)[0], ref)
    for pack8 in (None, False, True):
        (out,) = TD.decompress_batch([stream], CFG, dtype, device="cpu",
                                     pack8=pack8)
        assert out.dtype == dtype and out.flags.c_contiguous
        assert np.array_equal(out, ref)


def test_max_pixels_bounds_the_decode():
    img = _batches(k=1, b=1)[0][0]
    stream = T.compress(img, CFG, device="cpu")
    for fn in (lambda mp: T.decompress(stream, CFG, device="cpu",
                                       max_pixels=mp),
               lambda mp: TD.decompress_batch([stream], CFG, device="cpu",
                                              max_pixels=mp, defer=True)):
        with pytest.raises(IcerError, match=f"{W}x{H} exceed "
                                            f"max_pixels={H * W - 1}") as ei:
            fn(H * W - 1)
        assert ei.value.status == IcerStatus.INVALID_INPUT
    out = T.decompress(stream, CFG, device="cpu", max_pixels=H * W)
    assert np.array_equal(out, img)
    assert TD.DEFAULT_MAX_PIXELS == G.DEFAULT_MAX_PIXELS


def test_grayscale_ignores_the_channel_nibble():
    """A colour stream decoded as grayscale: every channel's segments land
    in one table, the last in the stream winning, as in the JAX package."""
    rng = np.random.default_rng(3)
    planes = [make_test_image(H, W, rng, amplitude=a) for a in (200, 90, 60)]
    cfg = T.CodecConfig(2, 0, 4, 3000)
    stream = TC.compress_yuv(*planes, cfg, device="cpu")
    out = T.decompress(stream, cfg, np.uint16, device="cpu")
    assert np.array_equal(out, G.decompress(stream,
                                            G.CodecConfig(2, 0, 4, 3000)))


def test_host_copies_on_the_cpu_pass_through():
    a = np.arange(12, dtype=np.int32).reshape(3, 4)
    t = TDEV.to_device(a, torch.device("cpu"))
    assert t.device.type == "cpu" and np.array_equal(t.numpy(), a)
    assert TDEV.to_host(t) is t
    pending = TDEV.Pending(torch.device("cpu"), keep=(t,))
    assert pending.event is None
    pending.wait()
    assert pending.keep == ()
