"""Port's DWT vs the JAX package's numpy path (exact, tolerance 0)."""

import numpy as np
import pytest
import torch

from icer_compression_tpu.ops import wavelet as JW
from icer_compression_tpu_torch.ops import wavelet as TW


def _image(rng, h, w, mag_bits):
    hi = 256 if mag_bits == 7 else 4096
    return rng.integers(0, hi, (h, w)).astype(np.int32)


@pytest.mark.parametrize("filt", range(7))
@pytest.mark.parametrize("mag_bits", [7, 15])
def test_forward_inverse_match(filt, mag_bits):
    rng = np.random.default_rng(100 + 10 * filt + mag_bits)
    for (h, w), stages in (((24, 30), 1), ((37, 29), 2), ((51, 46), 3),
                           ((49, 67), 4)):
        img = _image(rng, h, w, mag_bits)
        ref, ref_ov = JW.forward_stages(img, stages, filt, mag_bits)
        out, ov = TW.forward_stages(torch.from_numpy(img), stages, filt,
                                    mag_bits)
        assert np.array_equal(out.numpy(), np.asarray(ref))
        assert bool(ov) == bool(ref_ov)
        # inverse of the forward output, and of raw noise (wraps and
        # overflow flags, including the uint8 odd-length skew)
        for src in (np.asarray(ref, np.int32),
                    rng.integers(-(1 << mag_bits), 1 << mag_bits,
                                 (h, w)).astype(np.int32)):
            iref, iref_ov = JW.inverse_stages(src, stages, filt, mag_bits)
            iout, iov = TW.inverse_stages(torch.from_numpy(src), stages,
                                          filt, mag_bits)
            assert np.array_equal(iout.numpy(), np.asarray(iref))
            assert bool(iov) == bool(iref_ov)


def test_overflow_flag_and_batch_axis():
    rng = np.random.default_rng(7)
    img = rng.integers(0, 256, (3, 33, 40)).astype(np.int32)
    img[1, 0, 0] = 255
    img[1, 0, 1] = -255          # pair difference overflows int8
    out, ov = TW.forward_stages(torch.from_numpy(img), 2, 0, 7)
    for b in range(3):
        ref, ref_ov = JW.forward_stages(img[b], 2, 0, 7)
        assert np.array_equal(out[b].numpy(), np.asarray(ref))
    assert bool(ov)


def test_sign_magnitude_roundtrip():
    rng = np.random.default_rng(3)
    for mag_bits in (7, 15):
        v = rng.integers(-(1 << mag_bits), 1 << mag_bits, 500).astype(
            np.int32)
        sm = TW.to_sign_magnitude(torch.from_numpy(v), mag_bits)
        assert np.array_equal(sm.numpy(),
                              np.asarray(JW.to_sign_magnitude(v, mag_bits)))
        back = TW.from_sign_magnitude(sm, mag_bits)
        assert np.array_equal(
            back.numpy(),
            np.asarray(JW.from_sign_magnitude(sm.numpy(), mag_bits)))
        assert np.array_equal(
            TW._wrap(torch.from_numpy(v * 3), mag_bits).numpy(),
            JW._wrap(v * 3, mag_bits, np))
