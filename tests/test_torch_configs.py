"""The port's card path (on the CPU, through the kernels' plain versions)
at the filters, stage counts, segment counts and sample types beside the
CLI's defaults, against the JAX package's host codec: streams byte for
byte, decodes pixel for pixel, refusals by IcerStatus; and the
configuration pins of chip_smoke phase 26 (tests/data/golden_configs
.sha256, from scripts/pin_configs.py)."""

import os
import sys

import numpy as np
import pytest

from conftest import make_test_image
from icer_compression_tpu.core.status import IcerError as JaxIcerError
from icer_compression_tpu.models import color as JCL
from icer_compression_tpu.models import grayscale as G
from icer_compression_tpu_torch.core.status import IcerError
from icer_compression_tpu_torch.models import color as CL
from icer_compression_tpu_torch.models import grayscale as T
from test_torch_entropy_slim import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))

from chip_smoke import (FILTERS, config_sweep, error_sweep,  # noqa: E402
                        read_config_pins)

PINS = os.path.join(REPO, "tests", "data", "golden_configs.sha256")

# (h, w, dtype, filter, stages, segments, byte quota): every filter,
# stages 1, 3 and 6 (6 needs sides of 129 or more: an LL of 3 pixels),
# segments 1 to 32 (at most the smallest subband's pixels), uint8 and
# uint16; quotas truncate the stage-6 cases, whose lossless decode through
# the plain decoder takes half a minute
CASES = [
    (40, 48, np.uint16, 1, 1, 6, None),
    (96, 80, np.uint16, 2, 3, 32, None),
    (129, 132, np.uint16, 5, 6, 4, 2500),
    (130, 129, np.uint8, 3, 6, 4, 1200),
    (80, 96, np.uint8, 6, 3, 12, 1500),
    (48, 40, np.uint8, 4, 1, 1, None),
    (64, 72, np.uint16, 0, 3, 17, 3000),
    (72, 56, np.uint16, 3, 3, 32, None),
    (57, 61, np.uint16, 1, 3, 5, 1800),
]
COLOR = (40, 48, np.uint16, 2, 3, 5, None)


def _image(h, w, dtype, seed):
    rng = np.random.default_rng(seed)
    amp = 50 if np.dtype(dtype) == np.uint8 else 100
    return make_test_image(h, w, rng, dtype=dtype, amplitude=amp, noise=24)


def test_cases_cover_the_configuration_space():
    assert {c[3] for c in CASES + [COLOR]} == set(range(7))
    assert {1, 3, 6} <= {c[4] for c in CASES}
    assert {1, 32} <= {c[5] for c in CASES}
    assert {np.uint8, np.uint16} == {c[2] for c in CASES}


@pytest.mark.parametrize("case", range(len(CASES)))
def test_config_matches_jax_package(case):
    h, w, dtype, filt, stages, segs, quota = CASES[case]
    img = _image(h, w, dtype, case)
    ref = G.compress(img, G.CodecConfig(stages, filt, segs, quota))
    cfg = T.CodecConfig(stages, filt, segs, quota)
    out = T.compress(img, cfg, device="cpu")
    assert out == ref
    dec = T.decompress(out, cfg, dtype=dtype, device="cpu")
    want = G.decompress(ref, G.CodecConfig(stages, filt, segs, quota),
                        dtype=dtype)
    assert dec.dtype == want.dtype and np.array_equal(dec, want)


def test_color_config_matches_jax_package():
    h, w, dtype, filt, stages, segs, quota = COLOR
    planes = [_image(h, w, dtype, 20 + c) for c in range(3)]
    jcfg = G.CodecConfig(stages, filt, segs, quota)
    cfg = T.CodecConfig(stages, filt, segs, quota)
    ref = JCL.compress_yuv(*planes, jcfg)
    out = CL.compress_yuv(*planes, cfg, device="cpu")
    assert out == ref
    dec = CL.decompress_yuv(out, cfg, dtype=dtype, device="cpu")
    for a, b in zip(dec, JCL.decompress_yuv(ref, jcfg, dtype=dtype)):
        assert np.array_equal(a, b)


def _boat():
    from pin_configs import read_boat
    return read_boat()


def _error_cases():
    """``error_sweep``'s cases, boat's raw uint8 case on its 64x64 top-left
    crop (the card's encoder codes a whole pass before it reads the
    overflow flag; the plain coder takes ~20 s on 512x512)."""
    out = []
    for label, img, cfg in error_sweep(_boat()):
        if not isinstance(img, tuple) and img.shape == (512, 512):
            img = img[:64, :64]
        out.append((label, img, cfg))
    return out


@pytest.mark.parametrize("case", range(13))
def test_refusals_match_jax_package(case):
    """Each refusal by the JAX package's IcerStatus; uint8 colour at 5
    stages (a packet list past the reference's 300 entries) refuses a
    DWT overflow first, as the reference transforms before it builds the
    packet list (the port once checked the packet count first)."""
    label, img, cfg = _error_cases()[case]
    with pytest.raises(JaxIcerError) as want:
        if isinstance(img, tuple):
            JCL.compress_yuv(*img, G.CodecConfig(*cfg))
        else:
            G.compress(img, G.CodecConfig(*cfg))
    with pytest.raises(IcerError) as got:
        if isinstance(img, tuple):
            CL.compress_yuv(*img, T.CodecConfig(*cfg), device="cpu")
        else:
            T.compress(img, T.CodecConfig(*cfg), device="cpu")
    assert got.value.status.name == want.value.status.name, label
    _good, bad = read_config_pins(PINS)
    assert bad[label] == want.value.status.name


def test_pin_file_holds_the_sweep():
    """One line per configuration of ``config_sweep`` (32) and per case of
    ``error_sweep`` (13); the sweep takes every filter, stages 1-6,
    segments 1-32 and both sample types."""
    boat = _boat()
    good, bad = read_config_pins(PINS)
    sweep = config_sweep(boat)
    assert [s[0] for s in sweep] == list(good) and len(good) == 32
    assert [e[0] for e in error_sweep(boat)] == list(bad) and len(bad) == 13
    assert {FILTERS[c[3][1]] for c in sweep} == set(FILTERS)
    assert {c[3][0] for c in sweep} == {1, 2, 3, 4, 5, 6}
    assert {1, 2, 7, 16, 32} <= {c[3][2] for c in sweep}
    assert {np.dtype(c[2]).name for c in sweep} == {"uint8", "uint16"}
    assert sum(isinstance(c[1], tuple) for c in sweep) == 2


@pytest.mark.parametrize("label", ["boat512 u16 fB s4 g6 q50000",
                                   "boat512//2 u8 fE s4 g6 q30000"])
def test_pins_rederive_from_the_script(label):
    """Two of the 512x512 pins made again with the script's own function
    (the JAX package's host codec)."""
    from pin_configs import pin_config
    good, _bad = read_config_pins(PINS)
    (img, dtype, cfg), = [(i, d, c) for lab, i, d, c in config_sweep(_boat())
                          if lab == label]
    assert pin_config(img, dtype, cfg) == good[label]
