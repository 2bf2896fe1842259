"""Fault injection in the port (``utils/faults.py``) against the JAX
package's: the same faulted bytes, and decodes of truncated, corrupted,
header-flipped and segment-dropped streams equal to the JAX package's host
decoder, one at a time and as one batch; the port's versions of the JAX
package's containment, census and progressive-prefix tests; and the JAX
side of the phase-22 pins that chip_smoke.py holds the card to."""

import os
import sys

import numpy as np
import pytest

from conftest import make_test_image
from icer_compression_tpu.models import color as JC
from icer_compression_tpu.models import grayscale as G
from icer_compression_tpu.utils import faults as JF
from icer_compression_tpu_torch.models import color as TC
from icer_compression_tpu_torch.models import decode as TD
from icer_compression_tpu_torch.models import grayscale as T
from icer_compression_tpu_torch.utils import faults as F
from test_torch_entropy_slim import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")
H, W = 48, 40


def _gray(seed=0, segs=6, stages=2):
    img = make_test_image(H, W, np.random.default_rng(seed))
    cfg = (stages, 0, segs, None)
    return img, cfg, G.compress(img, G.CodecConfig(*cfg))


def _fault_cases(stream, faults):
    sys.path.insert(0, REPO)
    try:
        from chip_smoke import fault_cases
    finally:
        sys.path.remove(REPO)
    return fault_cases(stream, faults)


def _header(stream, k):
    """Byte range of the k-th segment header of a clean stream."""
    sizes = [28 + c[5] for c in JF.segment_census(stream)]
    return range(sum(sizes[:k]), sum(sizes[:k]) + 28)


# each fault kind, given the fault module and the stream
KINDS = {
    "truncate": lambda f, s: f.truncate(s, 0.6),
    "corrupt_random": lambda f, s: f.corrupt_random(s, 6, seed=6),
    "flip header": lambda f, s: f.flip_bytes(s, _header(s, 3) if s else []),
    "flip payload": lambda f, s: f.flip_bytes(s, [len(s) // 2], xor=0x5A),
    "drop segments": lambda f, s: f.drop_segments(
        s, lambda h: h.decomp_level == 1 and h.lsb in (0, 3)),
}


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_faults_give_the_jax_package_bytes(kind):
    _img, _cfg, stream = _gray()
    assert KINDS[kind](F, stream) == KINDS[kind](JF, stream)
    assert KINDS[kind](F, stream) != stream
    assert KINDS[kind](F, b"") == KINDS[kind](JF, b"") == b""


def test_phase_22_cases_give_the_jax_package_bytes():
    _img, _cfg, stream = _gray()
    mine, ref = _fault_cases(stream, F), _fault_cases(stream, JF)
    assert [label for label, _ in mine] == [label for label, _ in ref]
    for (label, a), (_l, b) in zip(mine, ref):
        assert a == b and a != stream, label
    assert F.segment_census(stream) == JF.segment_census(stream)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_faulted_decode_matches_jax_package(kind):
    img, cfg, stream = _gray(1)
    bad = KINDS[kind](F, stream)
    ref = G.decompress(bad, G.CodecConfig(*cfg), dtype=np.uint16)
    out = T.decompress(bad, T.CodecConfig(*cfg), np.uint16, device="cpu")
    assert np.array_equal(out, ref)
    assert not np.array_equal(out, img)


def test_faulted_batch_matches_jax_package():
    """Every phase-22 fault of one stream decoded as one batch: one plan
    meets truncated, corrupted and dropped packets at once."""
    _img, cfg, stream = _gray(2)
    cases = _fault_cases(stream, F)
    outs = TD.decompress_batch([b for _l, b in cases], T.CodecConfig(*cfg),
                               np.uint16, device="cpu")
    for (label, bad), out in zip(cases, outs):
        ref = G.decompress(bad, G.CodecConfig(*cfg), dtype=np.uint16)
        assert np.array_equal(out, ref), label


def test_reordered_and_duplicated_packets_match_jax_package():
    """Headers out of order, and a packet repeated with another image's
    payload for the same key (the last one in the stream wins)."""
    from icer_compression_tpu_torch.core.header import scan_bytestream
    _img, cfg, stream = _gray(7)
    _img2, _cfg2, other = _gray(8)
    segs = [h.pack(p) for h, p in scan_bytestream(stream)]
    alien = [h.pack(p) for h, p in scan_bytestream(other)]
    streams = [b"".join(segs[::-1]), b"".join(segs + alien[40:45])]
    outs = TD.decompress_batch(streams, T.CodecConfig(*cfg), np.uint16,
                               device="cpu")
    for bad, out in zip(streams, outs):
        ref = G.decompress(bad, G.CodecConfig(*cfg), dtype=np.uint16)
        assert np.array_equal(out, ref)
    assert not np.array_equal(outs[0], outs[1])


def test_faulted_colour_matches_jax_package():
    rng = np.random.default_rng(3)
    planes = [make_test_image(H, W, rng) for _ in range(3)]
    cfg = (2, 0, 6, None)
    stream = JC.compress_yuv(*planes, G.CodecConfig(*cfg))
    bads = [F.corrupt_random(stream, 16, seed=16), F.truncate(stream, 0.7)]
    outs = TD.decompress_yuv_batch(bads, T.CodecConfig(*cfg), np.uint16,
                                   device="cpu")
    for bad, batch in zip(bads, outs):
        ref = JC.decompress_yuv(bad, G.CodecConfig(*cfg), dtype=np.uint16)
        one = TC.decompress_yuv(bad, T.CodecConfig(*cfg), np.uint16,
                                device="cpu")
        for a, b, c in zip(one, batch, ref):
            assert np.array_equal(a, c) and np.array_equal(b, c)


def test_drop_one_segment_contains_damage():
    img, cfg, stream = _gray(4, segs=4)
    cut = F.drop_segments(
        stream, lambda h: h.segment_number == 0 and h.decomp_level == 1
        and h.subband_type == 3)
    dec = T.decompress(cut, T.CodecConfig(*cfg), np.uint16, device="cpu")
    full = T.decompress(stream, T.CodecConfig(*cfg), np.uint16, device="cpu")
    assert dec.shape == full.shape
    assert 0 < np.abs(dec.astype(int) - full.astype(int)).mean() < 16


def test_census_counts():
    _img, _cfg, stream = _gray(5, segs=3)
    census = F.segment_census(stream)
    # 9 bitplanes x 3 segments x (3 subbands x 2 stages + LL)
    assert len(census) == 9 * 3 * 7
    assert census == JF.segment_census(stream)


def test_progressive_prefixes_monotone():
    img, cfg, stream = _gray(6)
    fracs = (0.2, 0.5, 0.9, 1.0)
    decs = TD.decompress_batch([F.truncate(stream, f) for f in fracs],
                               T.CodecConfig(*cfg), np.uint16, device="cpu")
    errs = [np.abs(d.astype(int) - img.astype(int)).mean() for d in decs]
    assert all(b <= a + 1e-9 for a, b in zip(errs, errs[1:]))
    assert errs[-1] == 0  # the full stream is lossless


def test_pinned_fault_references():
    """tests/data/golden_faults.sha256 recomputed with the JAX package
    (scripts/pin_faults.py), and its boat stream is the golden one."""
    import hashlib
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        import pin_faults
    finally:
        sys.path.remove(os.path.join(REPO, "scripts"))
    with open(os.path.join(DATA, "golden_faults.sha256")) as f:
        pinned = [tuple(ln.split(None, 1)) for ln in f.read().splitlines()]
    assert [(s, label) for s, label in pinned] == pin_faults.pins()
    assert len(pinned) == 2 * (2 * 11 + 1)
    from icer_compression_tpu_torch.utils.image_io import read_png
    boat = read_png(os.path.join(DATA, "boat.512.png")).astype(np.uint16)
    with open(os.path.join(DATA, "golden_boat512.sha256")) as f:
        golden = f.read().split()[0]
    stream = G.compress(boat, G.CodecConfig(4, 0, 6, 512 * 512))
    assert hashlib.sha256(stream).hexdigest() == golden
