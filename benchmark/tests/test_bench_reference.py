"""The plain reference against lib_icer's pinned outputs and against the
one-lane sequential coder it steps many lanes of at once."""

import hashlib

import numpy as np
import pytest

from benchmark import frames
from benchmark.reference import codec as R
from benchmark.reference import lanes, sequential
from benchmark.reference.workers import Workers

# lib_icer's outputs for boat 512 at stages 4, filter A, 6 segments
# (the repository's tests/data/golden_boat512*.sha256)
LOSSLESS = "c149505d618462cc4557c3c86127f959aa90cf929b8cae73114c17633d6c4f7d"
Q50000 = "d2fa8bcab393181751846363f3b096a23f09e7838586a87303c2359fde961751"
Q50000_PIXELS = \
    "d6f37a4acdf23558f72d985b84a1fd6ee4deb3a71e1c64d2a5981ce10e80c693"


def _sha(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


def test_boat_lossless_and_quota_match_lib_icer():
    boat = frames.boat().astype(np.uint16)
    codec = R.Codec()
    (full,) = R.encode([boat], 512 * 512, codec)
    assert _sha(full["stream"]) == LOSSLESS
    assert np.array_equal(R.expected_pixels(
        full["coeffs"], full["ll_mean"], full["included"], codec), boat)
    with Workers(2) as pool:
        (q,) = R.encode([boat], 50000, codec, pool)
    assert _sha(q["stream"]) == Q50000
    px = R.expected_pixels(q["coeffs"], q["ll_mean"], q["included"], codec)
    assert _sha(px.astype("<u2").tobytes()) == Q50000_PIXELS


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_lanes_equal_the_sequential_coder(seed):
    rng = np.random.default_rng(seed)
    ctxs, bits = [], []
    for i in range(8):
        n = int(rng.integers(1, 6000))
        c = rng.integers(0, 18, n)
        b = (rng.random(n) < rng.uniform(0, 0.5)).astype(np.int64)
        if i == 0:             # one rare-zero context: the buffer fills
            c[:] = 3
            b = (rng.random(n) < 0.002).astype(np.int64)
        ctxs.append(c)
        bits.append(b)
    for (payload, nbits), c, b in zip(lanes.encode_lanes(ctxs, bits),
                                      ctxs, bits):
        want = sequential.encode_emissions(np.ones(len(c), int), c, b)
        assert (payload, nbits) == want[:2]


def test_a_small_window_forces_flushes_exactly():
    rng = np.random.default_rng(9)
    c = rng.integers(0, 18, 4000)
    b = (rng.random(4000) < 0.3).astype(np.int64)
    enc = sequential.InterleavedEncoder(buffer_length=16)
    counters = sequential.ContextCounters()
    for ci, bi in zip(c.tolist(), b.tolist()):
        if ci == sequential.CTX_UNCODED:
            enc.encode_bit(bi, 1, 2)
        else:
            enc.encode_bit(bi, counters.zero[ci], counters.total[ci])
            counters.update(ci, bi)
    enc.flush()
    assert enc.flush_events > 0
    assert lanes.encode_lanes([c], [b], buffer_length=16)[0] == enc.payload()
