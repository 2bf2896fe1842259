"""Fault injection for bitstream robustness tests.

Counterpart: ``icer_compression_tpu/utils/faults.py``, copied as it is over
the port's own header scanner.  The ICER format contains errors by design
(per-segment CRC32-protected packets, byte-level resynchronisation,
MSB-first refinement that stops per segment on corruption); these
deterministic corruption primitives exercise that containment.
"""

from __future__ import annotations

import numpy as np

from ..core.header import scan_bytestream


def truncate(stream: bytes, fraction: float) -> bytes:
    """Keep the first ``fraction`` of the stream (progressive prefix)."""
    return stream[: int(len(stream) * fraction)]


def flip_bytes(stream: bytes, offsets, xor: int = 0xFF) -> bytes:
    """XOR the bytes at ``offsets`` (offsets wrap modulo the length).

    An empty stream is returned unchanged (nothing to corrupt)."""
    if not stream:
        return stream
    out = bytearray(stream)
    for off in offsets:
        out[off % len(out)] ^= xor
    return bytes(out)


def corrupt_random(stream: bytes, n: int, seed: int = 0) -> bytes:
    """Flip ``n`` random bytes (no-op on an empty stream)."""
    if not stream:
        return stream
    rng = np.random.default_rng(seed)
    offs = rng.integers(0, len(stream), n)
    return flip_bytes(stream, offs.tolist())


def drop_segments(stream: bytes, predicate) -> bytes:
    """Remove whole segments for which ``predicate(header)`` is true.

    Keeps the wire layout of the surviving segments (headers and payloads
    re-concatenated in order)."""
    out = bytearray()
    for hdr, payload in scan_bytestream(stream):
        if predicate(hdr):
            continue
        out += hdr.pack(payload)
    return bytes(out)


def segment_census(stream: bytes):
    """Summary of the segments in a stream: list of (channel, stage,
    subband, segment, lsb, payload_bytes)."""
    return [
        (h.channel, h.decomp_level, h.subband_type, h.segment_number,
         h.lsb, h.payload_bytes)
        for h, _ in scan_bytestream(stream)
    ]
