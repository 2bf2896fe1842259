"""Sequential bitplane decoding: the host codec's ``python`` decode.

Counterpart: ``icer_compression_tpu/backend/decode_plane.py``
(``decode_bitplane``, ``decode_segment_planes``).  Decoding is serial
within one (segment, bitplane): each decoded bit updates the partial
coefficients that feed the next pixel's context
(icer_context_modeller.c:461-603).  This is the exact Python-level mirror;
the card path decodes the same planes with kernel 2, the ``native`` path
with the runtime's threaded segment decoder.
"""

from __future__ import annotations

import numpy as np

from ..core import constants as C
from ..core.status import IcerError
from .sequential import ContextCounters, InterleavedDecoder


def decode_bitplane(seg: np.ndarray, subband_type: int, lsb: int,
                    mag_bits: int, counters: ContextCounters,
                    decoder: InterleavedDecoder) -> None:
    """Decode one bitplane of one segment into ``seg`` (int32 (h, w)
    sign-magnitude, the planes above ``lsb`` and the signs decoded so far),
    in place.  Raises IcerError on a corrupt or exhausted stream with the
    partial reconstruction kept (the caller stops refining the segment,
    icer_partition.c:206-221)."""
    h, w = seg.shape
    prev = lsb + 1
    sign_bit = mag_bits
    ll_table = C.CONTEXT_TABLE_LL_LH_HL
    hh_table = C.CONTEXT_TABLE_HH
    is_hl = subband_type == C.SUBBAND_HL
    is_hh = subband_type == C.SUBBAND_HH

    def sig(r, c, plane):
        return 1 if (int(seg[r, c]) >> plane) \
            & ((1 << (mag_bits - plane)) - 1) else 0

    def sgn(r, c, plane):
        if not sig(r, c, plane):
            return 0
        return -1 if (int(seg[r, c]) >> sign_bit) & 1 else 0

    for r in range(h):
        for c in range(w):
            v = int(seg[r, c])
            mag = v & ((1 << mag_bits) - 1)
            category = min(3, max(0, (mag | 1).bit_length() - 1 - lsb))
            if category == 3:
                seg[r, c] = v | (decoder.decode_bit(1, 2) << lsb)
                continue
            if category <= 1:
                hcnt = vcnt = dcnt = 0
                if c > 0:
                    hcnt += sig(r, c - 1, lsb)
                if c < w - 1:
                    hcnt += sig(r, c + 1, prev)
                if r > 0:
                    vcnt += sig(r - 1, c, lsb)
                if r < h - 1:
                    vcnt += sig(r + 1, c, prev)
                if c > 0 and r > 0:
                    dcnt += sig(r - 1, c - 1, lsb)
                if c > 0 and r < h - 1:
                    dcnt += sig(r + 1, c - 1, prev)
                if c < w - 1 and r > 0:
                    dcnt += sig(r - 1, c + 1, lsb)
                if c < w - 1 and r < h - 1:
                    dcnt += sig(r + 1, c + 1, prev)
            if category == 0:
                if is_hl:
                    hcnt, vcnt = vcnt, hcnt
                ctx = int(hh_table[hcnt + vcnt, dcnt] if is_hh
                          else ll_table[hcnt, vcnt, dcnt])
            elif category == 1:
                ctx = 9 if hcnt + vcnt == 0 else 10
            else:
                ctx = 11
            bit = decoder.decode_bit(counters.zero[ctx], counters.total[ctx])
            seg[r, c] = v | (bit << lsb)
            counters.update(ctx, bit)
            if category == 0 and bit:
                sh = ((sgn(r, c - 1, lsb) if c > 0 else 0)
                      + (sgn(r, c + 1, prev) if c < w - 1 else 0) + 2)
                sv = ((sgn(r - 1, c, lsb) if r > 0 else 0)
                      + (sgn(r + 1, c, prev) if r < h - 1 else 0) + 2)
                if is_hl:
                    sh, sv = sv, sh
                sctx = int(C.SIGN_CONTEXT_TABLE[sh, sv])
                pred = int(C.SIGN_PREDICTION_TABLE[sh, sv])
                agreement = decoder.decode_bit(counters.zero[sctx],
                                               counters.total[sctx])
                seg[r, c] = int(seg[r, c]) | (((agreement ^ pred) & 1)
                                              << sign_bit)
                counters.update(sctx, agreement)


def decode_segment_planes(seg: np.ndarray, subband_type: int, mag_bits: int,
                          plane_payloads, bitplanes: int) -> None:
    """Decode a segment MSB -> LSB, stopping at the first missing plane or
    error (the refinement loop of icer_decompress_partition_*,
    icer_partition.c:427-443).  ``plane_payloads``: lsb -> (payload
    buffer, bit length); a decode past the bit length reads on into the
    buffer, then zeros."""
    for lsb in range(bitplanes - 1, -1, -1):
        entry = plane_payloads.get(lsb)
        if entry is None:
            break
        payload, nbits = entry
        try:
            decode_bitplane(seg, subband_type, lsb, mag_bits,
                            ContextCounters(), InterleavedDecoder(payload,
                                                                  nbits))
        except IcerError:
            break
