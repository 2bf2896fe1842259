"""The plain grayscale ICER codec that judges the benchmark's runs.

Encode: the forward DWT, the LL mean and sign-magnitude, the packets in
priority order, each segment plane's emissions (``context_model``) coded
by ``lanes`` (many segment planes at once), the greedy allocation that
stops at the quota, and the stream laid out as the reference lays it out.
The allocation codes the packets in tranches that double, so a quota that
admits a prefix codes little more than that prefix.

Decode: a stream's packets decode losslessly to the bits they were coded
from, and a segment's decoder stops at its first missing plane.  So the
pixels a correct decoder returns for a stream are a function of the
image and of which (stage, subband, lsb, segment) packets the stream
holds: every coefficient keeps its magnitude bits from the top plane down
to the lowest plane present without a gap above it, and its sign when any
of those bits is set; then the LL mean, the inverse DWT and the clamp.
``expected_pixels`` computes that, with no entropy decoding.

Sources: the JAX package's host codec (``models/grayscale.py``:
``transform_for_encode``, ``allocate_from_table``, ``assemble_stream``,
``finish_channel``; ``backend/decode_plane.decode_segment_planes``),
which mirror lib_icer's ``icer_compress.c`` and ``icer_partition.c``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import constants as C
from . import wavelet
from .header import SegmentHeader
from .packets import (build_packets_grayscale, rearrange_order_grayscale,
                      sort_packets)
from .partition import partition_segments
from .status import IcerError, IcerStatus
from .subbands import dim_low, subband_view


@dataclass(frozen=True)
class Codec:
    stages: int = 4
    filt: int = 0
    segments: int = 6
    mag_bits: int = 15        # uint16 samples

    @property
    def bitplanes(self) -> int:
        return C.BITPLANES_8 if self.mag_bits == 7 else C.BITPLANES_16


def transform(image: np.ndarray, codec: Codec):
    """(sign-magnitude coefficients, ll_mean) of one image."""
    h, w = image.shape
    img, overflow = wavelet.forward_stages(
        np.ascontiguousarray(image, dtype=np.int32), codec.stages,
        codec.filt, codec.mag_bits)
    if overflow:
        raise IcerError(IcerStatus.INTEGER_OVERFLOW, "wavelet transform")
    img = np.array(img)
    ll_w, ll_h = dim_low(w, codec.stages), dim_low(h, codec.stages)
    sample_mask = (1 << (codec.mag_bits + 1)) - 1
    ll = img[:ll_h, :ll_w]
    ll_mean = int((ll & sample_mask).astype(np.uint64).sum() // (ll_w * ll_h))
    if ll_mean > (1 << codec.mag_bits) - 1:
        raise IcerError(IcerStatus.INTEGER_OVERFLOW, "ll mean")
    img[:ll_h, :ll_w] = wavelet._wrap(ll - ll_mean, codec.mag_bits, np)
    return np.asarray(wavelet.to_sign_magnitude(img, codec.mag_bits)), ll_mean


def encode(images, quota: int | None, codec: Codec, workers=None,
           window: int = C.CIRC_BUF_SIZE) -> list:
    """Encode each (h, w) image of ``images`` (one size) at ``quota`` bytes
    (None: every packet), coding segment planes on ``workers``
    (``workers.Workers``; None: in this process) with a codeword buffer
    of ``window`` words (lib_icer's: ``CIRC_BUF_SIZE``).  Returns per image
    {"stream": bytes, "included": set of (stage, subband, lsb, seg),
    "coeffs", "ll_mean"}."""
    from .workers import Workers
    h, w = images[0].shape
    bp = codec.bitplanes
    work = []
    for image in images:
        coeffs, ll_mean = transform(image, codec)
        packets = sort_packets(build_packets_grayscale(w, h, codec.stages,
                                                       ll_mean, bp))
        work.append({"coeffs": coeffs, "ll_mean": ll_mean,
                     "packets": packets, "table": {}, "encoded": {},
                     "size": 0, "next": 0, "done": False})
    pool = workers if workers is not None else Workers(0)
    pool.set_images([wk["coeffs"] for wk in work])
    npk = len(work[0]["packets"])
    k = npk if quota is None else max(8, min(npk, npk * quota // (h * w)))
    while True:
        todo = [i for i, wk in enumerate(work) if not wk["done"]]
        if not todo:
            break
        specs, keys = [], []
        for i in todo:
            wk = work[i]
            for pkt in wk["packets"][wk["next"]:wk["next"] + k]:
                view = subband_view(w, h, pkt.decomp_level, pkt.subband_type)
                for rect in partition_segments(view.w, view.h,
                                               codec.segments):
                    specs.append((i, view.row + rect.row,
                                  view.col + rect.col, rect.h, rect.w,
                                  pkt.subband_type, pkt.lsb))
                    keys.append((i, (pkt.decomp_level, pkt.subband_type,
                                     pkt.lsb, rect.index)))
        for (i, key), res in zip(keys, pool.code(specs, codec.mag_bits, window)):
            work[i]["table"][key] = res
        for i in todo:
            wk = work[i]
            stop = _allocate(wk, wk["next"], wk["next"] + k, quota, w, h,
                             codec)
            wk["next"] += k
            wk["done"] = stop or wk["next"] >= npk
        k *= 2
    order = rearrange_order_grayscale(bp)
    return [{"stream": _assemble(wk["encoded"], order),
             "included": set(wk["encoded"]),
             "coeffs": wk["coeffs"], "ll_mean": wk["ll_mean"]}
            for wk in work]


def _allocate(wk, lo: int, hi: int, quota, w: int, h: int, codec) -> bool:
    """The greedy allocation over packets ``lo:hi``; True once it stops at
    the quota (header released, all coding stopped: icer_partition.c
    :323-326, icer_compress.c:404)."""
    for pkt in wk["packets"][lo:hi]:
        for seg in range(codec.segments):
            key = (pkt.decomp_level, pkt.subband_type, pkt.lsb, seg)
            if key not in wk["table"]:
                continue          # a subband with fewer segments
            if quota is not None and quota - wk["size"] < C.HEADER_SIZE:
                return True
            payload, nbits = wk["table"][key]
            if quota is not None and \
                    nbits >= 8 * (quota - wk["size"] - C.HEADER_SIZE):
                return True
            hdr = SegmentHeader(
                ll_mean_val=pkt.ll_mean_val, decomp_level=pkt.decomp_level,
                subband_type=pkt.subband_type, segment_number=seg,
                lsb=pkt.lsb, channel=0, image_w=w, image_h=h,
                data_length=nbits)
            wk["encoded"][key] = (hdr, payload)
            wk["size"] += C.HEADER_SIZE + hdr.payload_bytes
    return False


def _assemble(encoded: dict, order) -> bytes:
    """Segments grouped by segment number, then in the rearrangement order
    (icer_compress.c:330-345)."""
    rank = {key: i for i, key in enumerate(order)}
    items = sorted(((k, v) for k, v in encoded.items()
                    if (0,) + k[:3] in rank),
                   key=lambda kv: (kv[0][3], rank[(0,) + kv[0][:3]]))
    out = bytearray(sum(C.HEADER_SIZE + hdr.payload_bytes
                        for _, (hdr, _) in items))
    off = 0
    for _, (hdr, payload) in items:
        off += hdr.pack_into(out, off, payload)
    return bytes(out)


def expected_pixels(coeffs: np.ndarray, ll_mean: int, included: set,
                    codec: Codec, dtype=np.uint16) -> np.ndarray:
    """The pixels a correct decoder returns for a stream that holds the
    packets ``included`` of an image with these coefficients."""
    h, w = coeffs.shape
    bp = codec.bitplanes
    mb = codec.mag_bits
    mag = coeffs & ((1 << mb) - 1) & ((1 << bp) - 1)
    sign = (coeffs >> mb) & 1
    dec = np.zeros_like(coeffs)
    subbands = [(codec.stages, C.SUBBAND_LL)] + [
        (s, sb) for s in range(1, codec.stages + 1)
        for sb in (C.SUBBAND_HL, C.SUBBAND_LH, C.SUBBAND_HH)]
    for stage, sb in subbands:
        view = subband_view(w, h, stage, sb)
        for rect in partition_segments(view.w, view.h, codec.segments):
            low = bp
            while low > 0 and (stage, sb, low - 1, rect.index) in included:
                low -= 1
            if low == bp:
                continue
            r0, c0 = view.row + rect.row, view.col + rect.col
            sl = (slice(r0, r0 + rect.h), slice(c0, c0 + rect.w))
            m = (mag[sl] >> low) << low
            dec[sl] = m | np.where(m != 0, sign[sl] << mb, 0)
    t = wavelet.from_sign_magnitude(dec, mb)
    ll_w, ll_h = dim_low(w, codec.stages), dim_low(h, codec.stages)
    t = np.array(t)
    t[:ll_h, :ll_w] = wavelet._wrap(t[:ll_h, :ll_w] + (ll_mean & 0xFF), mb,
                                    np)
    out, _ = wavelet.inverse_stages(t, codec.stages, codec.filt, mb)
    out = np.array(out)
    out[out < 0] = 0
    return out.astype(dtype)
