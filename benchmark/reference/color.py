"""The plain colour ICER codec that judges the colour cells' runs:
lib_icer's YUV path (``icer_compress_image_yuv_uint16``) over three
channels.

Encode: RGB to YCbCr with the reference example's clipped fixed-point
macros (``rgb_to_ycbcr``); each channel transformed as the grayscale
reference transforms an image (``codec.transform``); one packet list over
the three channels (``build_packets_color``, with its doubling of the
priority on every Y visit); each channel's segment planes coded by
``lanes`` in tranches that double, as ``codec.encode`` codes them; one
greedy allocation over the three channels' packets that stops at the
quota, with the channel in each header's ``lsb_chan`` nibble; and the
stream laid out in the ``uint16`` colour order
(``rearrange_order_color_uint16``).

Decode: per channel ``codec.expected_pixels`` of the packets the stream
holds of it.  A channel of which the quota kept no segment decodes to
zeros with LL mean 0 (the reference leaves that case undefined,
icer_color.c:229/555; the port and the JAX package decode it so).

Sources: the JAX package's ``utils/colorspace.py`` (lib_icer's
example/inc/color_util.h:27-34), ``core/packets.py``
(``build_packets_color``, ``rearrange_order_color_uint16``: icer_color.c
:398-456, :510-527) and ``models/color.py``.
"""

from __future__ import annotations

import numpy as np

from . import codec as R
from . import constants as C
from .header import SegmentHeader
from .packets import PacketContext, _check_packet_count, sort_packets
from .partition import partition_segments
from .subbands import subband_view

NCHAN = 3


def rgb_to_ycbcr(rgb: np.ndarray):
    """(h, w, 3) uint8 RGB -> three (h, w) int64 planes (y, cb, cr):
    CRGB2Y, CRGB2Cb and CRGB2Cr of color_util.h:27-29, clipped to 8
    bits."""
    r, g, b = (rgb[..., k].astype(np.int64) for k in range(3))
    y = np.clip((19595 * r + 38470 * g + 7471 * b) >> 16, 0, 255)
    cb = np.clip(((36962 * (b - y)) >> 16) + 128, 0, 255)
    cr = np.clip(((46727 * (r - y)) >> 16) + 128, 0, 255)
    return y, cb, cr


def build_packets_color(image_w: int, image_h: int, stages: int,
                        ll_means, bitplanes: int) -> list[PacketContext]:
    """The colour packet list in creation order (icer_color.c:398-456).

    lib_icer's ``priority *= 2`` runs on every Y visit and is never
    undone, so the base doubles once per bitplane and the doubled value
    applies to the U and V packets of that bitplane too.  LL means
    truncate to 8 bits, as in ``build_packets_grayscale``."""
    ll_means = [m & 0xFF for m in ll_means]
    packets: list[PacketContext] = []

    def add(subband, level, lsb, priority, chan):
        packets.append(PacketContext(
            subband_type=subband, decomp_level=level,
            ll_mean_val=ll_means[chan], lsb=lsb, priority=priority,
            image_w=image_w, image_h=image_h, channel=chan))

    for stage in range(1, stages + 1):
        priority = 1 << stage
        for lsb in range(bitplanes):
            for chan in range(NCHAN):
                if chan == 0:
                    priority *= 2
                add(C.SUBBAND_HL, stage, lsb, priority << lsb, chan)
                add(C.SUBBAND_LH, stage, lsb, priority << lsb, chan)
                add(C.SUBBAND_HH, stage, lsb,
                    ((priority // 2) << lsb) + 1, chan)

    priority = 1 << stages
    for lsb in range(bitplanes):
        for chan in range(NCHAN):
            if chan == 0:
                priority *= 2
            add(C.SUBBAND_LL, stages, lsb, (2 * priority) << lsb, chan)
    return _check_packet_count(packets, bitplanes)


def rearrange_order_color_uint16(bitplanes: int) -> list:
    """(chan, stage, subband, lsb) in the uint16 stream's order
    (icer_color.c:510-527): subband desc, stage desc, lsb desc, channel
    asc."""
    return [(chan, i, j, lsb)
            for j in range(C.SUBBAND_MAX, -1, -1)
            for i in range(C.MAX_DECOMP_STAGES, -1, -1)
            for lsb in range(bitplanes - 1, -1, -1)
            for chan in range(NCHAN)]


def encode_color(rgb_frames, quota: int | None, codec: R.Codec,
                 workers=None, window: int = C.CIRC_BUF_SIZE) -> list:
    """Encode each (h, w, 3) uint8 RGB frame of ``rgb_frames`` (one size)
    at ``quota`` bytes (None: every packet) through YCbCr, coding segment
    planes on ``workers`` (``workers.Workers``; None: in this process) with
    a codeword buffer of ``window`` words.  Returns per frame {"stream":
    bytes, "included": per channel the set of (stage, subband, lsb, seg)
    the stream holds, "coeffs": per channel, "ll_means": per channel}."""
    from .workers import Workers
    if codec.mag_bits != 15:
        raise ValueError("the colour reference codes uint16 planes only")
    h, w = np.asarray(rgb_frames[0]).shape[:2]
    bp = codec.bitplanes
    work = []
    for rgb in rgb_frames:
        coeffs, means = [], []
        for plane in rgb_to_ycbcr(np.asarray(rgb)):
            c, m = R.transform(plane.astype(np.uint16), codec)
            coeffs.append(c)
            means.append(m)
        packets = sort_packets(build_packets_color(w, h, codec.stages,
                                                   means, bp))
        work.append({"coeffs": coeffs, "ll_means": means,
                     "packets": packets, "table": {}, "encoded": {},
                     "size": 0, "next": 0, "done": False})
    pool = workers if workers is not None else Workers(0)
    pool.set_images([c for wk in work for c in wk["coeffs"]])
    npk = len(work[0]["packets"])
    k = npk if quota is None else \
        max(8, min(npk, npk * quota // (NCHAN * h * w)))
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
                    specs.append((NCHAN * i + pkt.channel,
                                  view.row + rect.row, view.col + rect.col,
                                  rect.h, rect.w, pkt.subband_type, pkt.lsb))
                    keys.append((i, (pkt.channel, pkt.decomp_level,
                                     pkt.subband_type, pkt.lsb, rect.index)))
        for (i, key), res in zip(keys, pool.code(specs, codec.mag_bits,
                                                 window)):
            work[i]["table"][key] = res
        for i in todo:
            wk = work[i]
            stop = _allocate(wk, wk["next"], wk["next"] + k, quota, w, h,
                             codec)
            wk["next"] += k
            wk["done"] = stop or wk["next"] >= npk
        k *= 2
    order = rearrange_order_color_uint16(bp)
    return [{"stream": _assemble(wk["encoded"], order),
             "included": [{key[1:] for key in wk["encoded"] if key[0] == c}
                          for c in range(NCHAN)],
             "coeffs": wk["coeffs"], "ll_means": wk["ll_means"]}
            for wk in work]


def _allocate(wk, lo: int, hi: int, quota, w: int, h: int, codec) -> bool:
    """The greedy allocation over packets ``lo:hi`` of the three channels'
    list; True once it stops at the quota (icer_color.c's loop over the
    packet list, with icer_partition.c:323-326's header release)."""
    for pkt in wk["packets"][lo:hi]:
        for seg in range(codec.segments):
            key = (pkt.channel, pkt.decomp_level, pkt.subband_type, pkt.lsb,
                   seg)
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
                lsb=pkt.lsb, channel=pkt.channel, image_w=w, image_h=h,
                data_length=nbits)
            wk["encoded"][key] = (hdr, payload)
            wk["size"] += C.HEADER_SIZE + hdr.payload_bytes
    return False


def _assemble(encoded: dict, order) -> bytes:
    """Segments grouped by segment number, then in the colour order."""
    rank = {key: i for i, key in enumerate(order)}
    items = sorted(((k, v) for k, v in encoded.items() if k[:4] in rank),
                   key=lambda kv: (kv[0][4], rank[kv[0][:4]]))
    out = bytearray(sum(C.HEADER_SIZE + hdr.payload_bytes
                        for _, (hdr, _) in items))
    off = 0
    for _, (hdr, payload) in items:
        off += hdr.pack_into(out, off, payload)
    return bytes(out)


def expected_pixels(result: dict, codec: R.Codec,
                    included=None) -> np.ndarray:
    """The (3, h, w) planes a correct decoder returns for ``result``'s
    stream (``encode_color``'s), or for one that holds the packets
    ``included`` (per channel) of the same frame."""
    if included is None:
        included = result["included"]
    planes = []
    for coeffs, mean, inc in zip(result["coeffs"], result["ll_means"],
                                 included):
        if inc:
            planes.append(R.expected_pixels(coeffs, mean, inc, codec))
        else:
            planes.append(np.zeros(coeffs.shape, np.uint16))
    return np.stack(planes)
