"""Grayscale ICER codec entry points.

Counterpart: ``icer_compression_tpu/models/grayscale.py`` (``CodecConfig``,
``allocate_from_table``, ``assemble_stream``, ``_jax_quota_classes`` and
the ``compress_jax`` / ``decompress`` semantics).  ``compress`` encodes on
the device (ops/encode) only the priority-prefix bitplanes that the byte
quota's class admits, allocates the quota on the host in the reference's
packet priority order, and widens to the next class (encoding only the
planes it adds) when the prefix falls short; the stream is byte-identical
to the JAX package's at any quota.  ``decompress`` runs the lane-batched
decoder (models/decode).

Every entry point takes ``device=None``, which means ``"cuda"``; without a
CUDA device the caller must pass ``device="cpu"``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core import constants as C
from ..core.header import SegmentHeader
from ..core.packets import (build_packets_grayscale,
                            rearrange_order_grayscale, sort_packets)
from ..core.status import IcerError, IcerStatus
from ..device import resolve_device


@dataclass
class CodecConfig:
    stages: int = 4
    filt: int = C.FILTER_A
    segments: int = 6
    byte_quota: int | None = None  # None = unlimited ("pure" lossless)


def _mag_bits(dtype) -> int:
    dt = np.dtype(dtype)
    if dt == np.uint8:
        return 7
    if dt == np.uint16:
        return 15
    raise IcerError(IcerStatus.INVALID_INPUT, f"unsupported dtype {dt}")


def _bitplanes(mag_bits: int) -> int:
    return C.BITPLANES_8 if mag_bits == 7 else C.BITPLANES_16


def allocate_from_table(packets, payload_table: dict, quota,
                        segments_per_subband: dict, image_w: int,
                        image_h: int):
    """Greedy rate allocation over fully-encoded payloads, in packet
    priority order, with the reference's header release and stop-all at
    the quota (icer_partition.c:323-326, icer_compress.c:404).
    payload_table maps (chan, stage, subband, lsb, seg) -> (payload,
    nbits); returns the encoded dict for assemble_stream."""
    size_used = 0
    encoded: dict[tuple, tuple[SegmentHeader, bytes]] = {}
    for pkt in packets:
        nsegs = segments_per_subband[(pkt.decomp_level, pkt.subband_type)]
        for seg in range(nsegs):
            if quota is not None and quota - size_used < C.HEADER_SIZE:
                return encoded
            payload, nbits = payload_table[
                (pkt.channel, pkt.decomp_level, pkt.subband_type, pkt.lsb,
                 seg)]
            if quota is not None:
                max_out = quota - size_used - C.HEADER_SIZE
                if nbits >= 8 * max_out:
                    return encoded
            hdr = SegmentHeader(
                ll_mean_val=pkt.ll_mean_val, decomp_level=pkt.decomp_level,
                subband_type=pkt.subband_type, segment_number=seg,
                lsb=pkt.lsb, channel=pkt.channel, image_w=image_w,
                image_h=image_h, data_length=nbits)
            encoded[(pkt.channel, pkt.decomp_level, pkt.subband_type,
                     pkt.lsb, seg)] = (hdr, payload)
            size_used += C.HEADER_SIZE + hdr.payload_bytes
    return encoded


def assemble_stream(encoded: dict, order) -> bytes:
    """Lay out segments grouped by segment number, then in the
    rearrangement order (icer_compress.c:330-345)."""
    rank = {key: i for i, key in enumerate(order)}
    items = sorted(
        (kv for kv in encoded.items() if kv[0][:4] in rank),
        key=lambda kv: (kv[0][4], rank[kv[0][:4]]))
    total = sum(C.HEADER_SIZE + hdr.payload_bytes for _, (hdr, _) in items)
    out = bytearray(total)
    off = 0
    for _, (hdr, payload) in items:
        off += hdr.pack_into(out, off, payload)
    return bytes(out)


def make_encoder(w: int, h: int, config: CodecConfig, dtype, device=None,
                 entropy: str = "slim", plane_cuts: tuple | None = None):
    """An encoder for (h, w) images of ``dtype`` on ``device``, with the
    coder backend ``entropy`` (``slim``, ``pallas`` or ``sorted``) over
    the plane windows ``plane_cuts`` (None: every plane)."""
    from ..ops.encode import TorchGrayscaleEncoder
    return TorchGrayscaleEncoder(w, h, config.stages, config.filt,
                                 config.segments, _mag_bits(dtype),
                                 resolve_device(device), entropy=entropy,
                                 plane_cuts=plane_cuts)


# Byte-mass share of bitplane lsb (0 = LSB) for natural imagery, measured
# on the boat.512 lossless stream (``encode_jax.PLANE_MASS``): the quota
# prefix classes place their boundaries with it.
PLANE_MASS = (0.225, 0.238, 0.214, 0.157, 0.080, 0.034, 0.020, 0.016,
              0.016)

_QUOTA_CLASSES: dict[tuple, list] = {}
_ENCODERS: dict[tuple, object] = {}


def quota_classes(w: int, h: int, stages: int, bitplanes: int):
    """Priority-prefix classes for quota-aware encoding: [(model fraction,
    cuts)], cuts[gi] the lowest lsb any prefix packet needs from stage
    group gi.  The packet priority order is a pure function of (stage,
    subband, lsb), so the prefix a quota admits is static up to the
    payload sizes; boundaries sit where the PLANE_MASS byte model crosses
    1/16, 1/8, 1/4, 1/2 and 1 (the reference stops coding at the quota,
    icer_compress.c:404; this is the lane-masked equivalent)."""
    cached = _QUOTA_CLASSES.get((w, h, stages, bitplanes))
    if cached is not None:
        return cached
    packets = sort_packets(build_packets_grayscale(w, h, stages, 0,
                                                   bitplanes))
    npk = len(packets)
    mass = PLANE_MASS[:bitplanes]
    mass = [m / sum(mass) for m in mass]
    per_lsb_packets = max(1, npk // bitplanes)
    classes, seen = [], set()
    cum = 0.0
    bounds = [1 / 16, 1 / 8, 1 / 4, 1 / 2, 1.0]
    bi = 0
    cuts = [bitplanes] * stages
    for i, p in enumerate(packets):
        cum += mass[p.lsb] / per_lsb_packets
        gi = p.decomp_level - 1
        cuts[gi] = min(cuts[gi], p.lsb)
        last = i + 1 == npk
        if bi < len(bounds) and (cum >= bounds[bi] or last):
            while bi < len(bounds) and cum >= bounds[bi]:
                bi += 1
            t = tuple(cuts)
            if t not in seen:
                seen.add(t)
                classes.append((min(cum, 1.0), t))
    if classes[-1][1] != (0,) * stages:
        classes.append((1.0, (0,) * stages))
    _QUOTA_CLASSES[(w, h, stages, bitplanes)] = classes
    return classes


def _cached_encoder(w, h, stages, filt, segments, mag_bits, entropy,
                    device, windows):
    """One encoder per (geometry, backend, device, plane windows)."""
    from ..ops.encode import TorchGrayscaleEncoder
    key = (w, h, stages, filt, segments, mag_bits, entropy, str(device),
           windows)
    enc = _ENCODERS.get(key)
    if enc is None:
        enc = _ENCODERS[key] = TorchGrayscaleEncoder(
            w, h, stages, filt, segments, mag_bits, device, entropy=entropy,
            plane_cuts=windows)
    return enc


def _window_encoder(enc, windows):
    """``enc`` itself for its own plane windows, else the cached encoder
    of its geometry, backend and device for ``windows``."""
    if windows == enc.plane_cuts:
        return enc
    return _cached_encoder(enc.w, enc.h, enc.stages, enc.filt, enc.segments,
                           enc.mag_bits, enc.entropy, enc.device, windows)


def compress_batch(images: np.ndarray, config: CodecConfig, device=None,
                   encoder=None, stats: dict | None = None) -> list[bytes]:
    """Compress a (B, h, w) batch of same-geometry grayscale images; each
    stream equals ``compress`` of its image.  ``encoder`` (from
    ``make_encoder``) picks the coder backend and may be passed to reuse
    its plan across calls; without one the ``slim`` backend runs.

    The quota picks a prefix class for the whole batch; when any image's
    allocation needs a plane outside it, the batch widens to the next
    class and encodes only the planes that adds.  ``stats``, if given,
    receives the first class, the last and the widening steps taken."""
    images = np.asarray(images)
    if images.ndim != 3:
        raise IcerError(IcerStatus.INVALID_INPUT, "expected (B, h, w)")
    mag_bits = _mag_bits(images.dtype)
    B, h, w = images.shape
    bitplanes = _bitplanes(mag_bits)
    full = ((0, bitplanes),) * config.stages
    if encoder is None:
        encoder = _cached_encoder(w, h, config.stages, config.filt,
                                  config.segments, mag_bits, "slim",
                                  resolve_device(device), full)
    classes = quota_classes(w, h, config.stages, bitplanes)
    quota = config.byte_quota
    if quota is None:
        ci = len(classes) - 1
    else:
        # byte coverage needed: the quota as a fraction of a lossless
        # stream (~0.65 x raw for natural images), with 1.7x headroom
        want = min(1.0, 1.7 * quota / max(1, 0.65 * h * w))
        ci = next((i for i, (frac, _) in enumerate(classes)
                   if frac >= want), len(classes) - 1)
    if stats is not None:
        stats.update(first_class=ci, classes=len(classes), escalations=0)

    tables: list[dict] = [{} for _ in range(B)]
    means = [0] * B
    prev = (bitplanes,) * config.stages
    while True:
        cuts = classes[ci][1]
        windows = tuple((lo, hi) for lo, hi in zip(cuts, prev))
        if any(lo < hi for lo, hi in windows):
            # per-lane payloads do not depend on other lanes, so the union
            # of the window tables equals the wider class's table
            enc = _window_encoder(encoder, windows)
            for i, (table, ll_mean) in enumerate(enc.encode_batch(images)):
                tables[i].update(table)
                means[i] = ll_mean
            prev = tuple(min(a, b) for a, b in zip(cuts, prev))
        try:
            out = allocate_streams(zip(tables, means), config, encoder)
            break
        except KeyError:
            # the quota admits more than the encoded prefix: widen
            if ci + 1 >= len(classes):
                raise
            ci += 1
            if stats is not None:
                stats["escalations"] += 1
    if stats is not None:
        stats["last_class"] = ci
    return out


def allocate_streams(results, config: CodecConfig, encoder) -> list[bytes]:
    """The streams of ``encoder.encode_batch``'s (payload_table, ll_mean)
    results under ``config``'s quota; raises KeyError when the quota admits
    a packet outside the encoder's plane windows."""
    return [_allocate_stream({(0,) + k: v for k, v in table.items()},
                             ll_mean, config, encoder.w, encoder.h,
                             encoder.bitplanes)
            for table, ll_mean in results]


def _allocate_stream(table, ll_mean, config, w, h, bitplanes) -> bytes:
    """One image's stream from its payload table, keyed (chan, stage,
    subband, lsb, seg); raises KeyError when the quota admits a packet the
    table lacks."""
    packets = sort_packets(build_packets_grayscale(
        w, h, config.stages, ll_mean, bitplanes))
    nsegs = {(p.decomp_level, p.subband_type): config.segments
             for p in packets}
    encoded = allocate_from_table(packets, table, config.byte_quota, nsegs,
                                  w, h)
    return assemble_stream(encoded, rearrange_order_grayscale(bitplanes))


def compress(image: np.ndarray, config: CodecConfig, device=None) -> bytes:
    """Compress one grayscale image (uint8 or uint16) to an ICER stream."""
    image = np.asarray(image)
    if image.ndim != 2:
        raise IcerError(IcerStatus.INVALID_INPUT, "expected (h, w)")
    return compress_batch(image[None], config, device=device)[0]


def decompress(data: bytes, config: CodecConfig, dtype=np.uint16,
               device=None, max_pixels: int | None = None,
               pack8: bool | None = None) -> np.ndarray:
    """Decompress one grayscale ICER stream.  ``max_pixels`` (default
    ``models.decode.DEFAULT_MAX_PIXELS``) bounds the canvas the untrusted
    header may ask for; ``pack8`` as in ``models.decode.decompress_batch``."""
    from .decode import decompress_batch
    return decompress_batch([data], config, dtype=dtype, device=device,
                            max_pixels=max_pixels, pack8=pack8)[0]
