"""Grayscale ICER codec entry points.

Counterpart: ``icer_compression_tpu/models/grayscale.py`` (``CodecConfig``,
``allocate_from_table``, ``assemble_stream``, and ``compress_jax`` /
``decompress`` semantics).  ``compress`` encodes every plane of every
segment on the device (ops/encode) and then allocates the byte quota on
the host, in the reference's packet priority order; the stream is
byte-identical to the JAX package's at any quota.  ``decompress`` runs the
lane-batched decoder (models/decode).

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


def make_encoder(w: int, h: int, config: CodecConfig, dtype, device=None):
    """An encoder for (h, w) images of ``dtype`` on ``device``."""
    from ..ops.encode import TorchGrayscaleEncoder
    return TorchGrayscaleEncoder(w, h, config.stages, config.filt,
                                 config.segments, _mag_bits(dtype),
                                 resolve_device(device))


def compress_batch(images: np.ndarray, config: CodecConfig, device=None,
                   encoder=None) -> list[bytes]:
    """Compress a (B, h, w) batch of same-geometry grayscale images; each
    stream equals ``compress`` of its image.  ``encoder`` (from
    ``make_encoder``) may be passed to reuse its plan across calls."""
    images = np.asarray(images)
    if images.ndim != 3:
        raise IcerError(IcerStatus.INVALID_INPUT, "expected (B, h, w)")
    mag_bits = _mag_bits(images.dtype)
    _b, h, w = images.shape
    if encoder is None:
        encoder = make_encoder(w, h, config, images.dtype, device)
    bitplanes = _bitplanes(mag_bits)
    out = []
    for table, ll_mean in encoder.encode_batch(images):
        packets = sort_packets(build_packets_grayscale(
            w, h, config.stages, ll_mean, bitplanes))
        nsegs = {(p.decomp_level, p.subband_type): config.segments
                 for p in packets}
        encoded = allocate_from_table(
            packets, {(0,) + k: v for k, v in table.items()},
            config.byte_quota, nsegs, w, h)
        out.append(assemble_stream(encoded,
                                   rearrange_order_grayscale(bitplanes)))
    return out


def compress(image: np.ndarray, config: CodecConfig, device=None) -> bytes:
    """Compress one grayscale image (uint8 or uint16) to an ICER stream."""
    image = np.asarray(image)
    if image.ndim != 2:
        raise IcerError(IcerStatus.INVALID_INPUT, "expected (h, w)")
    return compress_batch(image[None], config, device=device)[0]


def decompress(data: bytes, config: CodecConfig, dtype=np.uint16,
               device=None) -> np.ndarray:
    """Decompress one grayscale ICER stream."""
    from .decode import decompress_batch
    return decompress_batch([data], config, dtype=dtype, device=device)[0]
