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

The host codec (the JAX package's ``backend=`` of ``compress`` and
``decompress``) sits beside the card path: ``backend="native"`` runs the
native runtime (``backend/native_backend``: threaded DWT, fused context
modelling and coding per (segment, bitplane), threaded segment decode),
with the quota-aware tranche allocator; ``backend="numpy"`` encodes plane
by plane through the ``encode_plane`` hook (default: the plain sort coder
of ops/entropy_sorted on CPU tensors, the sequential coder for a plane
that needs the reorder-window flush) and ``backend="python"`` decodes
segment by segment through the ``decode_partition`` hook (default: the
sequential decoder of backend/decode_plane).  The host codec ignores
``device``.  ``"native"`` raises when the runtime does not build; no
backend falls back to another.

Every card entry point takes ``device=None``, which means ``"cuda"``;
without a CUDA device the caller must pass ``device="cpu"``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core import constants as C
from ..core.header import SegmentHeader, scan_bytestream
from ..core.packets import (build_packets_grayscale,
                            rearrange_order_grayscale, sort_packets)
from ..core.partition import partition_segments
from ..core.status import IcerError, IcerStatus
from ..core.subbands import decode_subband_order, dim_low, subband_view
from ..device import resolve_device
from ..utils import trace

ENCODE_BACKENDS = ("device", "native", "numpy")
DECODE_BACKENDS = ("device", "native", "python")


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
                 entropy: str = "auto", plane_cuts: tuple | None = None,
                 graph: bool | None = None):
    """An encoder for (h, w) images of ``dtype`` on ``device``, with the
    coder backend ``entropy`` (``auto``: kernel 1 on every bucket, as
    ``slim``; ``pallas`` or ``sorted``)
    over the plane windows ``plane_cuts`` (None: every plane).  ``graph``
    (None: on for a CUDA device) runs each device pass as a captured CUDA
    graph (``ops/encode.TorchGrayscaleEncoder``); False runs it eagerly."""
    from ..ops.encode import TorchGrayscaleEncoder
    return TorchGrayscaleEncoder(w, h, config.stages, config.filt,
                                 config.segments, _mag_bits(dtype),
                                 resolve_device(device), entropy=entropy,
                                 plane_cuts=plane_cuts, graph=graph)


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
                    device, windows, graph: bool | None = None):
    """One encoder per (geometry, backend, device, plane windows, graph
    setting)."""
    from ..ops.encode import TorchGrayscaleEncoder
    if graph is None:
        graph = torch.device(device).type == "cuda"
    key = (w, h, stages, filt, segments, mag_bits, entropy, str(device),
           windows, bool(graph))
    enc = _ENCODERS.get(key)
    if enc is None:
        enc = _ENCODERS[key] = TorchGrayscaleEncoder(
            w, h, stages, filt, segments, mag_bits, device, entropy=entropy,
            plane_cuts=windows, graph=graph)
    return enc


def _window_encoder(enc, windows):
    """``enc`` itself for its own plane windows, else the cached encoder
    of its geometry, backend, device and graph setting for ``windows``."""
    if windows == enc.plane_cuts:
        return enc
    return _cached_encoder(enc.w, enc.h, enc.stages, enc.filt, enc.segments,
                           enc.mag_bits, enc.entropy, enc.device, windows,
                           graph=enc.graph)


def compress_batch(images: np.ndarray, config: CodecConfig, device=None,
                   encoder=None, stats: dict | None = None) -> list[bytes]:
    """Compress a (B, h, w) batch of same-geometry grayscale images; each
    stream equals ``compress`` of its image.  ``encoder`` (from
    ``make_encoder``) picks the coder backend and may be passed to reuse
    its plan across calls; without one the ``auto`` backend runs.

    The quota picks a prefix class for the whole batch; when any image's
    allocation needs a plane outside it, the batch widens to the next
    class and encodes only the planes that adds.  ``stats``, if given,
    receives the first class, the last and the widening steps taken.
    Under ``torch.profiler`` the call counts ``compress.requests`` and
    each widening step counts ``compress.widenings`` and runs in a span
    ``compress.widen`` (utils/trace)."""
    trace.count("compress.requests")
    images = np.asarray(images)
    if images.ndim != 3:
        raise IcerError(IcerStatus.INVALID_INPUT, "expected (B, h, w)")
    mag_bits = _mag_bits(images.dtype)
    B, h, w = images.shape
    bitplanes = _bitplanes(mag_bits)
    full = ((0, bitplanes),) * config.stages
    if encoder is None:
        encoder = _cached_encoder(w, h, config.stages, config.filt,
                                  config.segments, mag_bits, "auto",
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
    out = None
    step = trace.OFF        # the first class; each widening step's span
    while out is None:
        with step:
            cuts = classes[ci][1]
            windows = tuple((lo, hi) for lo, hi in zip(cuts, prev))
            if any(lo < hi for lo, hi in windows):
                # per-lane payloads do not depend on other lanes, so the
                # union of the window tables equals the wider class's
                enc = _window_encoder(encoder, windows)
                for i, (table, ll_mean) in enumerate(
                        enc.encode_batch(images)):
                    tables[i].update(table)
                    means[i] = ll_mean
                prev = tuple(min(a, b) for a, b in zip(cuts, prev))
            try:
                out = allocate_streams(zip(tables, means), config, encoder)
            except KeyError:
                # the quota admits more than the encoded prefix: widen
                if ci + 1 >= len(classes):
                    raise
                ci += 1
                trace.count("compress.widenings")
                step = trace.span("compress.widen")
                if stats is not None:
                    stats["escalations"] += 1
    if stats is not None:
        stats["last_class"] = ci
    return out


def allocate_streams(results, config: CodecConfig, encoder) -> list[bytes]:
    """The streams of ``encoder.encode_batch``'s (payload_table, ll_mean)
    results under ``config``'s quota; raises KeyError when the quota admits
    a packet outside the encoder's plane windows.  Under
    ``torch.profiler`` it runs in a span ``alloc.streams``
    (utils/trace)."""
    with trace.span("alloc.streams"):
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


def _pick_backend(backend, hook, names, hook_backend) -> str:
    """The backend to run: ``backend``, or without one ``hook_backend`` when
    a per-plane hook is given and ``"device"`` otherwise.  A hook belongs
    to ``hook_backend`` only."""
    if backend is None:
        backend = hook_backend if hook is not None else "device"
    if backend not in names:
        raise ValueError(f"unknown backend {backend!r}: expected one of "
                         f"{', '.join(names)}")
    if hook is not None and backend != hook_backend:
        raise ValueError(f"a per-plane hook runs on the {hook_backend!r} "
                         f"backend, not {backend!r}")
    return backend


def compress(image: np.ndarray, config: CodecConfig, device=None,
             encode_plane=None, backend: str | None = None) -> bytes:
    """Compress one grayscale image (uint8 or uint16) to an ICER stream.

    ``backend``: ``"device"`` (the default; ``compress_batch`` on
    ``device``), ``"native"`` (the native runtime with the quota-aware
    tranche allocator) or ``"numpy"`` (plane by plane through
    ``encode_plane``, default ``encode_plane_payload``).  Passing
    ``encode_plane`` alone picks ``"numpy"``.  All three give the same
    stream."""
    image = np.asarray(image)
    if image.ndim != 2:
        raise IcerError(IcerStatus.INVALID_INPUT, "expected (h, w)")
    backend = _pick_backend(backend, encode_plane, ENCODE_BACKENDS, "numpy")
    if backend == "device":
        return compress_batch(image[None], config, device=device)[0]
    mag_bits = _mag_bits(image.dtype)
    bitplanes = _bitplanes(mag_bits)
    h, w = image.shape
    native = backend == "native"
    img, ll_mean = transform_for_encode(image, config.stages, config.filt,
                                        mag_bits, native=native)
    packets = sort_packets(build_packets_grayscale(
        w, h, config.stages, ll_mean, bitplanes))
    if native:
        encoded = encode_native_tranches({0: img}, packets, config,
                                         mag_bits, w, h)
    else:
        encoded = encode_per_plane({0: img}, packets, config, mag_bits, w, h,
                                   encode_plane or encode_plane_payload)
    return assemble_stream(encoded, rearrange_order_grayscale(bitplanes))


def decompress(data: bytes, config: CodecConfig, dtype=np.uint16,
               device=None, max_pixels: int | None = None,
               pack8: bool | None = None, decode_partition=None,
               backend: str | None = None,
               graph: bool | None = None) -> np.ndarray:
    """Decompress one grayscale ICER stream.  ``max_pixels`` (default
    ``models.decode.DEFAULT_MAX_PIXELS``) bounds the canvas the untrusted
    header may ask for; ``pack8`` as in ``models.decode.decompress_batch``.

    ``backend``: ``"device"`` (the default; the lane-batched decoder on
    ``device``), ``"native"`` (the runtime's threaded segment decoder) or
    ``"python"`` (segment by segment through ``decode_partition``, default
    the sequential decoder of ``backend/decode_plane``).  Passing
    ``decode_partition`` alone picks ``"python"``.  Like the reference's
    grayscale decoder, the host paths ignore the header's channel nibble
    (last in stream wins on duplicates).  All three give the same
    pixels.  ``graph`` (device backend) as in
    ``models.decode.decompress_batch``: by default on the card the
    decode's device pass is a captured CUDA graph per plan key."""
    backend = _pick_backend(backend, decode_partition, DECODE_BACKENDS,
                            "python")
    if backend == "device":
        from .decode import decompress_batch
        return decompress_batch([data], config, dtype=dtype, device=device,
                                max_pixels=max_pixels, pack8=pack8,
                                graph=graph)[0]
    mag_bits = _mag_bits(dtype)
    bitplanes = _bitplanes(mag_bits)
    table, (w, h), ll_means = scan_table(data, 1, max_pixels)
    img = np.zeros((h, w), dtype=np.int32)
    native = backend == "native"
    reconstruct_channel(img, table, 0, config, mag_bits, bitplanes, data,
                        decode_partition, native=native)
    return finish_channel(img, ll_means[0], config, mag_bits, dtype,
                          native=native)


# ---- the host codec -----------------------------------------------------

def transform_for_encode(image: np.ndarray, stages: int, filt: int,
                         mag_bits: int, native: bool = False):
    """DWT + LL mean removal + sign-magnitude on the host: the DWT in the
    native runtime with ``native``, else ops/wavelet on CPU tensors.
    Returns (C-contiguous int32 array, ll_mean)."""
    from ..ops import wavelet
    h, w = image.shape
    wavelet.check_stages(w, h, stages)
    img = np.array(image, dtype=np.int32)
    if native:
        from ..backend import native_backend
        overflow = native_backend.dwt_native(img, stages, filt, mag_bits)
    else:
        t, ov = wavelet.forward_stages(torch.from_numpy(img), stages, filt,
                                       mag_bits)
        img, overflow = t.numpy(), bool(ov)
    if overflow:
        raise IcerError(IcerStatus.INTEGER_OVERFLOW, "wavelet transform")
    ll_w = dim_low(w, stages)
    ll_h = dim_low(h, stages)
    # the reference sums the raw (unsigned-reinterpreted) sample words
    # (icer_compress.c:289-299)
    sample_mask = (1 << (mag_bits + 1)) - 1
    ll = img[:ll_h, :ll_w]
    ll_mean = int((ll & sample_mask).astype(np.uint64).sum()
                  // (ll_w * ll_h))
    if ll_mean > (1 << mag_bits) - 1:
        raise IcerError(IcerStatus.INTEGER_OVERFLOW, "ll mean")
    t = torch.from_numpy(img)
    t[:ll_h, :ll_w] = wavelet._wrap(t[:ll_h, :ll_w] - ll_mean, mag_bits)
    return np.ascontiguousarray(
        wavelet.to_sign_magnitude(t, mag_bits).numpy()), ll_mean


def inverse_transform(img: np.ndarray, stages: int, filt: int,
                      mag_bits: int, native: bool = False) -> np.ndarray:
    """Inverse DWT on the host: the native runtime with ``native``, else
    ops/wavelet on CPU tensors."""
    img = np.array(img, dtype=np.int32)
    if native:
        from ..backend import native_backend
        native_backend.dwt_native(img, stages, filt, mag_bits, inverse=True)
        return img
    from ..ops import wavelet
    out, _ov = wavelet.inverse_stages(torch.from_numpy(img), stages, filt,
                                      mag_bits)
    return out.numpy()


def _plane_words(seg_data: np.ndarray, subband_type: int, lsb: int,
                 mag_bits: int) -> torch.Tensor:
    """One segment plane's interleaved emission words, (1, L): the 2 * h *
    w words padded with invalid ones to a multiple of 256, the lengths the
    sort coder runs at in the encoder (a coder's output depends only on
    the valid words)."""
    from ..ops.context_model import plane_emissions_words
    seg = torch.from_numpy(np.ascontiguousarray(seg_data, np.int32))[None]
    w0, w1 = plane_emissions_words(
        seg, torch.tensor([subband_type], dtype=torch.int32),
        torch.ones_like(seg), lsb, mag_bits)
    words = torch.stack([w0, w1], dim=-1).reshape(1, -1)
    return torch.nn.functional.pad(words, (0, -words.shape[1] % 256))


def _sequential_payload(words: torch.Tensor):
    from ..backend import sequential
    w = words[0].numpy()
    payload, nbits, _flushes = sequential.encode_emissions(
        w & 1, (w >> 1) & 31, (w >> 6) & 1)
    return payload, nbits


def encode_plane_payload(seg_data: np.ndarray, subband_type: int, lsb: int,
                         mag_bits: int):
    """One segment plane: the plain sort coder (ops/entropy_sorted) on CPU
    tensors, or the sequential coder where the plane needs the
    reorder-window flush.  Returns (payload bytes, bit length)."""
    from ..ops.entropy_sorted import encode_emissions_sorted
    words = _plane_words(seg_data, subband_type, lsb, mag_bits)
    payload, total, flag = encode_emissions_sorted(
        words & 1, (words >> 1) & 31, (words >> 6) & 1)
    if bool(flag[0]):
        return _sequential_payload(words)
    nbits = int(total[0])
    return payload[0, :(nbits + 7) // 8].numpy().tobytes(), nbits


def encode_plane_payload_sequential(seg_data: np.ndarray, subband_type: int,
                                    lsb: int, mag_bits: int):
    """One segment plane through the sequential coder (the reference the
    others are held to).  Returns (payload bytes, bit length)."""
    return _sequential_payload(_plane_words(seg_data, subband_type, lsb,
                                            mag_bits))


def all_subbands(stages: int):
    """Every (stage, subband) of an N-stage decomposition."""
    out = []
    for stage in range(1, stages + 1):
        if stage == stages:
            out.append((stage, C.SUBBAND_LL))
        out += [(stage, C.SUBBAND_HL), (stage, C.SUBBAND_LH),
                (stage, C.SUBBAND_HH)]
    return out


def _native_task(view, rect, w: int, subband: int, mag_bits: int,
                 lsb0: int = 0) -> dict:
    return {"seg_off": (view.row + rect.row) * w + (view.col + rect.col),
            "h": rect.h, "w": rect.w, "rowstride": w, "subband": subband,
            "mag_bits": mag_bits, "lsb0": lsb0}


def encode_channel_native(img_t: np.ndarray, config: CodecConfig,
                          mag_bits: int, bitplanes: int) -> dict:
    """All (stage, subband, lsb, seg) payloads of one transformed channel
    through the native runtime (every bitplane of every segment, threaded
    over segments)."""
    from ..backend import native_backend
    h, w = img_t.shape
    tasks, keys = [], []
    for stage, subband in all_subbands(config.stages):
        view = subband_view(w, h, stage, subband)
        for rect in partition_segments(view.w, view.h, config.segments):
            tasks.append(_native_task(view, rect, w, subband, mag_bits))
            keys.append((stage, subband, rect.index))
    out, bits = native_backend.encode_segments_native(
        np.ascontiguousarray(img_t, dtype=np.int32), tasks, bitplanes)
    table = {}
    for i, (stage, subband, seg) in enumerate(keys):
        for lsb in range(bitplanes):
            r = i * bitplanes + lsb
            nb = int(bits[r])
            table[(stage, subband, lsb, seg)] = (
                out[r, :(nb + 7) // 8].tobytes(), nb)
    return table


def _header(pkt, seg: int, w: int, h: int, nbits: int) -> SegmentHeader:
    return SegmentHeader(
        ll_mean_val=pkt.ll_mean_val, decomp_level=pkt.decomp_level,
        subband_type=pkt.subband_type, segment_number=seg, lsb=pkt.lsb,
        channel=pkt.channel, image_w=w, image_h=h, data_length=nbits)


def encode_per_plane(chans: dict, packets, config: CodecConfig,
                     mag_bits: int, w: int, h: int, encode_plane) -> dict:
    """The per-plane quota loop: packets in priority order, each segment
    plane of ``chans[packet.channel]`` (a transformed image) through
    ``encode_plane``, stopping at the quota as the reference does (header
    released, all coding stopped: icer_partition.c:323-326,
    icer_compress.c:404).  Returns the encoded dict for
    ``assemble_stream``."""
    quota = config.byte_quota
    size_used = 0
    encoded: dict[tuple, tuple[SegmentHeader, bytes]] = {}
    for pkt in packets:
        view = subband_view(w, h, pkt.decomp_level, pkt.subband_type)
        sub = chans[pkt.channel][view.row:view.row + view.h,
                                 view.col:view.col + view.w]
        for rect in partition_segments(view.w, view.h, config.segments):
            if quota is not None and quota - size_used < C.HEADER_SIZE:
                return encoded
            payload, nbits = encode_plane(
                sub[rect.row:rect.row + rect.h, rect.col:rect.col + rect.w],
                pkt.subband_type, pkt.lsb, mag_bits)
            if quota is not None \
                    and nbits >= 8 * (quota - size_used - C.HEADER_SIZE):
                return encoded
            hdr = _header(pkt, rect.index, w, h, nbits)
            encoded[(pkt.channel, pkt.decomp_level, pkt.subband_type,
                     pkt.lsb, rect.index)] = (hdr, payload)
            size_used += C.HEADER_SIZE + hdr.payload_bytes
    return encoded


def encode_native_tranches(chans: dict, packets, config: CodecConfig,
                           mag_bits: int, w: int, h: int) -> dict:
    """The quota-aware native encode (the JAX package's
    ``_encode_allocate_native_tranches``): the sorted packets in tranches
    of geometrically growing size (each packet one (stage, subband, lsb) x
    segments batch of single-plane native tasks on ``chans[channel]``, a
    transformed image), with the exact allocation interleaved, so coding
    stops at the packet where the reference stops (icer_compress.c:404,
    icer_partition.c:323-326) instead of coding every plane and
    truncating.  Streams equal the per-plane loop's at any quota."""
    from ..backend import native_backend
    views = {c: np.ascontiguousarray(v, dtype=np.int32)
             for c, v in chans.items()}
    quota = config.byte_quota
    npk = len(packets)
    k = npk if quota is None else max(8, min(npk, (npk * quota)
                                             // max(1, h * w)))
    rect_cache: dict[tuple, tuple] = {}

    def rects_of(pkt):
        key = (pkt.decomp_level, pkt.subband_type)
        if key not in rect_cache:
            view = subband_view(w, h, *key)
            rect_cache[key] = (view, partition_segments(view.w, view.h,
                                                        config.segments))
        return rect_cache[key]

    encoded: dict[tuple, tuple[SegmentHeader, bytes]] = {}
    size_used = 0
    i = 0
    while i < npk:
        tranche = packets[i:i + k]
        i += k
        k *= 2
        tasks, tmeta = [], []
        for pkt in tranche:
            view, rects = rects_of(pkt)
            for rect in rects:
                tasks.append(_native_task(view, rect, w, pkt.subband_type,
                                          mag_bits, pkt.lsb))
                tmeta.append((pkt, rect))
        # one native call per channel of the tranche
        outs = [None] * len(tasks)
        bits = np.zeros(len(tasks), dtype=np.int64)
        for chan in sorted({p.channel for p in tranche}):
            idxs = [j for j, (p, _) in enumerate(tmeta) if p.channel == chan]
            o, b = native_backend.encode_segments_native(
                views[chan], [tasks[j] for j in idxs], 1)
            for r, j in enumerate(idxs):
                outs[j] = o[r]
                bits[j] = b[r]
        for j, (pkt, rect) in enumerate(tmeta):
            if quota is not None and quota - size_used < C.HEADER_SIZE:
                return encoded
            nbits = int(bits[j])
            if quota is not None \
                    and nbits >= 8 * (quota - size_used - C.HEADER_SIZE):
                return encoded
            hdr = _header(pkt, rect.index, w, h, nbits)
            encoded[(pkt.channel, pkt.decomp_level, pkt.subband_type,
                     pkt.lsb, rect.index)] = (
                hdr, outs[j][:(nbits + 7) // 8].tobytes())
            size_used += C.HEADER_SIZE + hdr.payload_bytes
    return encoded


def scan_table(data: bytes, nchan: int, max_pixels: int | None):
    """The host decode's scan: {(chan, stage, subband, seg, lsb):
    (payload offset, data_length)} over every valid segment, the image's
    (w, h) and the ``nchan`` channels' LL means.  With one channel the
    header's channel nibble is ignored (the reference's grayscale
    decoder); with three it keys the table.  Raises on a stream with no
    valid segment and on dimensions past ``max_pixels`` (default
    ``models.decode.DEFAULT_MAX_PIXELS``)."""
    if max_pixels is None:
        from .decode import DEFAULT_MAX_PIXELS
        max_pixels = DEFAULT_MAX_PIXELS
    found = scan_bytestream(data, with_offsets=True, with_payload=False)
    if not found:
        raise IcerError(IcerStatus.DECODER_OUT_OF_DATA, "no valid segments")
    table: dict[tuple, tuple[int, int]] = {}
    w = h = 0
    ll_means = [0] * nchan
    for hdr, _payload, off in found:
        chan = hdr.channel if nchan > 1 else 0
        table[(chan, hdr.decomp_level, hdr.subband_type, hdr.segment_number,
               hdr.lsb)] = (off, hdr.data_length)
        w, h = hdr.image_w, hdr.image_h
        if chan < nchan:
            ll_means[chan] = hdr.ll_mean_val
    if w <= 0 or h <= 0 or w * h > max_pixels:
        raise IcerError(
            IcerStatus.INVALID_INPUT,
            f"header dimensions {w}x{h} exceed max_pixels={max_pixels}")
    return table, (w, h), ll_means


def finish_channel(img: np.ndarray, ll_mean: int, config: CodecConfig,
                   mag_bits: int, dtype, native: bool = False) -> np.ndarray:
    """A decoded sign-magnitude channel to pixels: two's complement, the LL
    mean added back, the inverse DWT (native runtime with ``native``) and
    the clamp at 0."""
    from ..ops import wavelet
    h, w = img.shape
    t = wavelet.from_sign_magnitude(torch.from_numpy(img), mag_bits)
    ll_w = dim_low(w, config.stages)
    ll_h = dim_low(h, config.stages)
    t[:ll_h, :ll_w] = wavelet._wrap(t[:ll_h, :ll_w] + ll_mean, mag_bits)
    out = inverse_transform(t.numpy(), config.stages, config.filt, mag_bits,
                            native=native)
    out[out < 0] = 0
    return out.astype(dtype)


def reconstruct_channel(img: np.ndarray, table: dict, chan: int,
                        config: CodecConfig, mag_bits: int, bitplanes: int,
                        stream: bytes, decode_partition=None,
                        native: bool = False) -> None:
    """Decode every subband of one channel into ``img`` (sign-magnitude,
    in place) on the host: with ``native`` the runtime's threaded segment
    decoder, else segment by segment through ``decode_partition``
    (default ``backend/decode_plane.decode_segment_planes``, the
    sequential decoder).

    Table values are (payload offset, bit length) into ``stream``, which
    is decoded in place: the reference's zero-copy decoding, where a plane
    decode driven past its data_length (out of contract, e.g. by content
    past 9 bitplanes) reads the following stream bytes, as the C decoder
    does (icer_compress.c:449-459 keeps pointers into the datastream)."""
    h, w = img.shape
    if native:
        if decode_partition is not None:
            raise ValueError("a decode_partition hook runs on the 'python' "
                             "backend")
        from ..backend import native_backend
        tasks = collect_decode_tasks((h, w), table, chan, config, mag_bits,
                                     bitplanes)
        if tasks:
            native_backend.decode_segments_native(img, tasks, stream)
        return
    if decode_partition is None:
        from ..backend.decode_plane import decode_segment_planes
        decode_partition = decode_segment_planes
    mv = memoryview(stream)
    for stage, subband in decode_subband_order(config.stages):
        view = subband_view(w, h, stage, subband)
        sub = img[view.row:view.row + view.h, view.col:view.col + view.w]
        for rect in partition_segments(view.w, view.h, config.segments):
            planes = {}
            for lsb in range(bitplanes):
                ent = table.get((chan, stage, subband, rect.index, lsb))
                if ent is not None:
                    planes[lsb] = (mv[ent[0]:], ent[1])
            decode_partition(sub[rect.row:rect.row + rect.h,
                                 rect.col:rect.col + rect.w],
                             subband, mag_bits, planes, bitplanes)


def collect_decode_tasks(img_shape, table: dict, chan: int,
                         config: CodecConfig, mag_bits: int,
                         bitplanes: int) -> list[dict]:
    """A channel's decode work as independent segment tasks of the native
    runtime (disjoint rectangles, so they run on threads at once), each
    plane's (stream offset, bit length) from ``table``: the runtime reads
    the stream itself (zero-copy, the reference's over-read)."""
    h, w = img_shape
    tasks = []
    for stage, subband in decode_subband_order(config.stages):
        view = subband_view(w, h, stage, subband)
        for rect in partition_segments(view.w, view.h, config.segments):
            planes = {lsb: table[key] for lsb in range(bitplanes)
                      if (key := (chan, stage, subband, rect.index, lsb))
                      in table}
            if planes:
                task = _native_task(view, rect, w, subband, mag_bits)
                task.update(nplanes=bitplanes, planes=planes)
                tasks.append(task)
    return tasks
