"""Colour (YUV) ICER codec entry points.

Counterpart: ``icer_compression_tpu/models/color.py`` (``_yuv_quota_classes``,
``compress_yuv_jax``, ``compress_yuv_batch``, ``decompress_yuv``), itself the
reference's ``icer_compress_image_yuv_uint8/uint16`` and decoders
(lib_icer/src/icer_color.c).  The three planes encode as channel canvases
of one batch through the grayscale encoder (ops/encode, kernel 1), with one
rate allocation over the three-channel packet list (Y packets get the
cumulative priority doubling of icer_color.c:404), the channel id in the
header's lsb_chan nibble and the format's rearrangement order (uint8
ascending, icer_color.c:186-203; uint16 descending, icer_color.c:510-527).
The decode runs the lane-batched decoder over 3 canvases per stream
(models/decode, kernel 2).  Streams are byte-identical and decodes
pixel-identical to the JAX package's.

``compress_yuv`` and ``decompress_yuv`` also take the host codec's
``backend`` (``"native"``; ``"numpy"`` with the ``encode_plane`` hook,
``"python"`` with ``decode_partition``), as in models/grayscale: the
native encode runs the quota-aware tranche allocator over the three
channels' transformed images.

Every card entry point takes ``device=None``, which means ``"cuda"``;
without a CUDA device the caller must pass ``device="cpu"``.
"""

from __future__ import annotations

import numpy as np

from ..core.packets import (build_packets_color, rearrange_order_color_uint8,
                            rearrange_order_color_uint16, sort_packets)
from ..core.status import IcerError, IcerStatus
from ..device import resolve_device
from ..utils import trace
from .grayscale import (DECODE_BACKENDS, ENCODE_BACKENDS, PLANE_MASS,
                        CodecConfig, _bitplanes, _cached_encoder, _mag_bits,
                        _pick_backend, allocate_from_table, assemble_stream,
                        encode_native_tranches, encode_per_plane,
                        encode_plane_payload, finish_channel,
                        reconstruct_channel, scan_table,
                        transform_for_encode)

_YUV_QUOTA_CLASSES: dict[tuple, list] = {}


def yuv_quota_classes(w: int, h: int, stages: int, bitplanes: int):
    """Priority-prefix classes for quota-aware colour encoding: [(model
    fraction, cuts)], as ``grayscale.quota_classes`` but over the colour
    packet order (Y-priority doubling included).  The three channels share
    one batched encode, so a class's cut per stage group is the lowest lsb
    that any channel's prefix packet needs (a superset for U and V, which
    only costs planes that are encoded and not allocated)."""
    cached = _YUV_QUOTA_CLASSES.get((w, h, stages, bitplanes))
    if cached is not None:
        return cached
    packets = sort_packets(build_packets_color(w, h, stages, [0, 0, 0],
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
        cuts[p.decomp_level - 1] = min(cuts[p.decomp_level - 1], p.lsb)
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
    _YUV_QUOTA_CLASSES[(w, h, stages, bitplanes)] = classes
    return classes


def _check_planes(y, u, v):
    """(y, u, v) as arrays of one shape and dtype, and their mag_bits."""
    y, u, v = (np.asarray(c) for c in (y, u, v))
    if not (y.shape == u.shape == v.shape and y.dtype == u.dtype == v.dtype):
        raise IcerError(IcerStatus.INVALID_INPUT, "channel mismatch")
    return y, u, v, _mag_bits(y.dtype)


def _rearrange_order(mag_bits: int, bitplanes: int):
    return (rearrange_order_color_uint8(bitplanes) if mag_bits == 7
            else rearrange_order_color_uint16(bitplanes))


def _allocate_yuv(results, config, w, h, bitplanes, order) -> bytes:
    """One image's stream from its three channels' (payload_table,
    ll_mean); raises KeyError when the quota admits a packet the tables
    lack."""
    ll_means = [mean for _table, mean in results]
    table = {(c,) + k: val for c, (t, _mean) in enumerate(results)
             for k, val in t.items()}
    packets = sort_packets(build_packets_color(w, h, config.stages, ll_means,
                                               bitplanes))
    nsegs = {(p.decomp_level, p.subband_type): config.segments
             for p in packets}
    encoded = allocate_from_table(packets, table, config.byte_quota, nsegs,
                                  w, h)
    return assemble_stream(encoded, order)


def compress_yuv(y: np.ndarray, u: np.ndarray, v: np.ndarray,
                 config: CodecConfig, device=None, encode_plane=None,
                 backend: str | None = None) -> bytes:
    """Compress three equally sized channel planes (uint8 or uint16) into
    one stream.  On the card (``backend="device"``, the default) the
    planes encode as one (3, h, w) batch, only the priority-prefix
    bitplanes of the quota's class; when the allocation needs a plane
    outside it, the encode widens to the next class and codes only the
    planes that adds.  ``"native"`` and ``"numpy"`` (or an
    ``encode_plane`` hook) run the host codec, as ``grayscale.compress``
    does."""
    y, u, v, mag_bits = _check_planes(y, u, v)
    if y.ndim != 2:
        raise IcerError(IcerStatus.INVALID_INPUT, "expected (h, w) planes")
    backend = _pick_backend(backend, encode_plane, ENCODE_BACKENDS, "numpy")
    bitplanes = _bitplanes(mag_bits)
    h, w = y.shape
    if backend != "device":
        return _compress_yuv_host((y, u, v), config, mag_bits, backend,
                                  encode_plane or encode_plane_payload)
    dev = resolve_device(device)
    try:
        classes = yuv_quota_classes(w, h, config.stages, bitplanes)
    except IcerError as e:
        if e.status != IcerStatus.PACKET_COUNT_EXCEEDED:
            raise
        # the reference transforms the channels before it builds the
        # packet list (icer_color.c), so a DWT or LL-mean overflow is
        # refused first: the full encode raises it, else the allocation
        # raises the packet count
        return compress_yuv_batch([y], [u], [v], config, device=dev)[0]
    quota = config.byte_quota
    if quota is None:
        ci = len(classes) - 1
    else:
        # byte coverage needed: the quota as a fraction of a lossless
        # stream of three channels (~0.65 x raw each), 1.7x headroom
        want = min(1.0, 1.7 * quota / max(1, 3 * 0.65 * h * w))
        ci = next((i for i, (frac, _) in enumerate(classes)
                   if frac >= want), len(classes) - 1)
    order = _rearrange_order(mag_bits, bitplanes)
    stacked = np.stack([y, u, v])
    tables, means = [{}, {}, {}], [0, 0, 0]
    prev = (bitplanes,) * config.stages
    while True:
        cuts = classes[ci][1]
        windows = tuple((lo, hi) for lo, hi in zip(cuts, prev))
        if any(lo < hi for lo, hi in windows):
            enc = _cached_encoder(w, h, config.stages, config.filt,
                                  config.segments, mag_bits, "auto", dev,
                                  windows)
            for chan, (table, mean) in enumerate(enc.encode_batch(stacked)):
                tables[chan].update(table)
                means[chan] = mean
            prev = tuple(min(a, b) for a, b in zip(cuts, prev))
        try:
            return _allocate_yuv(list(zip(tables, means)), config, w, h,
                                 bitplanes, order)
        except KeyError:
            # the quota admits more than the encoded prefix: widen
            if ci + 1 >= len(classes):
                raise
            ci += 1


def _compress_yuv_host(planes, config, mag_bits, backend, encode_plane):
    """The host codec's colour encode: each channel transformed on the
    host, one packet list over the three (Y-priority doubling), then the
    native tranche allocator or the per-plane quota loop."""
    bitplanes = _bitplanes(mag_bits)
    h, w = planes[0].shape
    native = backend == "native"
    chans, ll_means = {}, []
    for c, plane in enumerate(planes):
        chans[c], mean = transform_for_encode(plane, config.stages,
                                              config.filt, mag_bits,
                                              native=native)
        ll_means.append(mean)
    packets = sort_packets(build_packets_color(w, h, config.stages, ll_means,
                                               bitplanes))
    if native:
        encoded = encode_native_tranches(chans, packets, config, mag_bits,
                                         w, h)
    else:
        encoded = encode_per_plane(chans, packets, config, mag_bits, w, h,
                                   encode_plane)
    return assemble_stream(encoded, _rearrange_order(mag_bits, bitplanes))


def compress_yuv_batch(ys, us, vs, config: CodecConfig, device=None,
                       defer: bool = False):
    """Compress B same-geometry colour images (``ys``, ``us``, ``vs``: B
    planes each).  All 3B channel canvases encode in one batch, image by
    image (each image's Y, U and V in turn), with every bitplane; each
    device pass uploads its own canvases, so the batch is never stacked
    on the host.  Each image's rate allocation and stream assembly run as
    soon as its three canvases are collected, so the collector follows
    the card pass by pass and little host work is left once the last
    pass is done.  Returns one stream per image, each equal to
    ``compress_yuv`` of its planes; with ``defer`` a zero-argument
    collector of that list (the encode's dispatch half has run, the
    collector waits for the card).  Under ``torch.profiler``
    (utils/trace) the checks and the ordering of the planes run in a span
    ``color.stack`` and each image's allocation in a span ``alloc.yuv``;
    the call counts ``color.images`` (B) and ``color.canvases`` (3B)."""
    with trace.span("color.stack"):
        chans = [[np.asarray(p) for p in c] for c in (ys, us, vs)]
        if not chans[0] or len({len(c) for c in chans}) != 1 or len(
                {(p.shape, p.dtype) for c in chans for p in c}) != 1:
            raise IcerError(IcerStatus.INVALID_INPUT, "channel mismatch")
        if chans[0][0].ndim != 2:
            raise IcerError(IcerStatus.INVALID_INPUT,
                            "expected B (h, w) planes")
        mag_bits = _mag_bits(chans[0][0].dtype)
        canvases = [p for planes in zip(*chans) for p in planes]
    B = len(chans[0])
    h, w = chans[0][0].shape
    trace.count("color.images", B)
    trace.count("color.canvases", len(canvases))
    bitplanes = _bitplanes(mag_bits)
    full = ((0, bitplanes),) * config.stages
    enc = _cached_encoder(w, h, config.stages, config.filt, config.segments,
                          mag_bits, "auto", resolve_device(device), full)
    order = _rearrange_order(mag_bits, bitplanes)
    got, streams = [], []

    def each(result):
        got.append(result)
        if len(got) == 3:
            with trace.span("alloc.yuv"):
                streams.append(_allocate_yuv(got, config, w, h, bitplanes,
                                             order))
            got.clear()

    res = enc.encode_batch(canvases, defer=defer, each=each)
    if not defer:
        return streams

    def collect():
        res()
        return streams
    return collect


def decompress_yuv(data: bytes, config: CodecConfig, dtype=np.uint16,
                   device=None, max_pixels: int | None = None,
                   decode_partition=None, backend: str | None = None,
                   graph: bool | None = None):
    """Decompress one colour stream into its (y, u, v) planes.
    ``max_pixels`` (default ``models.decode.DEFAULT_MAX_PIXELS``) bounds the
    canvas the untrusted header may ask for.  A channel whose every segment
    the quota cut decodes to zeros with LL mean 0 (the reference leaves
    that case undefined, icer_color.c:229/555).  ``backend`` and
    ``decode_partition`` as in ``grayscale.decompress``: the host paths
    key the scan by the header's channel and decode each channel in
    turn.  ``graph`` (device backend) as in
    ``models.decode.decompress_batch``."""
    backend = _pick_backend(backend, decode_partition, DECODE_BACKENDS,
                            "python")
    if backend == "device":
        from .decode import decompress_yuv_batch
        return decompress_yuv_batch([data], config, dtype=dtype,
                                    device=device, max_pixels=max_pixels,
                                    graph=graph)[0]
    mag_bits = _mag_bits(dtype)
    bitplanes = _bitplanes(mag_bits)
    table, (w, h), ll_means = scan_table(data, 3, max_pixels)
    native = backend == "native"
    out = []
    for chan in range(3):
        img = np.zeros((h, w), dtype=np.int32)
        reconstruct_channel(img, table, chan, config, mag_bits, bitplanes,
                            data, decode_partition, native=native)
        out.append(finish_channel(img, ll_means[chan], config, mag_bits,
                                  dtype, native=native))
    return tuple(out)
