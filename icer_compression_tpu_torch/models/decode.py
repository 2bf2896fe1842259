"""Lane-batched decode of grayscale and colour streams: host plan, kernel 2,
device finalize, each pass one captured CUDA graph per plan key.

Counterpart: ``icer_compression_tpu/models/decode_jax.py`` (``_plan_lanes``,
``_decode_batch`` with its per-round offset plan over ``nchan`` channel
canvases, the finalize and the plan key ``fkey`` of ``_run_fused``,
``decompress_lanes_batch`` and ``decompress_yuv_lanes_batch``).  A batch
of B streams of one geometry decodes as B * nchan channel canvases, canvas
``c = b * nchan + chan``.
Segments are bucketed by subband geometry; each bucket's lanes (of every
canvas) decode all their plane rounds in one kernel-2 launch that reads the
concatenated streams in place, so no stream windows are gathered and no
lane is re-decoded on the host (the JAX ``_finish`` hazard re-decode has
nothing to do here).  The buckets' launches go to streams of their own, so
they overlap on the card.  The finalize (canvas assembly, sign-magnitude,
LL mean, inverse DWT, clamp) runs as PyTorch ops on the device for all
canvases at once.  A batch whose streams join to more than kernel 2 can
address decodes in passes of at most ``PASS_BYTES`` bytes each.

A pass is a host plan (``plan_batch``: the headers' scan, each unit's
offsets) and a device pass (``device_pass``: kernel 2's units, the
finalize, the pixels narrowed to the caller's sample width) that holds
no host copy and no sync; its pixels come back to the host in one copy.
As the JAX decoder runs one jitted program per plan key, the device pass
runs as one captured CUDA graph per plan key (``DecodePlan.key``) on the
card by default
(``graph=``; ``backend/graph_cache``): eager at the key's first two
passes, captured by the second's collector and held bit for bit to it on
its first replay, replayed after.  The joined streams are padded to a
multiple of ``STREAM_PAD`` bytes (the JAX decoder's ``_STREAM_PAD``) so
that keys repeat across streams of other lengths; each lane's reads stop
at its own stream's end (``lane_end``), so the padding is never read.
The canvas index and the lanes' geometry depend on the key alone and stay
on the device (``key_tables``), as the JAX program bakes its placements
in; the graph cache keeps them with its record of the key, under the
graphs' bound.

Under ``torch.profiler`` (utils/trace) a pass records the spans
``decode.plan``, ``decode.dispatch`` (upload, run and the copy back),
``decode.wait``, ``decode.capture`` and ``decode.unpack``, and the count
``decode.passes``; ``device_pass`` marks kernel 2 and the finalize on the
card whether or not the profiler records.
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch

from ..backend import graph_cache
from ..core.header import scan_bytestream
from ..core.partition import partition_segments
from ..core.status import IcerError, IcerStatus
from ..core.subbands import decode_subband_order, dim_low, subband_view
from ..device import Pending, resolve_device, to_device, to_host
from ..ops import wavelet
from ..ops.plane_decode import MAX_STREAM_BYTES, decode_planes
from ..utils import trace
from .grayscale import CodecConfig, _bitplanes, _mag_bits

# Decode-side allocation guard: header dimensions come from the
# (untrusted) stream; bound the canvas they can request (the JAX package's
# ``grayscale.DEFAULT_MAX_PIXELS``).
DEFAULT_MAX_PIXELS = 1 << 28

# Bytes of joined streams one decode pass reads at most: kernel 2 reads a
# pass's streams as one blob and keeps its bit positions in 32 bits.
PASS_BYTES = MAX_STREAM_BYTES

# A pass's joined streams are padded to a multiple of this (the JAX
# decoder's ``_STREAM_PAD``), and at most to kernel 2's limit
STREAM_PAD = 1 << 18


def padded(nbytes: int) -> int:
    """Bytes of a pass's blob of ``nbytes`` joined stream bytes: the next
    multiple of ``STREAM_PAD``, below kernel 2's limit."""
    return max(nbytes, min(-(-nbytes // STREAM_PAD) * STREAM_PAD,
                           MAX_STREAM_BYTES - 1))


def _plan_lanes(w, h, config):
    """Per-segment lane records grouped into equal-geometry buckets."""
    buckets = {}
    for (stage, subband) in decode_subband_order(config.stages):
        view = subband_view(w, h, stage, subband)
        rects = partition_segments(view.w, view.h, config.segments)
        b = buckets.setdefault((view.w, view.h), [])
        for rect in rects:
            b.append({
                "stage": stage, "subband": subband, "seg": rect.index,
                "row": view.row + rect.row, "col": view.col + rect.col,
                "h": rect.h, "w": rect.w,
            })
    return list(buckets.values())


def plan_batch(streams, config: CodecConfig, dtype, nchan: int = 1,
               max_pixels: int = DEFAULT_MAX_PIXELS, pad: bool = False):
    """Host side of a batched decode: scan every stream and lay out each
    bucket's kernel-2 inputs.  Returns (w, h, ll_means, blob, units) with
    ll_means one per canvas and units = [{bucket, lanes, n1, offs (R, n),
    ebits (R, n), lane_end (n,), geom (3, n), hmax, wmax}] (numpy int32),
    lane j of a unit being segment lanes[j % n1] of canvas j // n1 and
    ``bucket`` its index in the geometry's buckets.  ``pad``: the blob
    zero-padded to ``padded`` bytes."""
    with trace.span("decode.plan"):
        bitplanes = _bitplanes(_mag_bits(dtype))
        B = len(streams)
        if B == 0:
            raise IcerError(IcerStatus.INVALID_INPUT, "no streams")
        NC = B * nchan
        tables = []
        ll_means = [0] * NC
        w = h = 0
        for b, data in enumerate(streams):
            found = scan_bytestream(data, with_offsets=True,
                                    with_payload=False)
            if not found:
                raise IcerError(IcerStatus.DECODER_OUT_OF_DATA,
                                "no valid segments")
            t: dict = {}
            for hdr, _p, off in found:
                # grayscale ignores the channel nibble, as the reference's
                # grayscale decoder does (last in stream wins on duplicates);
                # colour keys by it
                chan = hdr.channel if nchan > 1 else 0
                t[(chan, hdr.decomp_level, hdr.subband_type,
                   hdr.segment_number, hdr.lsb)] = (off, hdr.data_length)
                wi, hi = hdr.image_w, hdr.image_h
                if chan < nchan:
                    ll_means[b * nchan + chan] = hdr.ll_mean_val
            if w == 0:
                w, h = wi, hi
            elif (w, h) != (wi, hi):
                raise IcerError(IcerStatus.INVALID_INPUT,
                                "batched streams must share geometry")
            tables.append(t)
        if w <= 0 or h <= 0 or w * h > max_pixels:
            raise IcerError(
                IcerStatus.INVALID_INPUT,
                f"header dimensions {w}x{h} exceed max_pixels={max_pixels}")
        bases = np.cumsum([0] + [len(s) for s in streams])
        blob = np.zeros(padded(int(bases[-1])) if pad else int(bases[-1]),
                        np.uint8)
        blob[:bases[-1]] = np.frombuffer(b"".join(streams), np.uint8)

        units = []
        for bucket, lanes in enumerate(_plan_lanes(w, h, config)):
            n1 = len(lanes)
            n = n1 * NC
            keys = [(t["stage"], t["subband"], t["seg"]) for t in lanes]
            offs_r, ebits_r = [], []
            for rnd in range(bitplanes):
                lsb = bitplanes - 1 - rnd
                offs = np.full(n, -1, np.int64)
                ebits = np.zeros(n, np.int64)
                for c in range(NC):
                    b, chan = divmod(c, nchan)
                    for i, k in enumerate(keys):
                        ent = tables[b].get((chan,) + k + (lsb,))
                        if ent is not None:
                            offs[c * n1 + i] = bases[b] + ent[0]
                            ebits[c * n1 + i] = ent[1]
                if not (offs >= 0).any():
                    # every lane retires at its first missing plane
                    break
                offs_r.append(offs)
                ebits_r.append(np.minimum(ebits, 2 ** 31 - 1))
            if not offs_r:
                continue
            geom = np.array([[t["h"] for t in lanes], [t["w"] for t in lanes],
                             [t["subband"] for t in lanes]], np.int32)
            units.append({
                "bucket": bucket, "lanes": lanes, "n1": n1,
                "offs": np.stack(offs_r).astype(np.int32),
                "ebits": np.stack(ebits_r).astype(np.int32),
                # a lane reads up to its image's end, shared by its channels
                "lane_end": np.repeat(np.repeat(bases[1:], nchan),
                                      n1).astype(np.int32),
                "geom": np.tile(geom, (1, NC)),
                "hmax": max(t["h"] for t in lanes),
                "wmax": max(t["w"] for t in lanes),
            })
        return w, h, ll_means, blob, units


def unit_inputs(units, device):
    """Each unit's kernel-2 inputs as tensors on ``device``: a list of
    (offs, ebits, lane_end, geom, hmax, wmax)."""
    return [tuple(to_device(u[k], device)
                  for k in ("offs", "ebits", "lane_end", "geom"))
            + (u["hmax"], u["wmax"]) for u in units]


def decode_units(stream_t, inputs, lsb0: int, mag_bits: int):
    """Kernel 2 over every unit; returns each unit's (out, err, pos).

    On the card each unit launches on a stream of its own, so the units'
    lanes are in flight at once, and the caller's stream waits for all of
    them.  The side streams fork from the caller's stream and join it, so
    inside a graph capture they join the capture.  Every tensor crossing
    streams is recorded on the stream that uses it, so the caching
    allocator does not hand it out early (during a capture the allocator
    defers those records until the capture ends)."""
    if stream_t.device.type != "cuda":
        return [decode_planes(stream_t, *a, lsb0, mag_bits) for a in inputs]
    main = torch.cuda.current_stream(stream_t.device)
    sides = [torch.cuda.Stream(stream_t.device) for _ in inputs]
    results = []
    for side, a in zip(sides, inputs):
        side.wait_stream(main)
        for t in (stream_t,) + a[:4]:
            t.record_stream(side)
        with torch.cuda.stream(side):
            results.append(decode_planes(stream_t, *a, lsb0, mag_bits))
    for side, res in zip(sides, results):
        main.wait_stream(side)
        for t in res:
            t.record_stream(main)
    return results


def _canvas_index(units, NC, w, h):
    """Gather index from the concatenated unit outputs (+ one trailing
    zero) into the (NC, h, w) sign-magnitude canvases, as two (h, w)
    planes: canvas c's index is ``first + c * step``.  Int32 unless the
    outputs outgrow it."""
    total = sum(u["hmax"] * u["wmax"] * u["n1"] * NC for u in units)
    dt = np.int32 if total < 2 ** 31 else np.int64
    first = np.full((h, w), total, dt)
    step = np.zeros((h, w), dt)
    base = 0
    for u in units:
        n1, wmax = u["n1"], u["wmax"]
        n = n1 * NC
        for i, t in enumerate(u["lanes"]):
            rr = np.arange(t["h"])[:, None]
            cc = np.arange(t["w"])[None, :]
            rows = slice(t["row"], t["row"] + t["h"])
            cols = slice(t["col"], t["col"] + t["w"])
            first[rows, cols] = base + (rr * wmax + cc) * n + i
            step[rows, cols] = n1
        base += u["hmax"] * wmax * n
    return first, step


class KeyTables:
    """What a decode pass reads that its key alone fixes, on the device:
    the canvas index (``first``, ``step``: ``_canvas_index``) and each
    unit's lane geometry (3, n)."""

    def __init__(self, units, NC, w, h, dev):
        self.first, self.step = (to_device(a, dev)
                                 for a in _canvas_index(units, NC, w, h))
        self.geoms = [to_device(u["geom"], dev) for u in units]
        self.device = self.first.device
        self.nbytes = sum(t.numel() * t.element_size()
                          for t in [self.first, self.step, *self.geoms])


def key_tables(key, units, NC, w, h, dev) -> KeyTables:
    """The ``KeyTables`` of the pass ``key`` on ``dev``, made once per key
    and kept by ``graph_cache.CACHE`` with its record of the key (counted
    against the graphs' bound)."""
    return graph_cache.CACHE.owner(
        key, lambda: KeyTables(units, NC, w, h, dev), dev)


def finalize(outs, tables: KeyTables, llv, w: int, h: int,
             config: CodecConfig, mag_bits: int):
    """The decode's finalize on the device: each unit's kernel-2 output
    (hmax * wmax, n) gathered into the len(llv) sign-magnitude canvases
    through ``tables``' canvas index, two's complement, the LL means
    ``llv`` (int32 on the device) added back, the inverse DWT and the
    clamp at 0.  Returns the pixels (NC, h, w) int32."""
    NC = llv.shape[0]
    dev = llv.device
    flat = [o.reshape(-1) for o in outs]
    flat.append(torch.zeros(1, dtype=torch.int32, device=dev))
    first, step = tables.first, tables.step
    gidx = first + torch.arange(NC, dtype=first.dtype,
                                device=dev)[:, None, None] * step
    canvas = torch.cat(flat).index_select(0, gidx.reshape(-1)) \
        .reshape(NC, h, w)
    img = wavelet.from_sign_magnitude(canvas, mag_bits)
    ll_w = dim_low(w, config.stages)
    ll_h = dim_low(h, config.stages)
    img[:, :ll_h, :ll_w] = wavelet._wrap(
        img[:, :ll_h, :ll_w] + llv[:, None, None], mag_bits)
    img, _ov = wavelet.inverse_stages(img, config.stages, config.filt,
                                      mag_bits)
    return torch.clamp(img, min=0)


def narrow(px, mag_bits: int):
    """The finalized pixels ``px`` (int32) at the sample width that
    ``mag_bits`` fixes, on their device: the low 8 bits as uint8
    (mag_bits 7), else the low 16 bits as int16, which the host reads as
    uint16.  Those are the bits NumPy's ``astype`` of the wide pixels to
    ``uint8`` or ``uint16`` keeps."""
    return px.to(torch.uint8 if mag_bits == 7 else torch.int16)


def _passes(streams):
    """[start, end) ranges of consecutive streams whose joined bytes stay
    below ``PASS_BYTES``; a single stream that reaches it raises."""
    ranges, start, size = [], 0, 0
    for i, s in enumerate(streams):
        if len(s) >= PASS_BYTES:
            raise IcerError(
                IcerStatus.INVALID_INPUT,
                f"a stream of {len(s)} bytes reaches the decoder's limit of "
                f"{PASS_BYTES} bytes")
        if size + len(s) >= PASS_BYTES:
            ranges.append((start, i))
            start, size = i, 0
        size += len(s)
    ranges.append((start, len(streams)))
    return ranges


def unit_views(meta, at: int, shapes, fields=("offs", "ebits", "lane_end")):
    """Each unit's kernel-2 inputs as views of the int32 tensor ``meta``
    from element ``at`` on, where they lie raveled unit by unit in the
    order of ``fields`` (of offs (R, n), ebits (R, n), lane_end (n,),
    geom (3, n)); ``shapes`` is each unit's (R, n, hmax, wmax).  Returns a
    list of one tuple of views a unit."""
    sizes = {"offs": lambda R, n: (R, n), "ebits": lambda R, n: (R, n),
             "lane_end": lambda R, n: (n,), "geom": lambda R, n: (3, n)}
    out = []
    for R, n, _hm, _wm in shapes:
        views = []
        for k in fields:
            shape = sizes[k](R, n)
            size = int(np.prod(shape))
            views.append(meta[at:at + size].view(shape))
            at += size
        out.append(tuple(views))
    return out


def _use_graph(graph, dev) -> bool:
    """``graph=`` as the encoder reads it: None is on for a CUDA device,
    True on another device raises."""
    if graph and dev.type != "cuda":
        raise ValueError(f"graph=True needs a CUDA device, not {dev}")
    return dev.type == "cuda" if graph is None else bool(graph)


def run_pass(key, fn, x, graph: bool, read, owner=None, estimate: int = 0):
    """A device pass whose caller waits for it: ``fn(x)`` eagerly, or
    through ``graph_cache.CACHE`` by ``key`` (its capture made once
    ``read``, which copies the outputs to the host, is done).  Returns
    ``read(outputs)``."""
    if not graph:
        return read(fn(x))
    cache = graph_cache.CACHE
    with cache.lock:
        outs, state = cache.run(key, fn, x)
        got = read(outs)
    if state == "capture":
        cache.capture(key, fn, x, outs, owner=owner, estimate=estimate)
    return got


class DecodePlan:
    """One pass's plan on the device side: its key (every field that fixes
    the pass's shapes: geometry, stages, filter, segments, mag_bits,
    channels, canvases, each unit present with its rounds, lanes and
    canvas, the padded blob's bytes, device), the key's tables and
    the device pass over the static inputs (blob, meta), ``meta`` being
    int32: the LL means, then each unit's offs, ebits and lane_end,
    raveled."""

    def __init__(self, w, h, ll_means, blob_len, units, config, dtype,
                 nchan, dev):
        self.w, self.h = w, h
        self.config = config
        self.mag_bits = _mag_bits(dtype)
        self.lsb0 = _bitplanes(self.mag_bits) - 1
        self.NC = len(ll_means)
        self.shapes = [(u["offs"].shape[0], u["offs"].shape[1], u["hmax"],
                        u["wmax"]) for u in units]
        self.key = ("decode", w, h, config.stages, config.filt,
                    config.segments, self.mag_bits, nchan, self.NC,
                    tuple((u["bucket"],) + sh
                          for u, sh in zip(units, self.shapes)),
                    blob_len, str(dev))
        self.tables = key_tables(self.key, units, self.NC, w, h, dev)

    def meta(self, ll_means, units) -> np.ndarray:
        """The int32 static input that ``device_pass`` slices."""
        return np.concatenate(
            [np.asarray(ll_means, np.int32)]
            + [u[k].ravel() for u in units
               for k in ("offs", "ebits", "lane_end")]).astype(np.int32)

    def estimate(self) -> int:
        """Device bytes of the pass from its shapes, for the graph cache's
        eviction before a capture: kernel 2's outputs twice (theirs and
        the joined copy) and ten canvases' worth for the finalize."""
        outs = sum(hm * wm * n for _R, n, hm, wm in self.shapes)
        return 4 * (2 * outs + 10 * self.NC * self.h * self.w)

    def device_pass(self, x) -> tuple:
        """The device half of the pass over ``x`` = (blob, meta): kernel
        2's units, the finalize and the pixels narrowed to the sample
        width (``narrow``).  Returns (pixels (NC, h, w) uint8 or int16,).
        No host copy, no sync: it can be captured.  On the card it marks
        kernel 2's stage before the fork of its unit streams, the
        finalize's after their join and the end of the pass (utils/trace
        ``mark``)."""
        blob, meta = x
        inputs = [views + (geom, hm, wm) for views, geom, (_R, _n, hm, wm)
                  in zip(unit_views(meta, self.NC, self.shapes),
                         self.tables.geoms, self.shapes)]
        trace.mark(trace.K2, blob)
        outs = [out for out, _err, _pos in decode_units(
            blob, inputs, self.lsb0, self.mag_bits)]
        trace.mark(trace.FINALIZE, blob)
        px = narrow(finalize(outs, self.tables, meta[:self.NC], self.w,
                             self.h, self.config, self.mag_bits),
                    self.mag_bits)
        trace.mark(trace.END, blob)
        return (px,)


def _upload(blob, meta, dev):
    """The pass's static inputs on the device: (blob, meta)."""
    return to_device(blob, dev), to_device(meta, dev)


def _decode(streams, config: CodecConfig, dtype, nchan: int, device,
            defer: bool, max_pixels, graph):
    """Decode B same-geometry streams as B * nchan canvases; returns the
    list of (h, w) canvases of ``dtype``, or with ``defer`` a collector of
    it.  The streams decode in passes of at most ``PASS_BYTES`` bytes,
    queued one after the other; only the collector waits for the card."""
    dev = resolve_device(device)
    graph = _use_graph(graph, dev)
    if max_pixels is None:
        max_pixels = DEFAULT_MAX_PIXELS
    passes = [_dispatch(streams[a:b], config, dtype, nchan, dev, max_pixels,
                        graph) for a, b in _passes(streams)]
    if len({geom for geom, _collect in passes}) > 1:
        raise IcerError(IcerStatus.INVALID_INPUT,
                        "batched streams must share geometry")

    def collect():
        return [c for _geom, part in passes for c in part()]

    return collect if defer else collect()


def _dispatch(streams, config: CodecConfig, dtype, nchan: int, dev,
              max_pixels, graph: bool):
    """One decode pass: the host plan, then the device pass queued on the
    card (a graph replay where ``graph`` and its key is captured), and the
    copy of its pixels back started into a pinned buffer.  Returns ((w,
    h), the pass's collector), which waits for the copy, captures the
    key's graph if the pass was marked for it, and reads the pixels."""
    w, h, ll_means, blob, units = plan_batch(streams, config, dtype, nchan,
                                             max_pixels, pad=True)
    trace.count("decode.passes")
    with trace.span("decode.dispatch"):
        plan = DecodePlan(w, h, ll_means, len(blob), units, config, dtype,
                          nchan, dev)
        NC = plan.NC
        cache = graph_cache.CACHE
        state, capture = "eager", None
        with cache.lock if graph else contextlib.nullcontext():
            x = _upload(blob, plan.meta(ll_means, units), dev)
            if graph:
                outs, state = cache.run(plan.key, plan.device_pass, x)
            else:
                outs = plan.device_pass(x)
            pix = to_host(outs[0])
        if state == "capture":
            capture = functools.partial(
                cache.capture, plan.key, plan.device_pass, x, outs,
                owner=plan.tables, estimate=plan.estimate())
        pending = Pending(dev, keep=(x, outs))

    def collect():
        with trace.span("decode.wait"):
            pending.wait()
        if capture is not None:
            with trace.span("decode.capture"):
                capture()
        with trace.span("decode.unpack"):
            px = pix.numpy().view(dtype)
            return [px[c].copy() for c in range(NC)]

    return (w, h), collect


def decompress_batch(streams, config: CodecConfig, dtype=np.uint16,
                     device=None, defer: bool = False,
                     max_pixels: int | None = None,
                     pack8: bool | None = None, graph: bool | None = None):
    """Decode B same-geometry grayscale streams; returns a list of (h, w)
    arrays of ``dtype``, each pixel-identical to the JAX package's
    ``decompress`` of its stream.

    ``defer`` returns a zero-argument collector right after the dispatch.
    ``max_pixels`` (default ``DEFAULT_MAX_PIXELS``) bounds the canvas the
    untrusted header dimensions may ask for.  ``pack8`` is accepted as
    the JAX package's ``decompress_batch`` takes it and changes neither
    the pixels nor the copies: each pass copies its pixels back once, at
    the width of ``dtype``.  ``graph``: run
    each device pass as a captured CUDA graph per plan key (module
    docstring); None means on for a CUDA device, True on another device
    raises, False runs eagerly (for comparisons and the by-layer
    trace)."""
    return _decode(streams, config, dtype, 1, device, defer, max_pixels,
                   graph)


def decompress_yuv_batch(streams, config: CodecConfig, dtype=np.uint16,
                         device=None, defer: bool = False,
                         max_pixels: int | None = None,
                         pack8: bool | None = None,
                         graph: bool | None = None):
    """Decode B same-geometry colour (YUV) streams, all 3B channel
    canvases at once; returns a list of (y, u, v) tuples, each
    pixel-identical to the JAX package's ``decompress_yuv`` of its stream.
    ``defer``, ``max_pixels``, ``pack8`` and ``graph`` as in
    ``decompress_batch``."""
    def group(flat):
        return [tuple(flat[i:i + 3]) for i in range(0, len(flat), 3)]

    res = _decode(streams, config, dtype, 3, device, defer, max_pixels,
                  graph)
    if defer:
        return lambda: group(res())
    return group(res)
