"""Lane-batched grayscale decode: host plan, kernel 2, device finalize.

Counterpart: ``icer_compression_tpu/models/decode_jax.py`` (``_plan_lanes``,
the per-round offset plan of ``_decode_batch``, the finalize of
``_run_fused`` and ``decompress_lanes_batch``).  Segments are bucketed by
subband geometry; each bucket's lanes (of every image of the batch)
decode all their plane rounds in one kernel-2 launch that reads the
concatenated streams in place, so no stream windows are gathered and no
lane is re-decoded on the host.  The buckets' launches go to streams of
their own, so they overlap on the card.  The finalize (canvas assembly,
sign-magnitude, LL mean, inverse DWT, clamp) runs as PyTorch ops on the
device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.header import scan_bytestream
from ..core.partition import partition_segments
from ..core.status import IcerError, IcerStatus
from ..core.subbands import decode_subband_order, dim_low, subband_view
from ..device import resolve_device
from ..ops import wavelet
from ..ops.plane_decode import decode_planes
from .grayscale import CodecConfig, _bitplanes, _mag_bits

# Decode-side allocation guard: header dimensions come from the
# (untrusted) stream; bound the canvas they can request.
MAX_PIXELS = 1 << 28


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


def plan_batch(streams, config: CodecConfig, dtype):
    """Host side of a batched decode: scan every stream and lay out each
    bucket's kernel-2 inputs.  Returns (w, h, ll_means, blob, units) with
    units = [{lanes, n1, offs (R, n), ebits (R, n), lane_end (n,),
    geom (3, n), hmax, wmax}] (numpy int32), lane j of a unit being
    segment lanes[j % n1] of image j // n1."""
    bitplanes = _bitplanes(_mag_bits(dtype))
    B = len(streams)
    if B == 0:
        raise IcerError(IcerStatus.INVALID_INPUT, "no streams")
    tables = []
    ll_means = [0] * B
    w = h = 0
    for b, data in enumerate(streams):
        found = scan_bytestream(data, with_offsets=True, with_payload=False)
        if not found:
            raise IcerError(IcerStatus.DECODER_OUT_OF_DATA,
                            "no valid segments")
        t: dict = {}
        for hdr, _p, off in found:
            # the channel nibble is ignored, as in the reference's
            # grayscale decoder: last in stream wins on duplicates
            t[(hdr.decomp_level, hdr.subband_type, hdr.segment_number,
               hdr.lsb)] = (off, hdr.data_length)
            wi, hi = hdr.image_w, hdr.image_h
            ll_means[b] = hdr.ll_mean_val
        if w == 0:
            w, h = wi, hi
        elif (w, h) != (wi, hi):
            raise IcerError(IcerStatus.INVALID_INPUT,
                            "batched streams must share geometry")
        tables.append(t)
    if w <= 0 or h <= 0 or w * h > MAX_PIXELS:
        raise IcerError(IcerStatus.INVALID_INPUT,
                        f"header dimensions {w}x{h} exceed {MAX_PIXELS} px")
    blob = np.frombuffer(b"".join(streams), np.uint8).copy()
    bases = np.cumsum([0] + [len(s) for s in streams])

    units = []
    for lanes in _plan_lanes(w, h, config):
        n1 = len(lanes)
        n = n1 * B
        offs_r, ebits_r = [], []
        for rnd in range(bitplanes):
            lsb = bitplanes - 1 - rnd
            offs = np.full(n, -1, np.int64)
            ebits = np.zeros(n, np.int64)
            for b in range(B):
                for i, t in enumerate(lanes):
                    ent = tables[b].get((t["stage"], t["subband"], t["seg"],
                                         lsb))
                    if ent is not None:
                        offs[b * n1 + i] = bases[b] + ent[0]
                        ebits[b * n1 + i] = ent[1]
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
            "lanes": lanes, "n1": n1,
            "offs": np.stack(offs_r).astype(np.int32),
            "ebits": np.stack(ebits_r).astype(np.int32),
            "lane_end": np.repeat(bases[1:], n1).astype(np.int32),
            "geom": np.tile(geom, (1, B)),
            "hmax": max(t["h"] for t in lanes),
            "wmax": max(t["w"] for t in lanes),
        })
    return w, h, ll_means, blob, units


def unit_inputs(units, device):
    """Each unit's kernel-2 inputs as tensors on ``device``: a list of
    (offs, ebits, lane_end, geom, hmax, wmax)."""
    return [tuple(torch.as_tensor(u[k], device=device)
                  for k in ("offs", "ebits", "lane_end", "geom"))
            + (u["hmax"], u["wmax"]) for u in units]


def decode_units(stream_t, inputs, lsb0: int, mag_bits: int):
    """Kernel 2 over every unit; returns each unit's (out, err, pos).

    On the card each unit launches on a stream of its own, so the units'
    lanes are in flight at once, and the caller's stream waits for all of
    them.  Every tensor crossing streams is recorded on the stream that
    uses it, so the caching allocator does not hand it out early."""
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


def _canvas_index(units, B, w, h):
    """Gather index from the concatenated unit outputs (+ one trailing
    zero) into the (B, h, w) sign-magnitude canvas."""
    total = sum(u["hmax"] * u["wmax"] * u["n1"] * B for u in units)
    gidx = np.full((B, h, w), total, np.int64)
    base = 0
    for u in units:
        n = u["n1"] * B
        wmax = u["wmax"]
        for j in range(n):
            b, i = divmod(j, u["n1"])
            t = u["lanes"][i]
            rr = np.arange(t["h"])[:, None]
            cc = np.arange(t["w"])[None, :]
            gidx[b, t["row"]:t["row"] + t["h"], t["col"]:t["col"] + t["w"]] \
                = base + (rr * wmax + cc) * n + j
        base += u["hmax"] * wmax * n
    return gidx


def decompress_batch(streams, config: CodecConfig, dtype=np.uint16,
                     device=None):
    """Decode B same-geometry grayscale streams; returns a list of (h, w)
    arrays of ``dtype``, each pixel-identical to the JAX package's
    ``decompress`` of its stream."""
    dev = resolve_device(device)
    mag_bits = _mag_bits(dtype)
    bitplanes = _bitplanes(mag_bits)
    w, h, ll_means, blob, units = plan_batch(streams, config, dtype)
    B = len(streams)
    stream_t = torch.as_tensor(blob, device=dev)
    outs = [out.reshape(-1) for out, _err, _pos in decode_units(
        stream_t, unit_inputs(units, dev), bitplanes - 1, mag_bits)]
    outs.append(torch.zeros(1, dtype=torch.int32, device=dev))
    gidx = torch.as_tensor(_canvas_index(units, B, w, h), device=dev)
    canvas = torch.cat(outs)[gidx]

    img = wavelet.from_sign_magnitude(canvas, mag_bits)
    ll_w = dim_low(w, config.stages)
    ll_h = dim_low(h, config.stages)
    llv = torch.as_tensor(np.asarray(ll_means, np.int32), device=dev)
    img[:, :ll_h, :ll_w] = wavelet._wrap(
        img[:, :ll_h, :ll_w] + llv[:, None, None], mag_bits)
    img, _ov = wavelet.inverse_stages(img, config.stages, config.filt,
                                      mag_bits)
    px = torch.clamp(img, min=0).cpu().numpy()
    return [px[b].astype(dtype) for b in range(B)]
