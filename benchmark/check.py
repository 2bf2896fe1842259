"""Whether what the timed path produced is correct.

The plain reference (``reference/``, NumPy, nothing of the program)
encodes the checked frames itself at the cell's quota.  Every stream the
window returned for a checked frame must equal the reference's byte for
byte; every decode of a checked frame must equal the pixels a correct
decoder gives for the reference's stream (``codec.expected_pixels``); in
the decode cell the streams the port made in set-up must equal the
reference's too; and every request attempted must have been answered.
In the encode cells, where every stream is kept, each frame's streams
must also agree across the repeats of the pool.  Each number has the
limit 0: the comparison is exact.
"""

from __future__ import annotations

import collections
import os

import numpy as np

from . import frames
from .reference import codec as R
from .reference import constants as C
from .reference.workers import Workers


def stream_work(stream: bytes, codec: R.Codec) -> tuple[int, int]:
    """(payload bytes, pixels of every segment plane) a stream holds: the
    work a decoder of it does."""
    from .reference.header import scan_bytestream
    from .reference.partition import partition_segments
    from .reference.subbands import subband_view
    nbytes = pixels = 0
    areas: dict = {}
    for hdr, payload in scan_bytestream(stream):
        key = (hdr.image_w, hdr.image_h, hdr.decomp_level, hdr.subband_type)
        if key not in areas:
            view = subband_view(*key)
            areas[key] = [r.w * r.h for r in partition_segments(
                view.w, view.h, codec.segments)]
        nbytes += len(payload)
        pixels += areas[key][hdr.segment_number]
    return nbytes, pixels


def reference_codec(config: dict) -> R.Codec:
    return R.Codec(stages=config["stages"],
                   filt="ABCDEFQ".index(config["filter"]),
                   segments=config["segments"],
                   mag_bits=7 if config["container"] == "uint8" else 15)


def checked_frames(run) -> dict:
    """The frames the check compares, by key."""
    keys = sorted(run.check_keys)
    if run.traffic["mode"] == "tactical":
        base = frames.tiled(run.config["height"], run.config["width"])
        return {k: frames.fresh(run.config, run.seed, k, base) for k in keys}
    return {k: run.pool[k] for k in keys}


def reference(run, quota, workers: int, control: str | None = None) -> dict:
    """The reference's {key: encode result} for the checked frames;
    ``control`` puts a known fault into it (``controls``)."""
    fr = checked_frames(run)
    keys = list(fr)
    codec = reference_codec(run.config)
    # the control's coder never force-completes a codeword: the buffer
    # limit that a faster coder would be tempted to drop
    window = 1 << 40 if control == "unbounded_window" else C.CIRC_BUF_SIZE
    with Workers(workers) as pool:
        out = R.encode([fr[k] for k in keys], quota, codec, pool, window)
    res = dict(zip(keys, out))
    for k, r in res.items():
        included = r["included"]
        if control == "one_plane_short":
            included = _one_plane_short(included)
        r["pixels"] = R.expected_pixels(r["coeffs"], r["ll_mean"], included,
                                        codec)
    return res


def _one_plane_short(included: set) -> set:
    """A decoder that stops one plane early: each segment's lowest plane
    left out."""
    low: dict = {}
    for st, sb, lsb, seg in included:
        key = (st, sb, seg)
        low[key] = min(low.get(key, lsb), lsb)
    return {k for k in included if k[2] != low[(k[0], k[1], k[3])]}


def compare(run, ref: dict) -> list:
    """[(name, value, limit)] of the run's numbers against ``ref``."""
    streams_wrong = pixels_wrong = 0
    by_key: dict = collections.defaultdict(list)
    for key, kind, value in run.answers:
        if kind == "stream":
            by_key[key].append(value)
            if key in ref and value != ref[key]["stream"]:
                streams_wrong += 1
        elif key in ref:
            if not np.array_equal(np.asarray(value), ref[key]["pixels"]):
                pixels_wrong += 1
    for key, vals in by_key.items():          # repeats of a pool frame
        if key not in ref:
            streams_wrong += sum(v != vals[0] for v in vals[1:])
    setup_wrong = 0
    if getattr(run, "streams", None) is not None:
        setup_wrong = sum(run.streams[k] != ref[k]["stream"] for k in ref)
    kinds = {kind for _, kind, _ in run.answers}
    out = [("answers_missing", run.attempted - run.answered, 0)]
    if "stream" in kinds:
        out.append(("streams_wrong", streams_wrong, 0))
    if "pixels" in kinds:
        out.append(("pixels_wrong", pixels_wrong, 0))
    if getattr(run, "streams", None) is not None:
        out.append(("setup_streams_wrong", setup_wrong, 0))
    return out


CONTROLS = ("unbounded_window", "one_plane_short")


def run_check(run, quota, workers: int | None = None,
              control: str | None = None) -> list:
    """The run's numbers against the reference: ``reference``, or the
    cell's mode file's own (``run.reference_hook``, same arguments and
    result).  With ``control`` (one of ``CONTROLS``) the answers of the
    checked frames are first replaced by a reference with that fault, put
    in the program's place: the numbers must then fail."""
    if not run.check_keys:
        raise RuntimeError("no answer to check: the window returned none")
    if workers is None:
        workers = min(8, os.cpu_count() or 1)
    expected = run.reference_hook or reference
    ref = expected(run, quota, workers, None)
    if control is not None:
        bad = expected(run, quota, workers, control)
        run.answers = [(k, kind, bad[k][kind]) for k, kind, _ in run.answers
                       if k in bad]
        if getattr(run, "streams", None) is not None:
            run.streams = {k: bad[k]["stream"] for k in bad}
    return compare(run, ref)
