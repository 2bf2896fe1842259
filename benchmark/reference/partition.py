"""Error-containment segment geometry.

Deterministic rectangular tiling of a subband into S segments, exactly
reproducing ``icer_generate_partition_parameters``
(lib_icer/src/icer_partition.c:7-54) and the segment enumeration order of
``icer_compress_partition_*`` (icer_partition.c:78-164): a *top* region of
``r_t`` rows x ``c`` columns followed by an optional *bottom* region of
``r - r_t`` rows x ``c + 1`` columns.

Segments are the unit of parallelism in this framework: every segment's
bitplane streams are fully independent (own context model, own entropy coder,
own CRC), so segments shard freely across TPU cores and hosts.
"""

from __future__ import annotations

from dataclasses import dataclass

from .status import IcerError, IcerStatus
from .constants import MAX_SEGMENTS


@dataclass(frozen=True)
class PartitionParams:
    """Field-for-field mirror of partition_param_typdef (icer.h:126-142)."""

    w: int
    h: int
    s: int
    r: int
    c: int
    r_t: int
    h_t: int
    x_t: int
    c_t0: int
    y_t: int
    r_t0: int
    x_b: int
    c_b0: int
    y_b: int
    r_b0: int


@dataclass(frozen=True)
class SegmentRect:
    """One segment: a rectangle (row0, col0, h, w) inside the subband."""

    index: int
    row: int
    col: int
    h: int
    w: int


def generate_partition_params(ll_w: int, ll_h: int, segments: int) -> PartitionParams:
    """Integer formulas from icer_partition.c:7-54, bit for bit."""
    if segments > (ll_w * ll_h) or segments > MAX_SEGMENTS:
        raise IcerError(IcerStatus.TOO_MANY_SEGMENTS,
                        f"segments={segments} for {ll_w}x{ll_h}")

    if ll_h > (segments - 1) * ll_w:
        r = segments
    else:
        r = 1
        while r < segments and (r + 1) * r * ll_w < ll_h * segments:
            r += 1
    c = segments // r
    r_t = (c + 1) * r - segments
    h_t = max(r_t, ((2 * ll_h * c * r_t + segments) // 2) // segments)
    x_t = ll_w // c
    c_t0 = (x_t + 1) * c - ll_w
    y_t = h_t // r_t
    r_t0 = (y_t + 1) * r_t - h_t

    x_b = c_b0 = y_b = r_b0 = 0
    if r_t < r:
        x_b = ll_w // (c + 1)
        c_b0 = (x_b + 1) * (c + 1) - ll_w
        y_b = (ll_h - h_t) // (r - r_t)
        r_b0 = (y_b + 1) * (r - r_t) - (ll_h - h_t)

    return PartitionParams(w=ll_w, h=ll_h, s=segments, r=r, c=c, r_t=r_t,
                           h_t=h_t, x_t=x_t, c_t0=c_t0, y_t=y_t, r_t0=r_t0,
                           x_b=x_b, c_b0=c_b0, y_b=y_b, r_b0=r_b0)


def segment_rects(params: PartitionParams) -> list[SegmentRect]:
    """Enumerate segments in stream order (icer_partition.c:78-164)."""
    rects: list[SegmentRect] = []
    seg = 0
    row_ind = 0
    # Top region: r_t rows of c columns.
    for row in range(params.r_t):
        seg_h = params.y_t + (1 if row >= params.r_t0 else 0)
        col_ind = 0
        for col in range(params.c):
            seg_w = params.x_t + (1 if col >= params.c_t0 else 0)
            rects.append(SegmentRect(seg, row_ind, col_ind, seg_h, seg_w))
            col_ind += seg_w
            seg += 1
        row_ind += seg_h
    # Bottom region: r - r_t rows of c + 1 columns.
    for row in range(params.r - params.r_t):
        seg_h = params.y_b + (1 if row >= params.r_b0 else 0)
        col_ind = 0
        for col in range(params.c + 1):
            seg_w = params.x_b + (1 if col >= params.c_b0 else 0)
            rects.append(SegmentRect(seg, row_ind, col_ind, seg_h, seg_w))
            col_ind += seg_w
            seg += 1
        row_ind += seg_h
    return rects


def partition_segments(ll_w: int, ll_h: int, segments: int) -> list[SegmentRect]:
    """Convenience: geometry -> ordered segment rectangles."""
    return segment_rects(generate_partition_params(ll_w, ll_h, segments))
