"""Subband dimension math and in-image layout.

The N-stage DWT keeps subbands *in place* inside the image array, matching
the reference layout so that streams interoperate:

  - low dimension after s stages: ceil(dim / 2^s)
    (icer_get_dim_n_low_stages, icer_wavelet.c:107-109)
  - high dimension at stage s: floor(ceil(dim / 2^(s-1)) / 2)
    (icer_get_dim_n_high_stages, icer_wavelet.c:111-113)

Subband origin offsets inside the full image mirror
icer_compress.c:119-139.
"""

from __future__ import annotations

from dataclasses import dataclass

from .constants import SUBBAND_LL, SUBBAND_HL, SUBBAND_LH, SUBBAND_HH


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def dim_low(dim: int, stages: int) -> int:
    return ceil_div(dim, 1 << stages)


def dim_high(dim: int, stages: int) -> int:
    return ceil_div(dim, 1 << (stages - 1)) // 2


@dataclass(frozen=True)
class SubbandView:
    """A subband's rectangle inside the (image_h, image_w) array."""

    subband: int
    stage: int
    row: int
    col: int
    h: int
    w: int


def subband_view(image_w: int, image_h: int, stage: int, subband: int) -> SubbandView:
    """Geometry of (stage, subband) inside the transformed image.

    Matches the data_start/ll_w/ll_h computations of
    icer_compress_image_* (icer_compress.c:119-139, 473-517).
    """
    lw = dim_low(image_w, stage)
    lh = dim_low(image_h, stage)
    hw = dim_high(image_w, stage)
    hh = dim_high(image_h, stage)
    if subband == SUBBAND_LL:
        return SubbandView(subband, stage, 0, 0, lh, lw)
    if subband == SUBBAND_HL:
        return SubbandView(subband, stage, 0, lw, lh, hw)
    if subband == SUBBAND_LH:
        return SubbandView(subband, stage, lh, 0, hh, lw)
    if subband == SUBBAND_HH:
        return SubbandView(subband, stage, lh, lw, hh, hw)
    raise ValueError(f"bad subband {subband}")
