"""Integer RGB <-> YCbCr conversion, matching example/inc/color_util.h.

Counterpart: ``icer_compression_tpu/utils/colorspace.py`` (a copy: the port
imports nothing of the JAX package).  The CLI converts with the reference's
clipped fixed-point macros (CRGB2Y/Cb/Cr, CYCbCr2R/G/B -- color_util.h:27-34)
on the host, before the planes go up to the device.  The transform is lossy
(clipping + truncation), so colour round trips are not pixel-exact even at
an unlimited quota -- a property of the reference, kept here.
"""

from __future__ import annotations

import numpy as np


def _clip(x):
    return np.clip(x, 0, 255)


def rgb_to_ycbcr(rgb: np.ndarray):
    """(h, w, 3) uint8 RGB -> three (h, w) planes (y, cb, cr)."""
    r = rgb[..., 0].astype(np.int64)
    g = rgb[..., 1].astype(np.int64)
    b = rgb[..., 2].astype(np.int64)
    y = _clip((19595 * r + 38470 * g + 7471 * b) >> 16)
    cb = _clip(((36962 * (b - y)) >> 16) + 128)
    cr = _clip(((46727 * (r - y)) >> 16) + 128)
    return y, cb, cr


def ycbcr_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """Three (h, w) planes -> (h, w, 3) uint8 RGB."""
    y = y.astype(np.int64)
    cb = cb.astype(np.int64)
    cr = cr.astype(np.int64)
    r = _clip(y + ((91881 * cr) >> 16) - 179)
    g = _clip(y - ((22544 * cb + 46793 * cr) >> 16) + 135)
    b = _clip(y + ((116129 * cb) >> 16) - 226)
    return np.stack([r, g, b], axis=-1).astype(np.uint8)
