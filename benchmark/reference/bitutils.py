"""Integer bit manipulation helpers, generic over numpy / jax.numpy.

All functions take an ``xp`` array namespace (numpy or jax.numpy) and use
only ops common to both, so the same code runs on host and under jit on
TPU (where they lower to VPU integer ops).
"""

from __future__ import annotations

import numpy as np


def popcount32(v, xp=np):
    """Per-element population count of non-negative int32 values (SWAR)."""
    v = v.astype(xp.uint32) if hasattr(v, "astype") else xp.uint32(v)
    v = v - ((v >> 1) & xp.uint32(0x55555555))
    v = (v & xp.uint32(0x33333333)) + ((v >> 2) & xp.uint32(0x33333333))
    v = (v + (v >> 4)) & xp.uint32(0x0F0F0F0F)
    return ((v * xp.uint32(0x01010101)) >> 24).astype(xp.int32)


def msb_index(v, xp=np):
    """floor(log2(v)) for v >= 1, elementwise (v < 2^16 assumed).

    Mirrors ``32 - clz(v) - 1``; implemented as fill-down + popcount so it
    vectorizes identically on VPU and host.
    """
    v = v.astype(xp.int32)
    v = v | (v >> 1)
    v = v | (v >> 2)
    v = v | (v >> 4)
    v = v | (v >> 8)
    return popcount32(v, xp) - 1


def floor_div(a, b, xp=np):
    """Floored integer division (matches icer_floor_div_*)."""
    return xp.floor_divide(a, b)
