"""Integer bit helpers on int32 tensors.

Counterpart: ``icer_compression_tpu/ops/bitutils.py`` (``floor_div``,
``msb_index``).
"""

from __future__ import annotations

import torch


def floor_div(a: torch.Tensor, b) -> torch.Tensor:
    """Floored integer division (matches icer_floor_div_*)."""
    return torch.div(a, b, rounding_mode="floor")


def msb_index(v: torch.Tensor) -> torch.Tensor:
    """floor(log2(v)) for 1 <= v < 2^16, elementwise (``32 - clz(v) - 1``)."""
    v = v.to(torch.int32)
    out = torch.zeros_like(v)
    for s in (8, 4, 2, 1):
        hi = (v >> s) != 0
        out = out + hi.to(torch.int32) * s
        v = torch.where(hi, v >> s, v)
    return out
