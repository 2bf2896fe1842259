"""Codeword bit packing on tensors.

Counterpart: ``icer_compression_tpu/ops/entropy_jax2.py``
(``pack_records_tree`` and the ``_bitrev16`` it uses).  Same contract:
codewords in allocation order are concatenated LSB-first into one
payload per lane.  Here as one exclusive prefix sum of the lengths and a
scatter-add of each codeword's (at most two) 32-bit word contributions:
bit ranges are disjoint, so the sum of the contributions is their OR.
"""

from __future__ import annotations

import torch


def bitrev16(v: torch.Tensor, nbits: torch.Tensor) -> torch.Tensor:
    """Reverse the low ``nbits`` bits of ``v`` (nbits <= 16)."""
    v = v & 0xFFFF
    v = ((v >> 1) & 0x5555) | ((v & 0x5555) << 1)
    v = ((v >> 2) & 0x3333) | ((v & 0x3333) << 2)
    v = ((v >> 4) & 0x0F0F) | ((v & 0x0F0F) << 4)
    v = ((v >> 8) & 0x00FF) | ((v & 0x00FF) << 8)
    return v >> (16 - nbits)


def pack_records(code: torch.Tensor, nbits: torch.Tensor,
                 rec_valid: torch.Tensor, max_bits: int):
    """Pack each lane's codewords (rows of (lanes, R) tensors).

    Returns (payload uint8 (lanes, max_bits // 8), total bits int64
    (lanes,), overflow bool (lanes,)).  A lane whose codewords exceed
    ``max_bits`` sets its overflow flag and its payload is not
    meaningful (the caller re-encodes it on the host)."""
    assert max_bits % 32 == 0
    W = max_bits // 32
    nb = (nbits.to(torch.int64) * rec_valid.to(torch.int64))
    off = torch.cumsum(nb, dim=-1) - nb
    total = nb.sum(dim=-1)
    c = code.to(torch.int64) & ((1 << nb) - 1)
    sh = off & 31
    lo = (c << sh) & 0xFFFFFFFF
    hi = torch.where(sh == 0, 0, c >> (32 - sh))
    wi = off >> 5
    words = torch.zeros(code.shape[:-1] + (W + 2,), dtype=torch.int64,
                        device=code.device)
    words.scatter_add_(-1, torch.clamp(wi, max=W), lo)
    words.scatter_add_(-1, torch.clamp(wi + 1, max=W + 1), hi)
    words = words[..., :W]
    payload = torch.stack([(words >> s) & 0xFF for s in (0, 8, 16, 24)],
                          dim=-1).reshape(code.shape[:-1] + (4 * W,))
    return payload.to(torch.uint8), total, total > max_bits
