"""Packet priority construction, sorting and stream rearrangement orders.

A *packet* is one (channel, stage, subband, bitplane): the unit of rate
allocation.  Packet priorities and the stable sort mirror
icer_compress.c:54-105/315-365 (grayscale) and icer_color.c:74-134/398-458
(color, including the cumulative Y-channel priority doubling quirk).  The
final stream rearrangement orders mirror icer_compress.c:149-163,
icer_color.c:184-203 (uint8 color ascending) and icer_color.c:508-527
(uint16 color descending).

Counterpart: ``icer_compression_tpu/core/packets.py``, copied as it is but
for ``sort_packets``, which sorts by a key instead of the comparator
(the port imports nothing of the JAX package).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .constants import (
    MAX_DECOMP_STAGES, MAX_PACKETS_8, MAX_PACKETS_16,
    SUBBAND_LL, SUBBAND_HL, SUBBAND_LH, SUBBAND_HH, SUBBAND_MAX,
)
from .status import IcerError, IcerStatus


@dataclass
class PacketContext:
    """Mirror of icer_packet_context (icer.h:267-276)."""

    subband_type: int
    decomp_level: int
    ll_mean_val: int
    lsb: int
    priority: int
    image_w: int
    image_h: int
    channel: int = 0


def sort_packets(packets: list[PacketContext]) -> list[PacketContext]:
    """Stable order identical to glibc qsort on the reference's comparator
    (icer_compress.c:8-15: priority descending, subband ascending).

    glibc's qsort is a mergesort (stable) for small element counts, and the
    reference relies on the resulting order.  Python's sorted() is stable,
    giving the same result.

    Caveat: glibc >= 2.37 switched qsort to an unstable introsort, and
    priority ties are reachable (e.g. HL stage 2 lsb 0 and HL stage 1
    lsb 1 both have priority 4), so byte-exactness of the rearranged
    stream is defined against the pinned reference build (glibc < 2.37,
    stable mergesort).  A reference binary built on glibc >= 2.37 may
    order tied packets differently; decode is order-insensitive either
    way (the decoder rescans the whole stream).

    A sort key orders as the comparator does, at a fraction of the cost of
    calling it (the JAX package's ``sort_packets``, ``functools.cmp_to_key``
    over the comparator; a colour batch sorts a 351-packet list an image).
    """
    return sorted(packets, key=lambda p: (-p.priority, p.subband_type))


def _check_packet_count(packets: list[PacketContext], bitplanes: int):
    """ICER_MAX_PACKETS parity (icer.h:33-39).

    The reference's packet-list build errors when the running index
    reaches the static array capacity -- after the final increment too, so
    the condition is count >= MAX (icer_compress.c:67 and the matching
    checks in icer_color.c).  Reachable in-contract: color uint8 at
    stages >= 5 (3*(3*stages*7+7) >= 300)."""
    cap = MAX_PACKETS_8 if bitplanes <= 7 else MAX_PACKETS_16
    if len(packets) >= cap:
        raise IcerError(IcerStatus.PACKET_COUNT_EXCEEDED,
                        f"{len(packets)} packets >= ICER_MAX_PACKETS {cap}")
    return packets


def build_packets_grayscale(image_w: int, image_h: int, stages: int,
                            ll_mean: int, bitplanes: int,
                            channel: int = 0) -> list[PacketContext]:
    """Packet list in creation order (icer_compress.c:54-103).

    The packet context's ll_mean_val field is uint8 in the reference
    (icer.h:270) while the encoder subtracts the full 16-bit mean -- means
    >= 256 are silently truncated in every header (and the decoder then
    adds back only the low byte).  Reproduced for stream parity; reachable
    only with >8-bit dynamic range inputs.
    """
    ll_mean = ll_mean & 0xFF
    packets: list[PacketContext] = []

    def add(subband, level, lsb, priority):
        packets.append(PacketContext(
            subband_type=subband, decomp_level=level, ll_mean_val=ll_mean,
            lsb=lsb, priority=priority, image_w=image_w, image_h=image_h,
            channel=channel))

    for stage in range(1, stages + 1):
        priority = 1 << stage
        for lsb in range(bitplanes):
            add(SUBBAND_HL, stage, lsb, priority << lsb)
            add(SUBBAND_LH, stage, lsb, priority << lsb)
            add(SUBBAND_HH, stage, lsb, ((priority // 2) << lsb) + 1)

    priority = 1 << stages
    for lsb in range(bitplanes):
        add(SUBBAND_LL, stages, lsb, (2 * priority) << lsb)
    return _check_packet_count(packets, bitplanes)


def build_packets_color(image_w: int, image_h: int, stages: int,
                        ll_means: list[int], bitplanes: int) -> list[PacketContext]:
    """Color packet list (icer_color.c:74-132 / 398-456).

    Note the reference quirk: ``priority *= 2`` fires on every Y-channel
    visit and is never undone, so the priority base doubles once per bitplane
    iteration and the doubled value also applies to U and V packets of the
    same iteration.  Reproduced exactly.  ll_means truncate to uint8 as in
    build_packets_grayscale.
    """
    ll_means = [m & 0xFF for m in ll_means]
    packets: list[PacketContext] = []

    def add(subband, level, lsb, priority, chan):
        packets.append(PacketContext(
            subband_type=subband, decomp_level=level,
            ll_mean_val=ll_means[chan], lsb=lsb, priority=priority,
            image_w=image_w, image_h=image_h, channel=chan))

    for stage in range(1, stages + 1):
        priority = 1 << stage
        for lsb in range(bitplanes):
            for chan in range(3):
                if chan == 0:  # Y
                    priority *= 2
                add(SUBBAND_HL, stage, lsb, priority << lsb, chan)
                add(SUBBAND_LH, stage, lsb, priority << lsb, chan)
                add(SUBBAND_HH, stage, lsb, ((priority // 2) << lsb) + 1, chan)

    priority = 1 << stages
    for lsb in range(bitplanes):
        for chan in range(3):
            if chan == 0:
                priority *= 2
            add(SUBBAND_LL, stages, lsb, (2 * priority) << lsb, chan)
    return _check_packet_count(packets, bitplanes)


# --------------------------------------------------------------------------
# Rearrangement orders: sequences of (chan, stage, subband, lsb) keys, used
# to lay encoded segments into the final progressive stream (grouped by
# segment number outermost).
# --------------------------------------------------------------------------

def rearrange_order_grayscale(bitplanes: int):
    """icer_compress.c:151-163: k asc, subband desc, stage desc, lsb desc."""
    order = []
    for j in range(SUBBAND_MAX, -1, -1):
        for i in range(MAX_DECOMP_STAGES, -1, -1):
            for lsb in range(bitplanes - 1, -1, -1):
                order.append((0, i, j, lsb))
    return order


def rearrange_order_color_uint16(bitplanes: int):
    """icer_color.c:510-527: subband desc, stage desc, lsb desc, chan asc."""
    order = []
    for j in range(SUBBAND_MAX, -1, -1):
        for i in range(MAX_DECOMP_STAGES, -1, -1):
            for lsb in range(bitplanes - 1, -1, -1):
                for chan in range(3):
                    order.append((chan, i, j, lsb))
    return order


def rearrange_order_color_uint8(bitplanes: int):
    """icer_color.c:186-203: subband asc, stage asc, lsb asc, chan asc."""
    order = []
    for j in range(SUBBAND_MAX + 1):
        for i in range(MAX_DECOMP_STAGES + 1):
            for lsb in range(bitplanes):
                for chan in range(3):
                    order.append((chan, i, j, lsb))
    return order
