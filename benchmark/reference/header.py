"""Segment headers, CRC32 and bytestream scanning.

The wire format of one segment (icer.h:293-305, little-endian, packed,
28 bytes; verified sizeof==28 with no padding in the reference build):

  offset  field
  ------  ----------------------------------------------------------
   0      u16 preamble        (0x605B)
   2      u16 ll_mean_val
   4      u8  decomp_level
   5      u8  subband_type
   6      u8  segment_number
   7      u8  lsb_chan        (low nibble lsb, high nibble channel)
   8      u32 image_w
  12      u32 image_h
  16      u32 data_length     (payload length in BITS)
  20      u32 data_crc32      (CRC32 over ceil(data_length/8) payload bytes)
  24      u32 crc32           (CRC32 over the first 24 header bytes)

CRC32 is ANSI X3.66 / IEEE 802.3 reflected (poly 0xEDB88320, init
0xFFFFFFFF, final inversion) -- identical to zlib.crc32
(lib_icer/src/crc32.c:157-169).
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass

from .constants import HEADER_SIZE, PACKET_PREAMBLE
from .subbands import ceil_div

_HEADER_STRUCT = struct.Struct("<HHBBBBIIIII")
_HEAD24_STRUCT = struct.Struct("<HHBBBBIIII")  # header minus its own CRC
_CRC_STRUCT = struct.Struct("<I")
assert _HEADER_STRUCT.size == HEADER_SIZE
assert _HEAD24_STRUCT.size == HEADER_SIZE - 4


def crc32(data: bytes | bytearray | memoryview) -> int:
    return zlib.crc32(data) & 0xFFFFFFFF


@dataclass
class SegmentHeader:
    ll_mean_val: int
    decomp_level: int
    subband_type: int
    segment_number: int
    lsb: int
    channel: int
    image_w: int
    image_h: int
    data_length: int  # bits

    @property
    def lsb_chan(self) -> int:
        return (self.lsb & 0x0F) | ((self.channel & 0x0F) << 4)

    @property
    def payload_bytes(self) -> int:
        return ceil_div(self.data_length, 8)

    def pack(self, payload: bytes) -> bytes:
        """Serialize header + payload with both CRCs."""
        out = bytearray(HEADER_SIZE + len(payload))
        self.pack_into(out, 0, payload)
        return bytes(out)

    def pack_into(self, buf: bytearray, offset: int, payload) -> int:
        """Serialize header + payload into ``buf`` at ``offset``.

        Returns the number of bytes written.  Used by the stream
        assembler to build the full bytestream in one buffer without
        per-segment bytes objects.
        """
        n = len(payload)
        assert n == self.payload_bytes
        _HEAD24_STRUCT.pack_into(
            buf, offset,
            PACKET_PREAMBLE, self.ll_mean_val, self.decomp_level,
            self.subband_type, self.segment_number, self.lsb_chan,
            self.image_w, self.image_h, self.data_length, crc32(payload))
        header_crc = zlib.crc32(
            memoryview(buf)[offset:offset + 24]) & 0xFFFFFFFF
        _CRC_STRUCT.pack_into(buf, offset + 24, header_crc)
        buf[offset + HEADER_SIZE:offset + HEADER_SIZE + n] = payload
        return HEADER_SIZE + n


def try_parse_segment(buf: memoryview, offset: int,
                      with_payload: bool = True):
    """Validate and parse a segment at ``offset``.

    Mirrors icer_find_packet_in_bytestream's per-position checks
    (icer_compress.c:569-588): preamble, header CRC, length sanity, payload
    CRC.  Returns (SegmentHeader, payload_bytes, total_len) or None.
    ``with_payload=False`` skips materializing the payload copy (the
    zero-copy decode paths work from (stream, offset) instead) -- the
    payload CRC is still checked.
    """
    n = len(buf)
    if offset + HEADER_SIZE > n:
        return None
    (preamble, ll_mean, level, subband, seg_num, lsb_chan,
     image_w, image_h, data_length, data_crc,
     header_crc) = _HEADER_STRUCT.unpack_from(buf, offset)
    if preamble != PACKET_PREAMBLE:
        return None
    if zlib.crc32(buf[offset:offset + 24]) & 0xFFFFFFFF != header_crc:
        return None
    payload_len = ceil_div(data_length, 8)
    if payload_len > n - offset - HEADER_SIZE:
        return None
    pv = buf[offset + HEADER_SIZE:offset + HEADER_SIZE + payload_len]
    if zlib.crc32(pv) & 0xFFFFFFFF != data_crc:
        return None
    hdr = SegmentHeader(
        ll_mean_val=ll_mean, decomp_level=level, subband_type=subband,
        segment_number=seg_num, lsb=lsb_chan & 0x0F,
        channel=(lsb_chan & 0xF0) >> 4, image_w=image_w, image_h=image_h,
        data_length=data_length,
    )
    payload = bytes(pv) if with_payload else None
    return hdr, payload, HEADER_SIZE + payload_len


def scan_bytestream(data: bytes, with_offsets: bool = False,
                    with_payload: bool = True):
    """Yield (header, payload[, payload_offset]) for every valid segment.

    Byte-by-byte resynchronization on corruption, exactly like the decoder's
    scan loop (icer_compress.c:449-459 + find_packet).  ``with_offsets``
    additionally reports each payload's absolute byte offset: the reference
    decoder works zero-copy on the stream, so a decoder that (out of
    contract) consumes past data_length reads the *following stream bytes*
    -- offsets let our decoders reproduce that behavior exactly.
    """
    buf = memoryview(data)
    offset = 0
    n = len(data)
    out = []
    while offset < n:
        parsed = try_parse_segment(buf, offset, with_payload)
        if parsed is None:
            offset += 1
            continue
        hdr, payload, consumed = parsed
        if with_offsets:
            out.append((hdr, payload, offset + HEADER_SIZE))
        else:
            out.append((hdr, payload))
        offset += consumed
    return out
