"""Status codes mirroring the reference API (icer.h:92-105)."""

from __future__ import annotations

import enum


class IcerStatus(enum.IntEnum):
    OK = 0
    INTEGER_OVERFLOW = -1
    OUTPUT_BUF_TOO_SMALL = -2
    TOO_MANY_SEGMENTS = -3
    TOO_MANY_STAGES = -4
    BYTE_QUOTA_EXCEEDED = -5
    BITPLANE_OUT_OF_RANGE = -6
    DECODER_OUT_OF_DATA = -7
    DECODED_INVALID_DATA = -8
    PACKET_COUNT_EXCEEDED = -9
    FATAL_ERROR = -10
    INVALID_INPUT = -11


class IcerError(Exception):
    """Raised for conditions where the reference returns a fatal status."""

    def __init__(self, status: IcerStatus, message: str = ""):
        self.status = status
        super().__init__(f"{status.name}: {message}" if message else status.name)
