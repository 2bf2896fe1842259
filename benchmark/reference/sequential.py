"""The sequential, bit-exact ICER interleaved entropy encoder, one segment
plane a bit at a time: the ground truth that ``lanes`` (many planes at
once) is held to in the benchmark's tests.  Copied from the JAX package's
``backend/sequential.py`` (its decoder left out).  Behaviour mirrors
lib_icer/src/icer_encoding.c, including its quirks:

  - the codeword-in-progress buffer holds at most CIRC_BUF_SIZE words; when
    full, the *oldest* in-progress codeword is force-completed with the
    bin's flush rule (icer_encoding.c:59-64, 141-189);
  - counter rescaling halves zero_count only when it exceeds the halved
    total_count (the reference discards the ceil-div result on the other
    branch, icer_context_modeller.c:398-402).
"""

from __future__ import annotations

import numpy as np

from . import constants as C
from .context_model import CTX_UNCODED

_DONE = 1 << 10
_DATA_MASK = (1 << 10) - 1
_BITS_OFFSET = 11


def compute_bin(zero_cnt: int, total_cnt: int) -> int:
    """Bin selection from (possibly inverted) counts (icer_util.c:48-56)."""
    comp = zero_cnt * C.BIN_PROBABILITY_DENOMINATOR
    for b in range(C.ENCODER_BIN_MAX, 0, -1):
        if comp >= total_cnt * int(C.BIN_PROBABILITY_CUTOFFS[b - 1]):
            return b
    return 0


class ContextCounters:
    """Adaptive per-context zero/total counters with capped rescaling."""

    __slots__ = ("zero", "total")

    def __init__(self):
        self.zero = [C.DEFAULT_CONTEXT_ZERO_COUNT] * (C.CONTEXT_MAX + 1)
        self.total = [C.DEFAULT_CONTEXT_TOTAL_COUNT] * (C.CONTEXT_MAX + 1)

    def update(self, ctx: int, bit: int) -> None:
        self.total[ctx] += 1
        if not bit:
            self.zero[ctx] += 1
        if self.total[ctx] >= C.CONTEXT_RESCALING_CAP:
            self.total[ctx] >>= 1
            if self.zero[ctx] > self.total[ctx]:
                self.zero[ctx] >>= 1
            # else: reference computes ceil(zero/2) and discards it.


class InterleavedEncoder:
    """Bin-interleaved entropy encoder with arrival-order codeword output."""

    def __init__(self, buffer_length: int = C.CIRC_BUF_SIZE):
        self.buffer_length = buffer_length
        self.words: list[int] = []     # codewords, allocation order
        self.head = 0                  # index of first un-popped word
        self.bin_word = [-1] * (C.ENCODER_BIN_MAX + 1)   # open word per bin
        self.bin_bits = [0] * (C.ENCODER_BIN_MAX + 1)    # custom prefix len
        self.out = bytearray()
        self.out_bits = 0              # total payload bits emitted
        self.flush_events = 0          # mid-plane forced flushes (stats)

    # -- output bit packing (LSB-first within each byte) ------------------
    def _emit(self, value: int, nbits: int) -> None:
        pos = self.out_bits
        self.out_bits += nbits
        need = (self.out_bits + 7) // 8
        while len(self.out) < need:
            self.out.append(0)
        while nbits > 0:
            byte_i, bit_i = divmod(pos, 8)
            take = min(8 - bit_i, nbits)
            self.out[byte_i] |= (value & ((1 << take) - 1)) << bit_i
            value >>= take
            nbits -= take
            pos += take

    def _pop_available(self) -> None:
        while self.head < len(self.words) and (self.words[self.head] & _DONE):
            w = self.words[self.head]
            self.head += 1
            self._emit(w & _DATA_MASK, w >> _BITS_OFFSET)

    @property
    def used(self) -> int:
        return len(self.words) - self.head

    # -- codeword completion helpers --------------------------------------
    @staticmethod
    def _golomb_done_word(b: int, k: int) -> int:
        v = int(C.GOLOMB_CODE_VALUE[b, k])
        nb = int(C.GOLOMB_CODE_BITS[b, k])
        return (nb << _BITS_OFFSET) | _DONE | v

    def _flush_head(self) -> None:
        """Force-complete the oldest in-progress codeword (flush rule)."""
        w = self.words[self.head]
        if not (w & _DONE):
            b = w >> _BITS_OFFSET   # in-progress words store their bin here
            if b > 7:               # Golomb bins
                k = w & _DATA_MASK
                if k == int(C.GOLOMB_M[b]) - 1:
                    self.words[self.head] = (1 << _BITS_OFFSET) | _DONE | 1
                else:
                    self.words[self.head] = self._golomb_done_word(b, k)
                self.bin_word[b] = -1
            elif b != 0:            # custom-code bins
                prefix = w & _DATA_MASK
                nbits = self.bin_bits[b]
                # States absent from the reference flush table read zeros
                # (append nothing) and the prefix value is looked up as-is;
                # e.g. bin 6 state [0,1] flushes straight to the '010' code.
                fv, fn = C.CUSTOM_FLUSH_BITS[b].get((prefix, nbits), (0, 0))
                prefix |= fv << nbits
                ov = int(C.CUSTOM_OUT_CODE[b, prefix])
                ob = int(C.CUSTOM_OUT_BITS[b, prefix])
                self.words[self.head] = (ob << _BITS_OFFSET) | _DONE | ov
                self.bin_word[b] = -1
                self.bin_bits[b] = 0
            # uncoded bin words are always done immediately.
        self._pop_available()

    # -- main entry --------------------------------------------------------
    def encode_bit(self, bit: int, zero_cnt: int, total_cnt: int) -> None:
        if zero_cnt < (total_cnt >> 1):
            zero_cnt = total_cnt - zero_cnt
            bit ^= 1
        b = compute_bin(zero_cnt, total_cnt)

        idx = self.bin_word[b]
        if idx < 0:
            if self.used >= self.buffer_length:
                self.flush_events += 1
                self._flush_head()
            idx = len(self.words)
            self.words.append(b << _BITS_OFFSET)
            self.bin_word[b] = idx
        w = self.words[idx]

        if b > 7:
            # Golomb run-length bins.
            if not bit:
                w += 1
                if (w & _DATA_MASK) >= int(C.GOLOMB_M[b]):
                    w = (1 << _BITS_OFFSET) | _DONE | 1
                    self.bin_word[b] = -1
            else:
                k = w & _DATA_MASK
                w = self._golomb_done_word(b, k)
                self.bin_word[b] = -1
        elif b != 0:
            # Custom variable-to-variable bins.
            w |= bit << self.bin_bits[b]
            self.bin_bits[b] += 1
            prefix = w & _DATA_MASK
            if int(C.CUSTOM_IN_BITS[b, prefix]) == self.bin_bits[b]:
                ov = int(C.CUSTOM_OUT_CODE[b, prefix])
                ob = int(C.CUSTOM_OUT_BITS[b, prefix])
                w = (ob << _BITS_OFFSET) | _DONE | ov
                self.bin_word[b] = -1
                self.bin_bits[b] = 0
        else:
            # Uncoded bin: done immediately.
            w = (1 << _BITS_OFFSET) | _DONE | (bit & 1)
            self.bin_word[b] = -1
        self.words[idx] = w
        self._pop_available()

    def flush(self) -> None:
        """End-of-plane drain (icer_context_modeller.c:452-455)."""
        while self.used > 0:
            self._flush_head()

    def payload(self) -> tuple[bytes, int]:
        """(payload bytes, exact bit length)."""
        return bytes(self.out), self.out_bits


def encode_emissions(valid, ctx, bit) -> tuple[bytes, int, int]:
    """Entropy-encode one segment plane from pass-1 emission arrays.

    Returns (payload, bit_length, flush_events).
    """
    enc = InterleavedEncoder()
    counters = ContextCounters()
    valid = np.asarray(valid)
    ctx = np.asarray(ctx)
    bit = np.asarray(bit)
    idx = np.nonzero(valid)[0]
    for i in idx:
        c = int(ctx[i])
        v = int(bit[i])
        if c == CTX_UNCODED:
            enc.encode_bit(v, 1, 2)
        else:
            enc.encode_bit(v, counters.zero[c], counters.total[c])
            counters.update(c, v)
    enc.flush()
    payload, nbits = enc.payload()
    return payload, nbits, enc.flush_events
