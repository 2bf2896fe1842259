"""Sequential, bit-exact interleaved entropy coder and decoder.

Counterpart: ``icer_compression_tpu/backend/sequential.py``
(``compute_bin``, ``ContextCounters``, ``InterleavedEncoder``,
``encode_emissions``, ``InterleavedDecoder``).  The encoder is the
reference the native runtime's re-encode of flagged lanes is held to, and
codes the planes of the host codec's ``numpy`` path that need the
reorder-window flush; the decoder runs the host codec's ``python`` decode
(backend/decode_plane).  Behaviour mirrors lib_icer/src/icer_encoding.c
and icer_decoding.c, including their quirks:

  - the codeword-in-progress buffer holds at most CIRC_BUF_SIZE words; when
    full, the *oldest* in-progress codeword is force-completed with the
    bin's flush rule (icer_encoding.c:59-64, 141-189);
  - counter rescaling halves zero_count only when it exceeds the halved
    total_count (icer_context_modeller.c:398-402);
  - the decoder discards a bin's buffered bits when its last codeword is
    CIRC_BUF_SIZE decoded codewords old (icer_decoding.c:128);
  - the decoder's out-of-data guards compare against the frozen total
    stream length (icer_decoding.c:14 is its only write).
"""

from __future__ import annotations

import numpy as np

from ..core import constants as C
from ..core.status import IcerError, IcerStatus

CTX_UNCODED = 17

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

    def _emit(self, value: int, nbits: int) -> None:
        """Append ``nbits`` of ``value``, LSB-first within each byte."""
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
                # states absent from the reference flush table append
                # nothing and the prefix value is looked up as-is
                fv, fn = C.CUSTOM_FLUSH_BITS[b].get((prefix, nbits), (0, 0))
                prefix |= fv << nbits
                ov = int(C.CUSTOM_OUT_CODE[b, prefix])
                ob = int(C.CUSTOM_OUT_BITS[b, prefix])
                self.words[self.head] = (ob << _BITS_OFFSET) | _DONE | ov
                self.bin_word[b] = -1
                self.bin_bits[b] = 0
            # uncoded bin words are always done immediately.
        self._pop_available()

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
    """Entropy-encode one segment plane from its emission arrays.

    Returns (payload, bit_length, flush_events)."""
    enc = InterleavedEncoder()
    counters = ContextCounters()
    valid = np.asarray(valid)
    ctx = np.asarray(ctx)
    bit = np.asarray(bit)
    for i in np.nonzero(valid)[0]:
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


class InterleavedDecoder:
    """Mirror of icer_decoder_context_typedef and icer_decode_bit."""

    def __init__(self, payload, encoded_bits: int):
        self.data = payload
        self.encoded_bits = encoded_bits
        self.pos = 0                   # consumed bit position
        self.decoded_words = 0
        self.bin_buf = [0] * (C.ENCODER_BIN_MAX + 1)
        self.bin_bits = [0] * (C.ENCODER_BIN_MAX + 1)
        self.bin_decode_index = [0] * (C.ENCODER_BIN_MAX + 1)

    def _bit_at(self, bitpos: int) -> int:
        byte_i, bit_i = divmod(bitpos, 8)
        if byte_i >= len(self.data):
            return 0   # the reference reads adjacent memory here; zeros
        return (self.data[byte_i] >> bit_i) & 1

    def _peek_bit(self, ahead: int) -> int:
        """icer_get_bit_from_codeword: the ``ahead``-th next bit."""
        return self._bit_at(self.pos + ahead - 1)

    def _peek_bits(self, nbits: int) -> int:
        if nbits > self.encoded_bits:
            raise IcerError(IcerStatus.DECODER_OUT_OF_DATA)
        v = 0
        for i in range(nbits):
            v |= self._bit_at(self.pos + i) << i
        return v

    def _pop_bits(self, nbits: int) -> int:
        v = self._peek_bits(nbits)
        self.pos += nbits
        return v

    # per-bin stack, consumed newest first (the original coding order)
    def _push(self, value: int, nbits: int, b: int) -> None:
        self.bin_buf[b] |= value << self.bin_bits[b]
        self.bin_bits[b] += nbits

    def _consume(self, b: int) -> int:
        n = self.bin_bits[b] - 1
        bitv = (self.bin_buf[b] >> n) & 1
        self.bin_buf[b] &= ~(1 << n)
        self.bin_bits[b] = n
        return bitv

    def decode_bit(self, zero_cnt: int, total_cnt: int) -> int:
        inv = 0
        if zero_cnt < (total_cnt >> 1):
            zero_cnt = total_cnt - zero_cnt
            inv = 1
        b = compute_bin(zero_cnt, total_cnt)
        if (self.bin_bits[b] <= 0 or self.decoded_words
                - self.bin_decode_index[b] >= C.CIRC_BUF_SIZE):
            self.bin_bits[b] = 0
            self.bin_buf[b] = 0
            if b > 7:
                # golomb bins
                m, l, i = (int(C.GOLOMB_M[b]), int(C.GOLOMB_L[b]),
                           int(C.GOLOMB_I[b]))
                if self._peek_bit(1):
                    self._pop_bits(1)
                    self._push(0, m, b)
                else:
                    k = C.reverse_bits(self._peek_bits(l), l)
                    if k < i:
                        self._pop_bits(l)
                        self._push(1, 1, b)
                        self._push(0, k, b)
                    else:
                        k = C.reverse_bits(self._pop_bits(l + 1), l + 1)
                        self._push(1, 1, b)
                        self._push(0, k - i, b)
            elif b != 0:
                # custom codes: incremental prefix match, at most 10 bits
                codeword = 0
                num_bits = 0
                while True:
                    if num_bits + 1 >= self.encoded_bits:
                        raise IcerError(IcerStatus.DECODER_OUT_OF_DATA)
                    codeword |= self._peek_bit(num_bits + 1) << num_bits
                    num_bits += 1
                    if codeword >= C.CUSTOM_CODING_MAX_LOOKUP:
                        raise IcerError(IcerStatus.DECODED_INVALID_DATA)
                    hit = _DECODE_LOOKUP[b].get((codeword, num_bits))
                    if hit is not None:
                        in_val, in_bits = hit
                        self._push(C.reverse_bits(in_val, in_bits), in_bits,
                                   b)
                        if self._pop_bits(num_bits) != codeword:
                            raise IcerError(IcerStatus.DECODED_INVALID_DATA)
                        break
                    if num_bits >= 10:
                        raise IcerError(IcerStatus.DECODED_INVALID_DATA)
            else:
                # uncoded bin
                self._push(self._pop_bits(1), 1, b)
            self.decoded_words += 1
            self.bin_decode_index[b] = self.decoded_words
        return self._consume(b) ^ inv


def _build_decode_lookup():
    """Stream codeword (value, nbits) -> input pattern (value, nbits) per
    custom bin: the inverse of the encode tables (icer_init_decodescheme
    and its bit reversal)."""
    tables: list[dict] = [dict() for _ in range(C.ENCODER_BIN_MAX + 1)]
    for b, entries in C.CUSTOM_CODES.items():
        for (iv, ib, ov, ob) in entries:
            tables[b][(ov, ob)] = (iv, ib)
    return tables


_DECODE_LOOKUP = _build_decode_lookup()
