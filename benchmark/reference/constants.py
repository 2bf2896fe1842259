"""Format constants of the ICER bitstream.

Everything in this module is *data*: the tables that define the ICER
compressed-image format (wavelet filter coefficients, context-model tables,
entropy-coder bins, variable-length code books, Golomb parameters, flush
rules).  They are the contract shared with the reference C implementation
(`lib_icer/src/icer_config.c`, `icer_init.c`); any deviation breaks bitstream
interoperability, so the values are transcribed exactly and unit-tested
against the reference build.

Unlike the reference, which builds several of these tables at runtime
(``icer_init()``, see ``lib_icer/src/icer_init.c:24``), everything here is a
module-level constant: there is no init call in this framework.
"""

from __future__ import annotations

import numpy as np

# --------------------------------------------------------------------------
# Capacity / format limits (icer.h:27-46)
# --------------------------------------------------------------------------
CIRC_BUF_SIZE = 2048          # encoder codeword-reorder window (words)
MAX_SEGMENTS = 32
MAX_DECOMP_STAGES = 6
MAX_PACKETS_8 = 300
MAX_PACKETS_16 = 800
BITPLANES_8 = 7               # bitplanes coded for 8-bit samples
BITPLANES_16 = 9              # bitplanes coded for 16-bit samples

PACKET_PREAMBLE = 0x605B      # segment header magic (icer.h:286)
HEADER_SIZE = 28              # sizeof(icer_image_segment_typedef)

FILTER_DENOMINATOR = 16

# Context-model counter dynamics (icer.h:146-149)
DEFAULT_CONTEXT_ZERO_COUNT = 2
DEFAULT_CONTEXT_TOTAL_COUNT = 4
CONTEXT_RESCALING_CAP = 500

CONTEXT_MAX = 16              # contexts 0..16
ENCODER_BIN_MAX = 16          # bins 0..16 (BIN_1..BIN_17)
DECODER_BIT_BIN_MAX = 30      # decoder per-bin FIFO capacity (32-bit words)

BIN_PROBABILITY_DENOMINATOR = 65536

# --------------------------------------------------------------------------
# Filters (icer_config.c:18-24).  Rows indexed by icer_filter_types A..Q,
# columns are (alpha_-1, alpha_0, alpha_1, beta), denominator 16.
# --------------------------------------------------------------------------
FILTER_A, FILTER_B, FILTER_C, FILTER_D, FILTER_E, FILTER_F, FILTER_Q = range(7)
FILTER_NAMES = "ABCDEFQ"

WAVELET_FILTER_PARAMETERS = np.array(
    [
        [0, 4, 4, 0],    # A
        [0, 4, 6, 4],    # B
        [-1, 4, 8, 6],   # C
        [0, 4, 5, 2],    # D
        [0, 3, 8, 6],    # E
        [0, 3, 9, 8],    # F
        [0, 4, 4, 4],    # Q
    ],
    dtype=np.int16,
)

# --------------------------------------------------------------------------
# Subbands / channels
# --------------------------------------------------------------------------
SUBBAND_LL, SUBBAND_HL, SUBBAND_LH, SUBBAND_HH = range(4)
SUBBAND_MAX = 3
CHANNEL_Y, CHANNEL_U, CHANNEL_V = range(3)
CHANNEL_MAX = 2

# --------------------------------------------------------------------------
# Context tables (icer_config.c:26-67).
# --------------------------------------------------------------------------
# For LL/LH/HL subbands: indexed [h][v][d] with h,v clipped to 2, d to 4.
CONTEXT_TABLE_LL_LH_HL = np.array(
    [
        [[0, 1, 2, 2, 2], [3, 3, 3, 3, 3], [4, 4, 4, 4, 4]],
        [[5, 6, 7, 7, 7], [7, 7, 7, 7, 7], [7, 7, 7, 7, 7]],
        [[8, 8, 8, 8, 8], [8, 8, 8, 8, 8], [8, 8, 8, 8, 8]],
    ],
    dtype=np.uint8,
)

# For HH subbands: indexed [h+v][d].
CONTEXT_TABLE_HH = np.array(
    [
        [0, 3, 6, 8, 8],
        [1, 4, 7, 8, 8],
        [2, 5, 7, 8, 8],
        [2, 5, 7, 8, 8],
        [2, 5, 7, 8, 8],
    ],
    dtype=np.uint8,
)

# Sign coding: indexed [sh][sv] where sh/sv = sh0+sh1+2 in 0..4.
SIGN_CONTEXT_TABLE = np.array(
    [
        [14, 14, 15, 16, 16],
        [14, 14, 15, 16, 16],
        [13, 13, 12, 13, 13],
        [16, 16, 15, 14, 14],
        [16, 16, 15, 14, 14],
    ],
    dtype=np.uint8,
)

# 1 predicts negative, 0 predicts positive.
SIGN_PREDICTION_TABLE = np.array(
    [
        [1, 1, 1, 1, 1],
        [1, 1, 1, 1, 1],
        [0, 0, 0, 1, 1],
        [0, 0, 0, 0, 0],
        [0, 0, 0, 0, 0],
    ],
    dtype=np.uint8,
)

# --------------------------------------------------------------------------
# Entropy-coder bins (icer_config.c:69-107)
# --------------------------------------------------------------------------
# P(0) cutoffs scaled by 65536; a bit whose (possibly inverted) zero
# probability satisfies zero*65536 >= total*cutoff[b-1] belongs to bin >= b.
BIN_PROBABILITY_CUTOFFS = np.array(
    [
        35298, 37345, 40503, 43591, 47480, 50133, 53645, 55902, 57755,
        58894, 60437, 62267, 63613, 64557, 65134, 65392, 65536,
    ],
    dtype=np.uint32,
)

# 0 = uncoded, -1 = custom variable-to-variable code, m>0 = Golomb parameter.
BIN_CODING_SCHEME = np.array(
    [0, -1, -1, -1, -1, -1, -1, -1, 5, 6, 7, 11, 17, 31, 70, 200, 512],
    dtype=np.int32,
)

# Golomb (m, l, i) per bin: l = ceil(log2 m), i = 2^l - m
# (derivation mirrors icer_init.c:239-256).
def _golomb_params() -> np.ndarray:
    out = np.zeros((ENCODER_BIN_MAX + 1, 3), dtype=np.int32)
    for b, m in enumerate(BIN_CODING_SCHEME):
        if m > 0:
            l = int(m).bit_length() - 1
            if (1 << l) != m:
                l += 1
            out[b] = (m, l, (1 << l) - m)
    return out


GOLOMB_PARAMS = _golomb_params()          # rows: (m, l, i)
GOLOMB_M = GOLOMB_PARAMS[:, 0]
GOLOMB_L = GOLOMB_PARAMS[:, 1]
GOLOMB_I = GOLOMB_PARAMS[:, 2]

# --------------------------------------------------------------------------
# Custom variable-to-variable codes for bins 2-8 (icer_init.c:124-188).
#
# Each entry maps a complete *input* bit pattern (value, nbits; first coded
# bit in the LSB) to an *output* codeword (value, nbits; emitted LSB-first
# into the packed stream).  The input patterns of each bin form a complete
# prefix-free code over input sequences.
# --------------------------------------------------------------------------
BIN_2, BIN_3, BIN_4, BIN_5, BIN_6, BIN_7, BIN_8 = range(1, 8)

CUSTOM_CODES: dict[int, list[tuple[int, int, int, int]]] = {
    # bin: [(input_value, input_bits, output_value, output_bits), ...]
    BIN_2: [
        (0b01, 2, 0b10, 2),
        (0b011, 3, 0b011, 3),
        (0b0111, 4, 0b1111, 4),
        (0b1111, 4, 0b10000, 5),
        (0b10, 2, 0b01, 2),
        (0b100, 3, 0b100, 3),
        (0b1000, 4, 0b1000, 4),
        (0b10000, 5, 0b00000, 5),
        (0b00000, 5, 0b0111, 4),
    ],
    BIN_3: [
        (0b10, 2, 0b01, 2),
        (0b100, 3, 0b00, 2),
        (0b0000, 4, 0b011, 3),
        (0b11000, 5, 0b10010, 5),
        (0b01000, 5, 0b1111, 4),
        (0b01, 2, 0b110, 3),
        (0b0011, 4, 0b0111, 4),
        (0b1011, 4, 0b00010, 5),
        (0b111, 3, 0b1010, 4),
    ],
    BIN_4: [
        (0b10, 2, 0b10, 2),
        (0b100, 3, 0b011, 3),
        (0b000, 3, 0b00, 2),
        (0b01, 2, 0b01, 2),
        (0b11, 2, 0b111, 3),
    ],
    BIN_5: [
        (0b00, 2, 0b1, 1),
        (0b010, 3, 0b000, 3),
        (0b110, 3, 0b1010, 4),
        (0b101, 3, 0b0010, 4),
        (0b1001, 4, 0b1110, 4),
        (0b00001, 5, 0b0100, 4),
        (0b10001, 5, 0b00110, 5),
        (0b011, 3, 0b1100, 4),
        (0b111, 3, 0b10110, 5),
    ],
    BIN_6: [
        (0b1, 1, 0b10, 2),
        (0b010, 3, 0b011, 3),
        (0b110, 3, 0b1111, 4),
        (0b100, 3, 0b101, 3),
        (0b1000, 4, 0b001, 3),
        (0b10000, 5, 0b0111, 4),
        (0b00000, 5, 0b00, 2),
    ],
    BIN_7: [
        (0b000, 3, 0b0, 1),
        (0b100, 3, 0b001, 3),
        (0b010, 3, 0b101, 3),
        (0b110, 3, 0b01111, 5),
        (0b11, 2, 0b0111, 4),
        (0b001, 3, 0b011, 3),
        (0b101, 3, 0b11111, 5),
    ],
    BIN_8: [
        (0b10, 2, 0b101, 3),
        (0b100, 3, 0b001, 3),
        (0b0000, 4, 0b0, 1),
        (0b01000, 5, 0b0111, 4),
        (0b11000, 5, 0b01111, 5),
        (0b01, 2, 0b011, 3),
        (0b11, 2, 0b11111, 5),
    ],
}

# Flush rules for partially-accumulated custom-code input prefixes
# (icer_init.c:191-237): (prefix_value, prefix_bits) -> (append_value,
# append_bits).  Appending ``append_value`` (LSB-first) at bit position
# ``prefix_bits`` always yields a complete input pattern of the bin.
CUSTOM_FLUSH_BITS: dict[int, dict[tuple[int, int], tuple[int, int]]] = {
    BIN_2: {
        (0b1, 1): (0, 1), (0b11, 2): (0, 1), (0b111, 3): (0, 1),
        (0b0, 1): (1, 1), (0b00, 2): (1, 1), (0b000, 3): (1, 1),
        (0b0000, 4): (0, 1),
    },
    BIN_3: {
        (0b0, 1): (1, 1), (0b00, 2): (1, 1), (0b000, 3): (0, 1),
        (0b1000, 4): (0, 1), (0b1, 1): (0, 1), (0b11, 2): (1, 1),
        (0b011, 3): (0, 1),
    },
    BIN_4: {
        (0b0, 1): (1, 1), (0b00, 2): (0, 1), (0b1, 1): (0, 1),
    },
    BIN_5: {
        (0b0, 1): (0, 1), (0b10, 2): (0, 1), (0b01, 2): (1, 1),
        (0b001, 3): (1, 1), (0b0001, 4): (0, 1), (0b1, 1): (0b01, 2),
        (0b11, 2): (0, 1),
    },
    BIN_6: {
        (0b0, 1): (0b01, 2), (0b01, 2): (0, 1), (0b00, 2): (1, 1),
        (0b000, 3): (1, 1), (0b0000, 4): (0, 1),
    },
    BIN_7: {
        (0b0, 1): (0b00, 2), (0b00, 2): (0, 1), (0b10, 2): (0, 1),
        (0b1, 1): (1, 1), (0b01, 2): (0, 1),
    },
    BIN_8: {
        (0b0, 1): (1, 1), (0b00, 2): (1, 1), (0b000, 3): (0, 1),
        (0b1000, 4): (0, 1), (0b1, 1): (0, 1),
    },
}

# --------------------------------------------------------------------------
# Derived dense LUTs (for the vectorized / TPU paths)
# --------------------------------------------------------------------------
CUSTOM_CODING_MAX_LOOKUP = 32


def _dense_custom_tables():
    """Dense encode tables: for each bin, indexed by input prefix value.

    enc_complete[bin, value, nbits] -> 1 if (value, nbits) is a complete
    input pattern; enc_out_code / enc_out_bits give the output codeword.
    """
    n = ENCODER_BIN_MAX + 1
    complete = np.zeros((n, CUSTOM_CODING_MAX_LOOKUP, 6), dtype=np.uint8)
    out_code = np.zeros((n, CUSTOM_CODING_MAX_LOOKUP), dtype=np.uint16)
    out_bits = np.zeros((n, CUSTOM_CODING_MAX_LOOKUP), dtype=np.uint8)
    in_bits = np.zeros((n, CUSTOM_CODING_MAX_LOOKUP), dtype=np.uint8)
    for b, entries in CUSTOM_CODES.items():
        for (iv, ib, ov, ob) in entries:
            complete[b, iv, ib] = 1
            out_code[b, iv] = ov
            out_bits[b, iv] = ob
            in_bits[b, iv] = ib
    return complete, out_code, out_bits, in_bits


(CUSTOM_COMPLETE, CUSTOM_OUT_CODE, CUSTOM_OUT_BITS, CUSTOM_IN_BITS) = (
    _dense_custom_tables()
)


def reverse_bits(value: int, nbits: int) -> int:
    """Bit-reverse ``value`` over ``nbits`` bits (icer.h:602-610)."""
    r = 0
    for _ in range(nbits):
        r = (r << 1) | (value & 1)
        value >>= 1
    return r


def golomb_codeword(bin_idx: int, k: int) -> tuple[int, int]:
    """Codeword for a run of ``k`` zeros terminated by a one in a Golomb bin.

    Returns (value, nbits) with the value emitted LSB-first, mirroring
    icer_encoding.c:69-86.  A full run of m zeros (no terminating one) is the
    single bit '1' and is handled by the caller.
    """
    m, l, i = (int(GOLOMB_M[bin_idx]), int(GOLOMB_L[bin_idx]),
               int(GOLOMB_I[bin_idx]))
    assert 0 <= k < m
    code = k + (0 if k < i else i)
    nbits = l + (1 if k >= i else 0)
    return reverse_bits(code, nbits), nbits


def _golomb_lut():
    """Dense LUT: golomb_code_value/bits[bin, k] for k in 0..m-1.

    Index k == m means "full run of m zeros" -> codeword '1' (1 bit).
    """
    n = ENCODER_BIN_MAX + 1
    mmax = int(GOLOMB_M.max())
    val = np.zeros((n, mmax + 1), dtype=np.uint16)
    bits = np.zeros((n, mmax + 1), dtype=np.uint8)
    for b in range(n):
        m = int(GOLOMB_M[b])
        if m <= 0:
            continue
        for k in range(m):
            v, nb = golomb_codeword(b, k)
            val[b, k] = v
            bits[b, k] = nb
        val[b, m] = 1
        bits[b, m] = 1
    return val, bits


GOLOMB_CODE_VALUE, GOLOMB_CODE_BITS = _golomb_lut()
