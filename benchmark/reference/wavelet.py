"""Integer lifting wavelet transform (filters A-F, Q), vectorized.

The reference transforms one row/column at a time in place with an
in-shuffle deinterleave (icer_wavelet.c:385-550, 570-820).  Here every
row (and then every column) of a stage transforms as one batched array op:
the pairwise mean/diff lifting and the high-pass prediction are shift/add/
floor-div operations on strided slices, and the low|high split is a simple
concatenation -- no in-place cycle-leader permutation needed.  On TPU all
of it lowers to VPU integer ops over (rows, cols) blocks.

Exactness notes:
  - floor division matches icer_floor_div_* (true floor);
  - sample arithmetic wraps to int8/int16 exactly as the C casts do, and a
    wrap is reported via the returned overflow flag (icer_wavelet.c:412);
  - prediction boundary cases: n==0, (n==1 for filter C), and the last even
    index use the special formulas of icer_wavelet.c:434-442;
  - for all filters except A (beta != 0) the *inverse* prediction is a
    backward recurrence (each restored high feeds the next prediction);
    the forward direction reads only original values and stays parallel.

Legal configurations always have 1-D lengths >= 5 (the <3x3 LL guard in
icer_wavelet_transform_stages_* caps stages), which this implementation
assumes; N in {2, 4} corner quirks of the reference are out of contract.
"""

from __future__ import annotations

import numpy as np

from . import constants as C
from .subbands import dim_low
from .status import IcerError, IcerStatus
from .bitutils import floor_div


def _limits(mag_bits: int):
    # mag_bits = 7 -> int8 samples, 15 -> int16 samples.
    lo = -(1 << mag_bits)
    hi = (1 << mag_bits) - 1
    return lo, hi


def _wrap(v, mag_bits: int, xp):
    """Wrap int32 values to int8/int16 two's complement (C cast)."""
    bits = mag_bits + 1
    m = (1 << bits) - 1
    w = v & m
    return w - ((w >> (bits - 1)) << bits)


def forward_1d(x, filt: int, mag_bits: int, xp=np):
    """Forward lifting along the last axis.  Returns (out, overflow).

    out = [lows | highs] concatenated along the last axis.
    """
    N = x.shape[-1]
    lo_lim, hi_lim = _limits(mag_bits)
    x = x.astype(xp.int32)
    is_odd = bool(N & 1)
    half = N // 2

    d1 = x[..., 0:2 * half:2]
    d2 = x[..., 1:2 * half:2]
    low = floor_div(d1 + d2, 2, xp)
    high = d1 - d2
    overflow = (
        (low > hi_lim) | (low < lo_lim) | (high > hi_lim) | (high < lo_lim)
    ).any()
    low = _wrap(low, mag_bits, xp)
    high = _wrap(high, mag_bits, xp)
    if is_odd:
        lows = xp.concatenate([low, x[..., N - 1:N]], axis=-1)
    else:
        lows = low
    # lows has half (+1 if odd) entries; highs has half entries.

    # High-pass prediction: subtract[n] from lows differences and the
    # *original* next high (fully parallel in the forward direction).
    a_n1, a_0, a_1, beta = (int(v) for v in C.WAVELET_FILTER_PARAMETERS[filt])
    nL = lows.shape[-1]
    r = xp.concatenate(
        [xp.ones(lows.shape[:-1] + (1,), dtype=xp.int32),
         lows[..., :-1] - lows[..., 1:]], axis=-1)   # r[0]=1, r[n]=L[n-1]-L[n]

    # d_next[n] = original high[n+1], 0 past the end (covers the odd-tail
    # zero of get_d and the even case where the branch never reads it).
    zeros1 = xp.zeros(high.shape[:-1] + (1,), dtype=xp.int32)
    d_next = xp.concatenate([high[..., 1:], zeros1], axis=-1)

    # The general term uses r[n-1], r[n], r[n+1]; slots where an index runs
    # past the lows (even N at n == half-1) are overridden by the boundary
    # formulas below, so out-of-range reads as 0 are never observed.
    def r_at(k_off):
        # r shifted so slot n holds r[n + k_off]; out-of-range -> 0.
        src = r
        if k_off == -1:
            return xp.concatenate([xp.zeros(r.shape[:-1] + (1,), dtype=xp.int32), src[..., :half - 1]], axis=-1)
        if k_off == 0:
            return src[..., :half]
        if k_off == 1:
            if nL >= half + 1:
                return src[..., 1:half + 1]
            return xp.concatenate([src[..., 1:nL],
                                   xp.zeros(r.shape[:-1] + (half + 1 - nL,), dtype=xp.int32)], axis=-1)
        raise AssertionError

    general = floor_div(
        a_n1 * r_at(-1) + a_0 * r_at(0) + a_1 * r_at(1) - beta * d_next + 8,
        C.FILTER_DENOMINATOR, xp)

    subtract = general
    # n == 0: floor(r[1] / 4).
    sub0 = floor_div(r[..., 1:2], 4, xp)
    pos = xp.asarray(np.arange(half), dtype=xp.int32)
    subtract = xp.where(pos == 0, xp.broadcast_to(sub0, subtract.shape), subtract)
    # n == 1 for filter C.  The reference passes offset=low_N (not
    # low_N + 1) to get_d here (icer_wavelet.c:437-439), so the "d" term is
    # the *original high[1]* -- the very sample being predicted -- and 0
    # when N == 5 (is_odd && low_N == 2).  Filter C is therefore not
    # losslessly invertible in the reference either; we replicate it
    # bit-for-bit for stream interop.
    if a_n1 != 0 and half > 1:
        if is_odd and (N // 2) == 2:
            d2v = xp.zeros(high.shape[:-1] + (1,), dtype=xp.int32)
        else:
            d2v = high[..., 1:2]
        sub1 = floor_div(2 * r[..., 1:2] + 3 * r[..., 2:3] - 2 * d2v + 4, 8, xp)
        subtract = xp.where(pos == 1, xp.broadcast_to(sub1, subtract.shape), subtract)
    # Last n for even N: floor(r[N/2-1] / 4).
    if not is_odd:
        sub_last = floor_div(r[..., half - 1:half], 4, xp)
        subtract = xp.where(pos == half - 1,
                            xp.broadcast_to(sub_last, subtract.shape), subtract)

    h_out = high - subtract
    overflow = overflow | ((h_out > hi_lim) | (h_out < lo_lim)).any()
    h_out = _wrap(h_out, mag_bits, xp)
    return xp.concatenate([lows, h_out], axis=-1), overflow


def inverse_1d(x, filt: int, mag_bits: int, xp=np):
    """Inverse of forward_1d along the last axis.  Returns (out, overflow)."""
    N = x.shape[-1]
    lo_lim, hi_lim = _limits(mag_bits)
    x = x.astype(xp.int32)
    is_odd = bool(N & 1)
    half = N // 2
    nL = half + 1 if is_odd else half
    lows = x[..., :nL]
    highs = x[..., nL:]

    a_n1, a_0, a_1, beta = (int(v) for v in C.WAVELET_FILTER_PARAMETERS[filt])

    r = xp.concatenate(
        [xp.ones(lows.shape[:-1] + (1,), dtype=xp.int32),
         lows[..., :-1] - lows[..., 1:]], axis=-1)

    def r_at(k_off):
        if k_off == -1:
            return xp.concatenate([xp.zeros(r.shape[:-1] + (1,), dtype=xp.int32),
                                   r[..., :half - 1]], axis=-1)
        if k_off == 0:
            return r[..., :half]
        if nL >= half + 1:
            return r[..., 1:half + 1]
        return xp.concatenate([r[..., 1:nL],
                               xp.zeros(r.shape[:-1] + (half + 1 - nL,), dtype=xp.int32)], axis=-1)

    pos = xp.asarray(np.arange(half), dtype=xp.int32)
    overflow = xp.zeros((), dtype=bool)

    def boundary_add(d_arr):
        """Prediction terms that do not depend on d (n==0 / last-even)."""
        add = floor_div(
            a_n1 * r_at(-1) + a_0 * r_at(0) + a_1 * r_at(1)
            - beta * _next_d(d_arr) + 8, C.FILTER_DENOMINATOR, xp)
        add0 = floor_div(r[..., 1:2], 4, xp)
        add = xp.where(pos == 0, xp.broadcast_to(add0, add.shape), add)
        if a_n1 != 0 and half > 1:
            d2v = _next_d(d_arr)[..., 1:2]
            add1 = floor_div(2 * r[..., 1:2] + 3 * r[..., 2:3] - 2 * d2v + 4, 8, xp)
            add = xp.where(pos == 1, xp.broadcast_to(add1, add.shape), add)
        if not is_odd:
            add_last = floor_div(r[..., half - 1:half], 4, xp)
            add = xp.where(pos == half - 1,
                           xp.broadcast_to(add_last, add.shape), add)
        return add

    def _next_d(d_arr):
        zeros1 = xp.zeros(d_arr.shape[:-1] + (1,), dtype=xp.int32)
        return xp.concatenate([d_arr[..., 1:], zeros1], axis=-1)

    if beta == 0 and a_n1 == 0:
        # Filters A/E/F-style with beta==0 (A only): prediction is
        # independent of d -> fully parallel inverse.
        add = boundary_add(highs)
        d_rec = highs + add
        overflow = ((d_rec > hi_lim) | (d_rec < lo_lim)).any()
        d_rec = _wrap(d_rec, mag_bits, xp)
    else:
        # Backward recurrence: restore d[n] from d[n+1].
        if xp is np:
            d_rec = np.array(highs)
            for n in range(half - 1, -1, -1):
                dn1 = d_rec[..., n + 1] if n + 1 < half else np.zeros(d_rec.shape[:-1], dtype=np.int32)
                if n == 0:
                    add = floor_div(r[..., 1], 4, np)
                elif n == 1 and a_n1 != 0:
                    # Mirrors the forward filter-C quirk: reads the *stored*
                    # (unrestored) high[1] at position offset+1, 0 for N==5.
                    if is_odd and (N // 2) == 2:
                        d2v = np.zeros(d_rec.shape[:-1], dtype=np.int32)
                    else:
                        d2v = highs[..., 1]
                    add = floor_div(2 * r[..., 1] + 3 * r[..., 2] - 2 * d2v + 4, 8, np)
                elif (not is_odd) and n == half - 1:
                    add = floor_div(r[..., half - 1], 4, np)
                else:
                    add = floor_div(
                        a_n1 * r[..., n - 1] + a_0 * r[..., n] + a_1 * r[..., n + 1]
                        - beta * dn1 + 8, C.FILTER_DENOMINATOR, np)
                v = highs[..., n] + add
                if ((v > hi_lim) | (v < lo_lim)).any():
                    overflow = True
                d_rec[..., n] = _wrap(v, mag_bits, np)

    # Un-pair: x[2n] = L[n] + floor((d[n]+1)/2); x[2n+1] = x[2n] - d[n].
    lowp = lows[..., :half]
    tmp = lowp + floor_div(d_rec + 1, 2, xp)
    even = tmp
    odd = tmp - d_rec
    overflow = overflow | ((even > hi_lim) | (even < lo_lim)
                          | (odd > hi_lim) | (odd < lo_lim)).any()
    even = _wrap(even, mag_bits, xp)
    odd = _wrap(odd, mag_bits, xp)
    if is_odd:
        # Odd tail: x[N-1] = L[half] + floor(1/2) = L[half].
        tail = _wrap(lows[..., half:half + 1], mag_bits, xp)
        y = xp.concatenate([even, tail, odd], axis=-1)
    else:
        y = xp.concatenate([even, odd], axis=-1)
    perm = _interleave_perm(N, mag_bits)
    return y[..., perm], overflow


def _interleave_perm(N: int, mag_bits: int) -> np.ndarray:
    """Final interleave permutation: out = y[perm], y = [evens|tail|odds].

    The uint16 path (and even lengths of the uint8 path) interleave evens
    and odds normally.  The reference's uint8 in-place interleave mishandles
    odd lengths (icer_wavelet.c:599: ``halfleft = left/2 - (is_odd?0:1)``),
    yielding a skewed permutation; uint8 odd-length inverse transforms are
    therefore not the inverse of the forward in the reference, and we
    replicate that permutation bit-for-bit for decoder parity.
    """
    m = N // 2
    nL = m + (N & 1)
    if not (N & 1):
        perm = np.empty(N, dtype=np.int64)
        perm[0::2] = np.arange(m)
        perm[1::2] = nL + np.arange(m)
        return perm
    if mag_bits == 15:
        perm = np.empty(N, dtype=np.int64)
        perm[0:2 * m:2] = np.arange(m)
        perm[1:2 * m:2] = nL + np.arange(m)
        perm[N - 1] = m  # tail low lands at the end's interleave slot
        return perm
    # uint8 odd-length quirk: pairs (y[j], y[m+2+j]) for j <= m-2, then
    # y[m-1], y[m], y[m+1] (observed from the reference implementation).
    seq: list[int] = []
    for j in range(m - 1):
        seq.append(j)
        seq.append(m + 2 + j)
    seq.extend([m - 1, m, m + 1])
    return np.asarray(seq, dtype=np.int64)


def forward_2d(img, filt: int, mag_bits: int, xp=np):
    """Rows then columns (icer_wavelet.c:155-171)."""
    rowed, ov1 = forward_1d(img, filt, mag_bits, xp)
    coled_t, ov2 = forward_1d(xp.swapaxes(rowed, -1, -2), filt, mag_bits, xp)
    return xp.swapaxes(coled_t, -1, -2), ov1 | ov2


def inverse_2d(img, filt: int, mag_bits: int, xp=np):
    """Columns then rows (icer_wavelet.c:175-191)."""
    rowed_t, ov1 = inverse_1d(xp.swapaxes(img, -1, -2), filt, mag_bits, xp)
    out, ov2 = inverse_1d(xp.swapaxes(rowed_t, -1, -2), filt, mag_bits, xp)
    return out, ov1 | ov2


def _set_block(img, block, lh: int, lw: int, xp):
    if xp is np:
        img = np.array(img)
        img[..., :lh, :lw] = block
        return img
    return img.at[..., :lh, :lw].set(block)


def check_stages(image_w: int, image_h: int, stages: int) -> None:
    if dim_low(image_w, stages) < 3 or dim_low(image_h, stages) < 3:
        raise IcerError(IcerStatus.TOO_MANY_STAGES,
                        f"{image_w}x{image_h} with {stages} stages")


def forward_stages(img, stages: int, filt: int, mag_bits: int, xp=np):
    """N-stage forward DWT, subbands kept in place.  Returns (img, overflow)."""
    h, w = img.shape[-2], img.shape[-1]
    check_stages(w, h, stages)
    img = img.astype(xp.int32)
    overflow = False
    low_w, low_h = w, h
    for _ in range(stages):
        block, ov = forward_2d(img[..., :low_h, :low_w], filt, mag_bits, xp)
        img = _set_block(img, block, low_h, low_w, xp)
        overflow = ov | overflow
        low_w = low_w // 2 + low_w % 2
        low_h = low_h // 2 + low_h % 2
    return img, overflow


def inverse_stages(img, stages: int, filt: int, mag_bits: int, xp=np):
    """N-stage inverse DWT (icer_wavelet.c:81-103)."""
    h, w = img.shape[-2], img.shape[-1]
    check_stages(w, h, stages)
    img = img.astype(xp.int32)
    overflow = False
    for it in range(1, stages + 1):
        decomps = stages - it
        low_w = dim_low(w, decomps)
        low_h = dim_low(h, decomps)
        block, ov = inverse_2d(img[..., :low_h, :low_w], filt, mag_bits, xp)
        img = _set_block(img, block, low_h, low_w, xp)
        overflow = ov | overflow
    return img, overflow


# -- sign-magnitude conversion (icer_wavelet.c:851-887) ---------------------

def to_sign_magnitude(img, mag_bits: int, xp=np):
    """Two's complement int -> sign-magnitude (sign in bit ``mag_bits``).

    Matches icer_to_sign_magnitude_int16 including the most-negative-value
    wrap: abs(-2^mag_bits) truncates to magnitude 0 with the sign bit set.
    """
    v = img.astype(xp.int32)
    neg = (v < 0).astype(xp.int32)
    mag = xp.abs(v) & ((1 << mag_bits) - 1)
    return mag | (neg << mag_bits)


def from_sign_magnitude(img, mag_bits: int, xp=np):
    """Sign-magnitude -> two's complement int32."""
    v = img.astype(xp.int32) & ((1 << (mag_bits + 1)) - 1)
    mag = v & ((1 << mag_bits) - 1)
    sign = (v >> mag_bits) & 1
    # Negative: (sign_bit_value - v) == -mag, matching icer_wavelet.c:880-886.
    return xp.where(sign == 1, -mag, mag)
