"""Integer lifting DWT (filters A-F, Q) on int32 tensors.

Counterpart: ``icer_compression_tpu/ops/wavelet.py`` (``forward_stages``,
``inverse_stages``, ``to_sign_magnitude``, ``from_sign_magnitude``,
``_wrap``, ``_interleave_perm``).  Every row (then every column) of a stage
transforms as one batched tensor op along the last axis; leading axes are
batch axes.  On the card the inverse DWT is kernel W1 (``inverse_pass``,
``csrc/wavelet.cu``): one launch restores one axis of one stage's block
for every canvas of a batch, at every filter, so a stage takes two
launches.  Its plain version is the chain ``inverse_2d`` -> ``inverse_1d``
-> ``inverse_recurrence_plain``, which CPU tensors run (the backward
recurrence of the filters with a non-zero beta, or filter C's
self-referential term, is a Python loop over the high-pass index there,
vectorised over the lines).

The overflow flag stays on the input's device, so a caller can test it
once per image instead of syncing per stage.  The reference quirks are
kept bit for bit: filter C's prediction of high[1] from the stored
high[1], and the skewed uint8 odd-length interleave.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import kernels
from ..core import constants as C
from ..core.status import IcerError, IcerStatus
from ..core.subbands import dim_low
from .bitutils import floor_div


def _limits(mag_bits: int):
    return -(1 << mag_bits), (1 << mag_bits) - 1


def _wrap(v: torch.Tensor, mag_bits: int) -> torch.Tensor:
    """Wrap int32 values to int8/int16 two's complement (C cast)."""
    bits = mag_bits + 1
    w = v & ((1 << bits) - 1)
    return w - ((w >> (bits - 1)) << bits)


def _out_of_range(v: torch.Tensor, mag_bits: int) -> torch.Tensor:
    lo, hi = _limits(mag_bits)
    return ((v > hi) | (v < lo)).any()


def _col(x: torch.Tensor, n: int) -> torch.Tensor:
    return x[..., n:n + 1]


def _zeros1(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros(x.shape[:-1] + (1,), dtype=torch.int32, device=x.device)


def _ones1(x: torch.Tensor) -> torch.Tensor:
    return torch.ones(x.shape[:-1] + (1,), dtype=torch.int32, device=x.device)


def _diffs(lows: torch.Tensor) -> torch.Tensor:
    """r[0] = 1, r[n] = L[n-1] - L[n]."""
    return torch.cat([_ones1(lows), lows[..., :-1] - lows[..., 1:]], dim=-1)


def _r_shifts(r: torch.Tensor, half: int):
    """(r[n-1], r[n], r[n+1]) for n in [0, half), out of range -> 0."""
    nL = r.shape[-1]
    r_m1 = torch.cat([_zeros1(r), r[..., :half - 1]], dim=-1)
    r_0 = r[..., :half]
    if nL >= half + 1:
        r_p1 = r[..., 1:half + 1]
    else:
        pad = torch.zeros(r.shape[:-1] + (half + 1 - nL,), dtype=torch.int32,
                          device=r.device)
        r_p1 = torch.cat([r[..., 1:nL], pad], dim=-1)
    return r_m1, r_0, r_p1


def forward_1d(x: torch.Tensor, filt: int, mag_bits: int):
    """Forward lifting along the last axis -> ([lows | highs], overflow)."""
    N = x.shape[-1]
    x = x.to(torch.int32)
    is_odd = bool(N & 1)
    half = N // 2
    d1 = x[..., 0:2 * half:2]
    d2 = x[..., 1:2 * half:2]
    low = floor_div(d1 + d2, 2)
    high = d1 - d2
    overflow = _out_of_range(low, mag_bits) | _out_of_range(high, mag_bits)
    low = _wrap(low, mag_bits)
    high = _wrap(high, mag_bits)
    lows = torch.cat([low, x[..., N - 1:N]], dim=-1) if is_odd else low

    a_n1, a_0, a_1, beta = (int(v) for v in C.WAVELET_FILTER_PARAMETERS[filt])
    r = _diffs(lows)
    d_next = torch.cat([high[..., 1:], _zeros1(high)], dim=-1)
    r_m1, r_0, r_p1 = _r_shifts(r, half)
    sub = floor_div(a_n1 * r_m1 + a_0 * r_0 + a_1 * r_p1 - beta * d_next + 8,
                    C.FILTER_DENOMINATOR).clone()
    sub[..., 0:1] = floor_div(_col(r, 1), 4)
    if a_n1 != 0 and half > 1:
        # filter C: the reference predicts high[1] from the stored high[1]
        # itself (0 when N == 5), see the JAX counterpart's note
        d2v = _zeros1(high) if (is_odd and half == 2) else _col(high, 1)
        sub[..., 1:2] = floor_div(
            2 * _col(r, 1) + 3 * _col(r, 2) - 2 * d2v + 4, 8)
    if not is_odd:
        sub[..., half - 1:half] = floor_div(_col(r, half - 1), 4)
    h_out = high - sub
    overflow = overflow | _out_of_range(h_out, mag_bits)
    return torch.cat([lows, _wrap(h_out, mag_bits)], dim=-1), overflow


def inverse_1d(x: torch.Tensor, filt: int, mag_bits: int):
    """Inverse of forward_1d along the last axis -> (out, overflow)."""
    N = x.shape[-1]
    x = x.to(torch.int32)
    is_odd = bool(N & 1)
    half = N // 2
    nL = half + 1 if is_odd else half
    lows = x[..., :nL]
    highs = x[..., nL:]
    a_n1, a_0, a_1, beta = (int(v) for v in C.WAVELET_FILTER_PARAMETERS[filt])
    r = _diffs(lows)

    if beta == 0 and a_n1 == 0:
        # prediction independent of the highs: fully parallel
        r_m1, r_0, r_p1 = _r_shifts(r, half)
        add = floor_div(a_n1 * r_m1 + a_0 * r_0 + a_1 * r_p1 + 8,
                        C.FILTER_DENOMINATOR).clone()
        # r reads as 0 past its end (a line of 2 samples has no r[1])
        add[..., 0:1] = floor_div(_col(r, 1) if nL > 1 else _zeros1(r), 4)
        if not is_odd:
            add[..., half - 1:half] = floor_div(_col(r, half - 1), 4)
        d_rec = highs + add
        overflow = _out_of_range(d_rec, mag_bits)
        d_rec = _wrap(d_rec, mag_bits)
    else:
        d_rec, overflow = inverse_recurrence_plain(highs, r, filt,
                                                   mag_bits)

    tmp = lows[..., :half] + floor_div(d_rec + 1, 2)
    even = tmp
    odd = tmp - d_rec
    overflow = (overflow | _out_of_range(even, mag_bits)
                | _out_of_range(odd, mag_bits))
    even = _wrap(even, mag_bits)
    odd = _wrap(odd, mag_bits)
    if is_odd:
        tail = _wrap(lows[..., half:half + 1], mag_bits)
        y = torch.cat([even, tail, odd], dim=-1)
    else:
        y = torch.cat([even, odd], dim=-1)
    return y[..., _interleave_perm_t(N, mag_bits, str(x.device))], overflow


def inverse_recurrence_plain(highs: torch.Tensor, r: torch.Tensor,
                             filt: int, mag_bits: int):
    """The backward prediction recurrence of ``inverse_1d`` (part of W1's
    plain version) for the filters whose prediction reads the restored
    d[n+1] (beta != 0) or, filter C, the stored high[1].

    ``highs`` (..., half) and ``r`` (..., nL) int32, nL = half + 1 for a
    line of odd length and half for an even one, r[0] = 1 and r[n] =
    L[n-1] - L[n]; r reads as 0 past nL (as the JAX
    package's ``lax.scan`` pads it, so lines of 2 to 4 samples are
    defined).  From n = half-1 down to 0, d[n] = wrap(high[n] + add[n]):
    add[0] = floor(r[1] / 4); filter C's add[1] = floor((2 r[1] + 3 r[2]
    - 2 high[1] + 4) / 8), with high[1] read as 0 when N = 5 (the
    reference predicts from the stored value); an even line's
    add[half-1] = floor(r[half-1] / 4); otherwise floor((a_n1 r[n-1] +
    a_0 r[n] + a_1 r[n+1] - beta d[n+1] + 8) / 16).  Returns (d (...,
    half) int32, overflow: a 0-d bool tensor, set where an unwrapped
    value leaves the sample range).  A loop over n of about 55 small ops
    a step, vectorised over the lines."""
    a_n1, a_0, a_1, beta = (int(v) for v in C.WAVELET_FILTER_PARAMETERS[filt])
    half = highs.shape[-1]
    is_odd = r.shape[-1] > half
    rp = torch.cat([r, _zeros1(r), _zeros1(r)], dim=-1)
    overflow = torch.zeros((), dtype=torch.bool, device=highs.device)
    cols: list = [None] * half
    dn1 = _zeros1(highs)
    for n in range(half - 1, -1, -1):
        if n == 0:
            add = floor_div(_col(rp, 1), 4)
        elif n == 1 and a_n1 != 0:
            d2v = (_zeros1(highs) if (is_odd and half == 2)
                   else _col(highs, 1))
            add = floor_div(2 * _col(rp, 1) + 3 * _col(rp, 2)
                            - 2 * d2v + 4, 8)
        elif (not is_odd) and n == half - 1:
            add = floor_div(_col(rp, half - 1), 4)
        else:
            add = floor_div(a_n1 * _col(rp, n - 1) + a_0 * _col(rp, n)
                            + a_1 * _col(rp, n + 1) - beta * dn1 + 8,
                            C.FILTER_DENOMINATOR)
        v = _col(highs, n) + add
        overflow = overflow | _out_of_range(v, mag_bits)
        dn1 = _wrap(v, mag_bits)
        cols[n] = dn1
    return torch.cat(cols, dim=-1), overflow


@functools.lru_cache(maxsize=None)
def _interleave_perm_t(N: int, mag_bits: int, device: str) -> torch.Tensor:
    """``_interleave_perm`` on ``device``, uploaded once: a per-call upload
    from host memory would make every decode wait for the copy."""
    return torch.as_tensor(_interleave_perm(N, mag_bits), device=device)


def _interleave_perm(N: int, mag_bits: int) -> np.ndarray:
    """out = y[perm] with y = [evens | tail | odds]; the uint8 odd-length
    order reproduces the reference's skewed in-place interleave
    (icer_wavelet.c:599)."""
    m = N // 2
    nL = m + (N & 1)
    if not (N & 1) or mag_bits == 15:
        perm = np.empty(N, dtype=np.int64)
        perm[0:2 * m:2] = np.arange(m)
        perm[1:2 * m:2] = nL + np.arange(m)
        if N & 1:
            perm[N - 1] = m
        return perm
    seq: list[int] = []
    for j in range(m - 1):
        seq.append(j)
        seq.append(m + 2 + j)
    seq.extend([m - 1, m, m + 1])
    return np.asarray(seq, dtype=np.int64)


def forward_2d(img: torch.Tensor, filt: int, mag_bits: int):
    """Rows then columns (icer_wavelet.c:155-171)."""
    rowed, ov1 = forward_1d(img, filt, mag_bits)
    coled_t, ov2 = forward_1d(rowed.transpose(-1, -2), filt, mag_bits)
    return coled_t.transpose(-1, -2), ov1 | ov2


def inverse_2d(img: torch.Tensor, filt: int, mag_bits: int):
    """Columns then rows (icer_wavelet.c:175-191)."""
    rowed_t, ov1 = inverse_1d(img.transpose(-1, -2), filt, mag_bits)
    out, ov2 = inverse_1d(rowed_t.transpose(-1, -2), filt, mag_bits)
    return out, ov1 | ov2


def inverse_pass_plain(src: torch.Tensor, low_h: int, low_w: int,
                       axis: int, filt: int, mag_bits: int,
                       out: torch.Tensor, overflow: torch.Tensor) -> None:
    """W1's plain version: ``inverse_1d`` over the lines of block
    [:low_h, :low_w] of every canvas of ``src`` along ``axis`` (0: the
    block's columns, 1: its rows), written into the same block of ``out``;
    the pass's overflow ORed into ``overflow`` (one int32)."""
    block = src[:, :low_h, :low_w]
    if axis == 0:
        y, ov = inverse_1d(block.transpose(-1, -2), filt, mag_bits)
        y = y.transpose(-1, -2)
    else:
        y, ov = inverse_1d(block, filt, mag_bits)
    out[:, :low_h, :low_w] = y
    overflow |= ov.to(torch.int32)


def _check_pass(src, low_h, low_w, axis, out, overflow):
    if src.dtype != torch.int32 or out.dtype != torch.int32 \
            or overflow.dtype != torch.int32:
        raise ValueError(f"W1 takes int32, not {src.dtype} / {out.dtype} / "
                         f"{overflow.dtype}")
    if src.dim() != 3 or out.shape != src.shape \
            or tuple(overflow.shape) != (1,):
        raise ValueError(f"W1: canvases {tuple(src.shape)} -> "
                         f"{tuple(out.shape)} and overflow "
                         f"{tuple(overflow.shape)}; expected (NC, H, W) "
                         "twice and (1,)")
    _nc, H, W = src.shape
    if not (2 <= low_h <= H and 2 <= low_w <= W) or axis not in (0, 1):
        raise ValueError(f"W1: block {low_h}x{low_w} on axis {axis} of "
                         f"{H}x{W} canvases")
    if not (src.is_contiguous() and out.is_contiguous()):
        raise ValueError("W1 takes contiguous canvases")
    if out.device != src.device or overflow.device != src.device:
        raise ValueError(f"W1: canvases on {src.device} and {out.device}, "
                         f"overflow on {overflow.device}")
    if out.numel() and out.data_ptr() == src.data_ptr():
        raise ValueError("W1 writes another buffer than it reads")


def inverse_pass(src: torch.Tensor, low_h: int, low_w: int, axis: int,
                 filt: int, mag_bits: int, out: torch.Tensor | None = None,
                 overflow: torch.Tensor | None = None):
    """Kernel W1: one pass of the inverse DWT (contract in
    ``inverse_pass_plain``) over block [:low_h, :low_w] of each of the
    (NC, H, W) int32 canvases ``src``, into ``out`` (a copy of ``src``
    when None; outside the block ``out`` keeps what it held), with
    ``overflow`` (one int32, zeros when None) ORed.  Returns (out,
    overflow).

    CUDA tensors launch ``csrc/wavelet.cu``, reading the block where it
    lies and writing the interleaved lines; CPU tensors run the plain
    version.  Nothing waits for the card."""
    if src.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {src.device}")
    if out is None:
        out = src.clone()
    if overflow is None:
        overflow = src.new_zeros(1, dtype=torch.int32)
    _check_pass(src, low_h, low_w, axis, out, overflow)
    if src.device.type == "cpu":
        inverse_pass_plain(src, low_h, low_w, axis, filt, mag_bits, out,
                           overflow)
        return out, overflow
    fn = kernels.load("wavelet").wavelet_inverse_pass_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 11 \
        + [ctypes.c_void_p] * 2
    a_n1, a_0, a_1, beta = (int(v) for v in C.WAVELET_FILTER_PARAMETERS[filt])
    nc, H, W = src.shape
    runs = kernels.run_slot(src.device, "wavelet_inverse")
    with torch.cuda.device(src.device):
        cs = torch.cuda.current_stream(src.device).cuda_stream
        status = fn(src.data_ptr(), out.data_ptr(), overflow.data_ptr(), nc,
                    H, W, low_h, low_w, axis, a_n1, a_0, a_1, beta, mag_bits,
                    runs, cs)
    kernels.check(status, "wavelet_inverse_pass")
    inverse_pass.launches += 1
    return out, overflow


inverse_pass.launches = 0


def check_stages(image_w: int, image_h: int, stages: int) -> None:
    if dim_low(image_w, stages) < 3 or dim_low(image_h, stages) < 3:
        raise IcerError(IcerStatus.TOO_MANY_STAGES,
                        f"{image_w}x{image_h} with {stages} stages")


def forward_stages(img: torch.Tensor, stages: int, filt: int, mag_bits: int):
    """N-stage forward DWT, subbands kept in place -> (img, overflow).

    Works on a copy of ``img``: each stage overwrites its low block in
    place in that copy."""
    h, w = img.shape[-2], img.shape[-1]
    check_stages(w, h, stages)
    img = img.to(torch.int32).clone()
    overflow = torch.zeros((), dtype=torch.bool, device=img.device)
    low_w, low_h = w, h
    for _ in range(stages):
        block, ov = forward_2d(img[..., :low_h, :low_w], filt, mag_bits)
        img[..., :low_h, :low_w] = block
        overflow = overflow | ov
        low_w = low_w // 2 + low_w % 2
        low_h = low_h // 2 + low_h % 2
    return img, overflow


def inverse_stages_plain(img: torch.Tensor, stages: int, filt: int,
                         mag_bits: int):
    """W1's plain version of ``inverse_stages``: each stage's block through
    ``inverse_2d``, on any device."""
    h, w = img.shape[-2], img.shape[-1]
    check_stages(w, h, stages)
    img = img.to(torch.int32).clone()
    overflow = torch.zeros((), dtype=torch.bool, device=img.device)
    for it in range(1, stages + 1):
        decomps = stages - it
        low_w = dim_low(w, decomps)
        low_h = dim_low(h, decomps)
        block, ov = inverse_2d(img[..., :low_h, :low_w], filt, mag_bits)
        img[..., :low_h, :low_w] = block
        overflow = overflow | ov
    return img, overflow


def inverse_stages(img: torch.Tensor, stages: int, filt: int, mag_bits: int):
    """N-stage inverse DWT (icer_wavelet.c:81-103) -> (img, overflow: a
    0-d bool tensor on img's device): CPU tensors run the plain version
    (``inverse_stages_plain``), any other kernel W1 (``stage_passes``)."""
    if img.device.type == "cpu":
        return inverse_stages_plain(img, stages, filt, mag_bits)
    return stage_passes(img, stages, filt, mag_bits)


def stage_passes(img: torch.Tensor, stages: int, filt: int, mag_bits: int):
    """``inverse_stages`` as two ``inverse_pass`` calls a stage (columns
    into a scratch canvas, then rows back into the block, as
    icer_wavelet.c:175-191 orders them) on one contiguous copy of
    ``img``, with one overflow word for the whole inverse."""
    h, w = img.shape[-2], img.shape[-1]
    check_stages(w, h, stages)
    out = img.to(torch.int32).clone(memory_format=torch.contiguous_format)
    canvas = out.view(-1, h, w)
    scratch = torch.empty_like(canvas)
    overflow = out.new_zeros(1)
    for it in range(1, stages + 1):
        low_w = dim_low(w, stages - it)
        low_h = dim_low(h, stages - it)
        inverse_pass(canvas, low_h, low_w, 0, filt, mag_bits, scratch,
                     overflow)
        inverse_pass(scratch, low_h, low_w, 1, filt, mag_bits, canvas,
                     overflow)
    return out, overflow[0] != 0


def to_sign_magnitude(img: torch.Tensor, mag_bits: int) -> torch.Tensor:
    """Two's complement -> sign-magnitude (sign in bit ``mag_bits``);
    abs(-2^mag_bits) truncates to magnitude 0 with the sign set."""
    v = img.to(torch.int32)
    neg = (v < 0).to(torch.int32)
    return (v.abs() & ((1 << mag_bits) - 1)) | (neg << mag_bits)


def from_sign_magnitude(img: torch.Tensor, mag_bits: int) -> torch.Tensor:
    """Sign-magnitude -> two's complement int32."""
    v = img.to(torch.int32) & ((1 << (mag_bits + 1)) - 1)
    mag = v & ((1 << mag_bits) - 1)
    sign = (v >> mag_bits) & 1
    return torch.where(sign == 1, -mag, mag)
