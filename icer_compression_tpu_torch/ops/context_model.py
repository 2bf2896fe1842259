"""Encode-side context modelling on int32 tensors.

Counterpart: ``icer_compression_tpu/ops/context_model.py``
(``plane_emissions_words`` and the closed-form context tables it uses).
At encode time every pixel's category, context, coded bit and sign event
are functions of the original sign-magnitude coefficients, so a whole
segment plane (and a whole batch of segment lanes) is modelled at once.
Semantics: already-scanned neighbours (W, N, NW, NE) are tested at the
current plane, the others at ``lsb + 1``; segment borders are
insignificant; category-3 bits go to the uncoded context 17.

On the card the encoder runs ``context_words`` (``csrc/context_model.cu``):
one launch per stage group writes the group's coder words for every plane
of its window straight into its bucket's rows.  ``plane_emissions_words``
is its plain version (``ops/encode``: ``Encoder.emit`` and
``Encoder.bucket_words`` over it), which the encoder runs on CPU tensors.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from .. import kernels
from ..core import constants as C
from .bitutils import msb_index

CTX_UNCODED = 17


def _ctx_ll(h, v, d):
    """CONTEXT_TABLE_LL_LH_HL[h][v][d] in closed form."""
    d2 = torch.clamp(d, max=2)
    return torch.where(h == 2, 8,
                       torch.where(h == 1,
                                   torch.where(v == 0, 5 + d2, 7),
                                   torch.where(v == 0, d2, 2 + v)))


def _ctx_hh(s, d):
    """CONTEXT_TABLE_HH[s][d] with s = h + v."""
    t = torch.clamp(s, max=2)
    return torch.where(d == 0, t,
                       torch.where(d == 1, 3 + t,
                                   torch.where(d == 2,
                                               6 + torch.clamp(t, max=1), 8)))


def _sign_ctx(sh, sv):
    """(SIGN_CONTEXT_TABLE, SIGN_PREDICTION_TABLE)[sh][sv], args 0..4."""
    a = sh - 2
    b = sv - 2
    cb = torch.clamp(b, -1, 1)
    sctx = torch.where(a == 0, 12 + (b != 0).to(torch.int32),
                       15 - torch.sign(a) * cb)
    pred = torch.where(a < 0, 1,
                       torch.where(a > 0, 0, (b > 0).to(torch.int32)))
    return sctx.to(torch.int32), pred.to(torch.int32)


def _shift(a: torch.Tensor, dr: int, dc: int) -> torch.Tensor:
    """out[..., r, c] = a[..., r + dr, c + dc], zero outside."""
    h, w = a.shape[-2], a.shape[-1]
    ap = F.pad(a, (1, 1, 1, 1))
    return ap[..., 1 + dr:1 + dr + h, 1 + dc:1 + dc + w]


def plane_emissions_words(seg: torch.Tensor, subband_code: torch.Tensor,
                          pix_valid: torch.Tensor, lsb: int, mag_bits: int):
    """Packed emission words of one bitplane for N segment lanes.

    seg/pix_valid: (N, h, w); subband_code: (N,).  Returns (w0, w1), each
    (N, h*w) int32 in the coder's packed layout valid | ctx << 1 | bit << 6:
    w0 the magnitude/refinement slot of each pixel in raster order, w1 the
    sign slot (valid only on sign events)."""
    seg = seg.to(torch.int32)
    sb = subband_code.to(torch.int32).reshape(-1, 1, 1)
    mag = seg & ((1 << mag_bits) - 1)
    neg = (seg >> mag_bits) & 1
    category = torch.clamp(msb_index(mag | 1) - lsb, 0, 3)
    bit = (mag >> lsb) & 1
    sig_cur = ((mag >> lsb) != 0).to(torch.int32)
    sig_prev = ((mag >> (lsb + 1)) != 0).to(torch.int32)

    h_raw = _shift(sig_cur, 0, -1) + _shift(sig_prev, 0, 1)
    v_raw = _shift(sig_cur, -1, 0) + _shift(sig_prev, 1, 0)
    d_cnt = (_shift(sig_cur, -1, -1) + _shift(sig_cur, -1, 1)
             + _shift(sig_prev, 1, -1) + _shift(sig_prev, 1, 1))
    is_hl = sb == C.SUBBAND_HL
    h_cnt = torch.where(is_hl, v_raw, h_raw)
    v_cnt = torch.where(is_hl, h_raw, v_raw)
    ctx0 = torch.where(sb == C.SUBBAND_HH, _ctx_hh(h_cnt + v_cnt, d_cnt),
                       _ctx_ll(h_cnt, v_cnt, d_cnt))
    ctx1 = torch.where(h_cnt + v_cnt == 0, 9, 10)
    ctx = torch.where(category == 0, ctx0,
                      torch.where(category == 1, ctx1,
                                  torch.where(category == 2, 11,
                                              CTX_UNCODED))).to(torch.int32)

    neg_sig = -(neg & sig_cur)
    neg_sig_prev = -(neg & sig_prev)
    sh_raw = _shift(neg_sig, 0, -1) + _shift(neg_sig_prev, 0, 1) + 2
    sv_raw = _shift(neg_sig, -1, 0) + _shift(neg_sig_prev, 1, 0) + 2
    sign_ctx, pred = _sign_ctx(torch.where(is_hl, sv_raw, sh_raw),
                               torch.where(is_hl, sh_raw, sv_raw))
    agreement = (pred ^ neg) & 1
    sign_event = ((category == 0) & (bit == 1)).to(torch.int32)

    n = seg.shape[0]
    pv = pix_valid.to(torch.int32).reshape(n, -1)
    w0 = pv | (ctx.reshape(n, -1) << 1) | (bit.reshape(n, -1) << 6)
    w1 = ((sign_event.reshape(n, -1) * pv) | (sign_ctx.reshape(n, -1) << 1)
          | (agreement.reshape(n, -1) << 6))
    return w0, w1


def lane_table(lanes) -> np.ndarray:
    """(N, 5) int32 rows (row, col, h, w, subband) of a group's lanes
    (``ops/encode.Lane``), the geometry ``context_words`` reads; a dummy
    lane gets h = w = 0, so all its pixels are invalid."""
    return np.array([(l.row, l.col, 0 if l.dummy else l.h,
                      0 if l.dummy else l.w, l.subband) for l in lanes],
                    np.int32).reshape(-1, 5)


def context_words(img: torch.Tensor, lanes: torch.Tensor, mh: int, mw: int,
                  lo: int, hi: int, mag_bits: int,
                  out: torch.Tensor) -> torch.Tensor:
    """One launch of ``csrc/context_model.cu``: a stage group's coder words
    for the planes lo .. hi - 1 from the (B, H, W) int32 sign-magnitude
    coefficients ``img``, written into ``out``, the group's contiguous
    (B * (hi - lo) * N, Lk) int32 rows of its bucket in the order (image,
    plane, lane) (``lanes``: ``lane_table`` on the device; every lane a
    canvas of mh x mw).  Each row is [w0[0], w1[0], w0[1], w1[1], ...]
    padded with zeros, as ``Encoder.bucket_words`` over
    ``plane_emissions_words``.  Queued on the current stream, no host sync
    and no allocation, so a captured pass replays it.  Returns ``out``."""
    B, H, W = img.shape
    N = lanes.shape[0]
    rows, Lk = out.shape
    if (img.dtype != torch.int32 or out.dtype != torch.int32
            or lanes.dtype != torch.int32 or lanes.shape != (N, 5)
            or not out.is_contiguous() or rows != B * (hi - lo) * N
            or Lk % 2 or Lk < 2 * mh * mw
            or not img.device == lanes.device == out.device):
        raise ValueError(
            f"context_words: out {out.dtype} {tuple(out.shape)} on "
            f"{out.device} does not hold {B} images x {hi - lo} planes x "
            f"{N} lanes of {mh}x{mw} pixels (int32 img {img.dtype} on "
            f"{img.device}, lanes {tuple(lanes.shape)} on {lanes.device})")
    img = img.contiguous()
    lanes = lanes.contiguous()
    dev = img.device
    fn = kernels.load("context_model").context_words_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p] + [ctypes.c_int] * 6 + [ctypes.c_longlong] \
        + [ctypes.c_void_p] * 3
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = fn(img.data_ptr(), B, H, W, lanes.data_ptr(), N, mh, mw, lo,
                    hi, mag_bits, Lk, out.data_ptr(),
                    kernels.run_slot(dev, "context_model"), stream)
    kernels.check(status, "context_model")
    context_words.launches += 1
    return out


context_words.launches = 0
