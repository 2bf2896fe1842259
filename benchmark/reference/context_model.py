"""Vectorized ICER context modelling (encode-side pass 1).

The reference walks each segment x bitplane pixel-by-pixel
(icer_context_modeller.c:312-457) interleaving context computation with
entropy coding.  On TPU we exploit the fact that, at *encode* time, every
pixel's category, context, coded bit and sign event are pure functions of
the original sign-magnitude coefficients: this module computes all of them
for a whole segment plane at once with vectorized integer ops (VPU work
under jit), leaving only the counter/bin/codeword stages downstream.

Semantics notes (all mirroring the reference):
  - neighbours already scanned in raster order (W, N, NW, NE) are tested for
    significance at the *current* plane ``lsb``; not-yet-scanned neighbours
    (E, S, SW, SE) at ``lsb + 1`` (icer_context_modeller.c:355-372);
  - segment borders count as insignificant (bounds checks are against the
    segment rectangle, not the subband);
  - ``get_sign`` returns -1 for a *negative significant* neighbour and 0
    otherwise -- positive neighbours contribute 0, exactly as the C code's
    arithmetic-shift trick does (icer_context_modeller.c:640-642);
  - category-3 (deep refinement) bits bypass the adaptive model and go to
    the uncoded bin with fixed counts (1, 2) (icer_context_modeller.c:350).
"""

from __future__ import annotations

import numpy as np

from . import constants as C
from .bitutils import msb_index

# Context id used for category-3 "uncoded" emissions (real contexts: 0..16).
CTX_UNCODED = 17

_CTX_LL_FLAT = C.CONTEXT_TABLE_LL_LH_HL.reshape(-1).astype(np.int32)
_CTX_HH_FLAT = C.CONTEXT_TABLE_HH.reshape(-1).astype(np.int32)
_SIGN_CTX_FLAT = C.SIGN_CONTEXT_TABLE.reshape(-1).astype(np.int32)
_SIGN_PRED_FLAT = C.SIGN_PREDICTION_TABLE.reshape(-1).astype(np.int32)


# ---- closed forms of the context tables ---------------------------------
# The reference's tables (icer_config.c:26-67) are tiny, but on TPU a LUT
# gather over a whole plane serializes (~10 ns/elem); each table has an
# exact arithmetic form that fuses into the surrounding elementwise pass.
# All four are verified against the tables exhaustively at import (below)
# and in tests/test_core.py.

def _ctx_ll_formula(h, v, d, xp):
    """CONTEXT_TABLE_LL_LH_HL[h][v][d] (h,v in 0..2, d in 0..4)."""
    d2 = xp.minimum(d, 2)
    return xp.where(h == 2, 8,
                    xp.where(h == 1,
                             xp.where(v == 0, 5 + d2, 7),
                             xp.where(v == 0, d2, 2 + v)))


def _ctx_hh_formula(s, d, xp):
    """CONTEXT_TABLE_HH[s][d] with s = h + v in 0..4, d in 0..4."""
    t = xp.minimum(s, 2)
    return xp.where(d == 0, t,
                    xp.where(d == 1, 3 + t,
                             xp.where(d == 2, 6 + xp.minimum(t, 1), 8)))


def _sign_formula(sh, sv, xp):
    """(SIGN_CONTEXT_TABLE, SIGN_PREDICTION_TABLE)[sh][sv], args 0..4."""
    a = sh - 2
    b = sv - 2
    cb = xp.clip(b, -1, 1)
    sctx = xp.where(a == 0, 12 + (b != 0),
                    15 - xp.sign(a) * cb).astype(xp.int32)
    pred = xp.where(a < 0, 1,
                    xp.where(a > 0, 0, (b > 0))).astype(xp.int32)
    return sctx, pred


def _verify_formulas():
    h, v, d = np.meshgrid(np.arange(3), np.arange(3), np.arange(5),
                          indexing="ij")
    assert np.array_equal(_ctx_ll_formula(h, v, d, np),
                          _CTX_LL_FLAT[h * 15 + v * 5 + d])
    s, d = np.meshgrid(np.arange(5), np.arange(5), indexing="ij")
    assert np.array_equal(_ctx_hh_formula(s, d, np), _CTX_HH_FLAT[s * 5 + d])
    sh, sv = np.meshgrid(np.arange(5), np.arange(5), indexing="ij")
    sctx, pred = _sign_formula(sh, sv, np)
    assert np.array_equal(sctx, _SIGN_CTX_FLAT[sh * 5 + sv])
    assert np.array_equal(pred, _SIGN_PRED_FLAT[sh * 5 + sv])


_verify_formulas()


def _shift(a, dr: int, dc: int, fill, xp):
    """Array shifted so out[r, c] = a[r + dr, c + dc], ``fill`` outside."""
    h, w = a.shape[-2], a.shape[-1]
    out = xp.full_like(a, fill)
    out[..., max(0, -dr):h - max(0, dr), max(0, -dc):w - max(0, dc)] = \
        a[..., max(0, dr):h - max(0, -dr), max(0, dc):w - max(0, -dc)]
    return out


def plane_analysis(seg, subband_type: int, lsb: int, mag_bits: int, xp=np):
    """Per-pixel encode-side analysis of one segment bitplane.

    Args:
      seg: (..., h, w) int array of sign-magnitude coefficients.
      subband_type: SUBBAND_* constant (static).
      lsb: bitplane index (static).
      mag_bits: 7 for the 8-bit path, 15 for the 16-bit path (static).
      xp: numpy or jax.numpy.

    Returns dict of (..., h, w) int32 arrays:
      category, bit, ctx (0..16, or 17 for uncoded), sign_event (0/1),
      agreement (sign agreement bit), sign_ctx.
    """
    seg = seg.astype(xp.int32)
    mag_mask = (1 << mag_bits) - 1
    mag = seg & mag_mask
    neg = (seg >> mag_bits) & 1

    msb = msb_index(mag | 1, xp)
    category = xp.clip(msb - lsb, 0, 3)
    bit = (mag >> lsb) & 1

    sig_cur = ((mag >> lsb) != 0).astype(xp.int32)
    sig_prev = ((mag >> (lsb + 1)) != 0).astype(xp.int32)

    # Neighbour significance counts (segment borders -> 0).
    w_sig = _shift(sig_cur, 0, -1, 0, xp)
    e_sig = _shift(sig_prev, 0, 1, 0, xp)
    n_sig = _shift(sig_cur, -1, 0, 0, xp)
    s_sig = _shift(sig_prev, 1, 0, 0, xp)
    nw_sig = _shift(sig_cur, -1, -1, 0, xp)
    ne_sig = _shift(sig_cur, -1, 1, 0, xp)
    sw_sig = _shift(sig_prev, 1, -1, 0, xp)
    se_sig = _shift(sig_prev, 1, 1, 0, xp)

    h_cnt = w_sig + e_sig
    v_cnt = n_sig + s_sig
    d_cnt = nw_sig + ne_sig + sw_sig + se_sig

    if subband_type == C.SUBBAND_HL:
        h_cnt, v_cnt = v_cnt, h_cnt

    if subband_type != C.SUBBAND_HH:
        ctx_cat0 = _ctx_ll_formula(h_cnt, v_cnt, d_cnt, xp)
    else:
        ctx_cat0 = _ctx_hh_formula(h_cnt + v_cnt, d_cnt, xp)
    ctx_cat1 = xp.where(h_cnt + v_cnt == 0, 9, 10)

    ctx = xp.where(
        category == 0, ctx_cat0,
        xp.where(category == 1, ctx_cat1,
                 xp.where(category == 2, 11, CTX_UNCODED)),
    ).astype(xp.int32)

    # Sign coding (fires when a category-0 pixel becomes significant).
    neg_sig = -(neg & sig_cur)          # -1 if negative & significant, else 0
    neg_sig_prev = -(neg & sig_prev)
    sh = _shift(neg_sig, 0, -1, 0, xp) + _shift(neg_sig_prev, 0, 1, 0, xp) + 2
    sv = _shift(neg_sig, -1, 0, 0, xp) + _shift(neg_sig_prev, 1, 0, 0, xp) + 2
    if subband_type == C.SUBBAND_HL:
        sh, sv = sv, sh
    sign_ctx, pred_sign = _sign_formula(sh, sv, xp)
    agreement = (pred_sign ^ neg) & 1
    sign_event = ((category == 0) & (bit == 1)).astype(xp.int32)

    return {
        "category": category,
        "bit": bit,
        "ctx": ctx,
        "sign_event": sign_event,
        "agreement": agreement,
        "sign_ctx": sign_ctx.astype(xp.int32),
    }


def plane_emissions(seg, subband_type: int, lsb: int, mag_bits: int, xp=np):
    """Emission stream for one segment bitplane, in coding order.

    Returns (valid, ctx, bit), each of shape (..., 2*h*w): two interleaved
    slots per pixel in raster order -- slot 0 is the magnitude/refinement
    bit (always valid), slot 1 the sign agreement bit (valid only on a sign
    event).  ``ctx`` is 0..16 for adaptive contexts, CTX_UNCODED for the
    fixed-probability uncoded bin.
    """
    a = plane_analysis(seg, subband_type, lsb, mag_bits, xp)
    lead = a["category"].shape[:-2]
    npix_shape = lead + (a["category"].shape[-2] * a["category"].shape[-1],)

    def flat(x):
        return x.reshape(npix_shape)

    ones = xp.ones(npix_shape, dtype=xp.int32)
    valid = xp.stack([ones, flat(a["sign_event"])], axis=-1)
    ctx = xp.stack([flat(a["ctx"]), flat(a["sign_ctx"])], axis=-1)
    bit = xp.stack([flat(a["bit"]), flat(a["agreement"])], axis=-1)
    out_shape = lead + (2 * npix_shape[-1],)
    return (valid.reshape(out_shape), ctx.reshape(out_shape),
            bit.reshape(out_shape))
