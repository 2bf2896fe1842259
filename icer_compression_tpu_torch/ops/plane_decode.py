"""Lane-batched bitplane decoders: kernels 2 and 3 (``csrc/plane_decode.cu``).

Counterparts: ``icer_compression_tpu/ops/pallas_decode.py``
(``make_decode_plane_pallas(nrounds=R)`` for kernel 2, the same factory
with ``nrounds=None`` for kernel 3), and
``icer_compression_tpu/ops/decode_lanes.py`` (``decode_plane_lanes``,
``LaneDecoders``, ``_build_custom_refill_lut``), whose PyTorch translation
is the kernels' plain version ``decode_planes_plain``.

One call decodes all R bitplane rounds, MSB to LSB, of n segment lanes
that share a padded (hmax, wmax) canvas.  Contract (int32 unless noted):
  stream   (S,) uint8   every image's stream, concatenated
  offs     (R, n)       byte offset of the lane's plane payload in
                        ``stream``, -1 where the plane is absent
  ebits    (R, n)       the plane's frozen data_length (out-of-data guards
                        compare against it, as the reference does)
  lane_end (n,)         end of the lane's own image stream: bits from the
                        payload up to it are read for real (the reference's
                        zero-copy over-read into the following packets),
                        bits past it read as zero
  geom     (3, n)       rows: segment h, w, subband
  -> out   (hmax * wmax, n) sign-magnitude coefficients, pixel (r, c) at
                        row r * wmax + c, zero outside the segment
     err   (n,)         1 where the lane retired: at its first missing
                        plane or stream error (sticky across rounds)
     pos   (R, n)       bit position reached in each round (0 if retired)
Round r decodes bitplane ``lsb0 - r``.  Each round starts fresh counters
and bin stacks (one decoder per plane, as in the reference).

Kernel 3 (``decode_plane_seeded``) decodes one round, bitplane ``lsb``,
on a seed canvas ``seg`` (hmax * wmax, n) instead of zeros: offs, ebits
and pos are (n,); a lane with offs -1 keeps its seed and sets err.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..core import constants as C
from .. import kernels
from .bitutils import msb_index

# LUT layout shared with csrc/plane_decode.cu (int32 offsets)
LUT_CUT = 0          # 16 bin cutoffs
LUT_GM = 16          # 17 golomb m per bin (1 below bin 8)
LUT_GL = 33          # 17 golomb l per bin (1 below bin 8)
LUT_GI = 50          # 17 golomb i per bin (0 below bin 8)
LUT_CHIT = 67        # 8 x 32 custom refill: matched codeword length
LUT_CVAL = 323       # 8 x 32 custom refill: bit-reversed input pattern
LUT_CBITS = 579      # 8 x 32 custom refill: input pattern length
LUT_LL = 835         # 3 x 3 x 5 CONTEXT_TABLE_LL_LH_HL
LUT_HH = 880         # 5 x 5 CONTEXT_TABLE_HH
LUT_SCTX = 905       # 5 x 5 SIGN_CONTEXT_TABLE
LUT_SPRED = 930      # 5 x 5 SIGN_PREDICTION_TABLE
LUT_SIZE = 955

MAX_ROUNDS = 16      # kernel 2 runs one warp per round
MAX_STREAM_BYTES = 1 << 28   # bit positions into the stream are 32-bit
_PLACEMENTS = {1: "shared", 2: "device"}


def _build_custom_refill_lut():
    """(bin 1..7, 5-bit lookahead) -> (hit_len, in_val_reversed, in_bits).

    Valid codewords are at most 5 bits, so the first matching prefix is a
    function of the 5-bit lookahead; hit_len == 0 means no valid prefix
    (the reference would fail its invalid-data guards)."""
    hit_len = np.zeros((8, 32), np.int32)
    in_val = np.zeros((8, 32), np.int32)
    in_bits = np.zeros((8, 32), np.int32)
    for b, entries in C.CUSTOM_CODES.items():
        by_code = {(ov, ob): (iv, ib) for (iv, ib, ov, ob) in entries}
        for look in range(32):
            for nb in range(1, 6):
                hit = by_code.get((look & ((1 << nb) - 1), nb))
                if hit is not None:
                    iv, ib = hit
                    hit_len[b, look] = nb
                    in_val[b, look] = int(C.reverse_bits(iv, ib))
                    in_bits[b, look] = ib
                    break
    return hit_len, in_val, in_bits


def _build_luts() -> np.ndarray:
    cut = np.asarray(C.BIN_PROBABILITY_CUTOFFS[:16], np.int64)
    assert (np.diff(cut) >= 0).all()   # the kernels count cutoffs met
    lut = np.zeros(LUT_SIZE, np.int64)
    lut[LUT_CUT:LUT_CUT + 16] = cut
    gm = np.ones(17, np.int64)
    gl = np.ones(17, np.int64)
    gi = np.zeros(17, np.int64)
    gm[8:], gl[8:], gi[8:] = C.GOLOMB_M[8:17], C.GOLOMB_L[8:17], \
        C.GOLOMB_I[8:17]
    lut[LUT_GM:LUT_GM + 17] = gm
    lut[LUT_GL:LUT_GL + 17] = gl
    lut[LUT_GI:LUT_GI + 17] = gi
    hit, val, bits = _build_custom_refill_lut()
    lut[LUT_CHIT:LUT_CHIT + 256] = hit.reshape(-1)
    lut[LUT_CVAL:LUT_CVAL + 256] = val.reshape(-1)
    lut[LUT_CBITS:LUT_CBITS + 256] = bits.reshape(-1)
    lut[LUT_LL:LUT_LL + 45] = np.asarray(C.CONTEXT_TABLE_LL_LH_HL).reshape(-1)
    lut[LUT_HH:LUT_HH + 25] = np.asarray(C.CONTEXT_TABLE_HH).reshape(-1)
    lut[LUT_SCTX:LUT_SCTX + 25] = np.asarray(C.SIGN_CONTEXT_TABLE).reshape(-1)
    lut[LUT_SPRED:LUT_SPRED + 25] = np.asarray(
        C.SIGN_PREDICTION_TABLE).reshape(-1)
    return lut.astype(np.int32)


_LUT_NP = _build_luts()


@functools.lru_cache(maxsize=None)
def decode_luts(device: str) -> torch.Tensor:
    return torch.as_tensor(_LUT_NP, device=device)


@functools.lru_cache(maxsize=None)
def _rev11(device: str) -> torch.Tensor:
    """v -> v with its low 11 bits reversed (plain version's golomb
    remainder parse)."""
    v = np.arange(2048)
    rev = sum(((v >> i) & 1) << (10 - i) for i in range(11))
    return torch.as_tensor(rev, dtype=torch.int64, device=device)


class _Lanes:
    """Per-lane interleaved-decoder state of one plane round (the
    counterpart of decode_lanes.LaneDecoders).  Bin stacks are held as
    (depth, low 5 bits): golomb stacks are zeros above a possible one at
    the bottom, custom ones at most 5 bits."""

    def __init__(self, stream, base, readable, ebits, lut):
        n = base.shape[0]
        dev = base.device
        z = functools.partial(torch.zeros, dtype=torch.int64, device=dev)
        self.stream, self.base, self.readable = stream, base, readable
        self.ebits, self.lut = ebits, lut
        self.pos = z(n)
        self.dw = z(n)
        self.bin_n = z((17, n))
        self.bin_low = z((17, n))
        self.bin_index = z((17, n))
        self.zero = torch.full((17, n), C.DEFAULT_CONTEXT_ZERO_COUNT,
                               dtype=torch.int64, device=dev)
        self.total = torch.full((17, n), C.DEFAULT_CONTEXT_TOTAL_COUNT,
                                dtype=torch.int64, device=dev)
        self.err = torch.zeros(n, dtype=torch.bool, device=dev)
        self.ar = torch.arange(n, device=dev)

    def look(self):
        """At least 17 stream bits from each lane's position, LSB-first;
        bytes past the lane's readable extent read as zero."""
        byte = self.pos >> 3
        win = torch.zeros_like(byte)
        last = self.stream.numel() - 1
        for j in range(3):
            bi = byte + j
            v = self.stream[torch.clamp(self.base + bi, 0, last)]
            win = win | (torch.where(bi < self.readable, v, 0) << (8 * j))
        return win >> (self.pos & 7)

    def decode_bit(self, zc, tc, m):
        """One context-modelled bit per lane in mask ``m`` with counts
        (zc, tc); stream errors set the sticky err flag."""
        lut = self.lut
        ar = self.ar
        m = m & ~self.err
        inv = zc < (tc >> 1)
        zeff = torch.where(inv, tc - zc, zc)
        cut = lut[LUT_CUT:LUT_CUT + 16]
        bn = ((zeff << 16)[None, :] >= tc[None, :] * cut[:, None]).sum(0)
        bin_n = self.bin_n[bn, ar]
        bin_low = self.bin_low[bn, ar]
        bin_idx = self.bin_index[bn, ar]
        need = m & ((bin_n <= 0)
                    | (self.dw - bin_idx >= C.CIRC_BUF_SIZE))
        if bool(need.any()):
            bin_n, bin_low = self._refill(bn, need, bin_n, bin_low, bin_idx)

        # consume the top of the bin's stack
        m2 = m & ~self.err
        n1 = bin_n - 1
        sh = torch.clamp(n1, min=0)
        small = n1 < 5
        bitv = torch.where(small, (bin_low >> sh) & 1, 0)
        self.bin_n[bn, ar] = torch.where(m2, n1, bin_n)
        self.bin_low[bn, ar] = torch.where(
            m2, bin_low & ~torch.where(small, 1 << sh, 0), bin_low)
        return torch.where(m2, bitv ^ inv.to(torch.int64), 0)

    def _refill(self, bn, need, bin_n, bin_low, bin_idx):
        """Refill the selected bin's stack from the stream where ``need``
        (golomb, custom-code or uncoded codeword), with the reference's
        out-of-data guards against the frozen data_length."""
        lut = self.lut
        look = self.look()
        eb = self.ebits

        # golomb: a leading 1 is a full run of m zeros; otherwise the
        # bit-reversed l (or l + 1) bit remainder
        gm, gl, gi = (lut[LUT_GM + bn], lut[LUT_GL + bn], lut[LUT_GI + bn])
        first = (look & 1) != 0
        rev = _rev11(str(look.device))[look & 2047]
        kl = rev >> (11 - gl)
        klong = rev >> (10 - gl)
        long_needed = ~first & (kl >= gi)
        g = need & (bn >= 8)
        gerr = g & ((~first & (gl > eb))
                    | (long_needed & (gl + 1 > eb)))
        g_adv = torch.where(first, 1, torch.where(long_needed, gl + 1, gl))
        g_ones = torch.where(first, 0, 1)
        g_n = torch.where(first, gm,
                          torch.where(long_needed, klong - gi, kl)) + g_ones

        # custom codes: the first prefix of the 5-bit lookahead that is a
        # codeword (hit length 0: none, an invalid-data error)
        cu = need & (bn >= 1) & (bn <= 7)
        key = torch.clamp(bn, max=7) * 32 + (look & 31)
        hit = lut[LUT_CHIT + key]
        cerr = cu & ((hit == 0) | (hit >= eb))

        # uncoded bin: one raw bit
        uerr = need & (bn == 0) & (eb < 1)

        self.err = self.err | gerr | cerr | uerr
        ok = need & ~self.err
        adv = torch.where(g, g_adv, torch.where(cu, hit, 1))
        new_n = torch.where(g, g_n, torch.where(cu, lut[LUT_CBITS + key], 1))
        new_low = torch.where(g, g_ones,
                              torch.where(cu, lut[LUT_CVAL + key], look & 1))
        self.pos = torch.where(ok, self.pos + adv, self.pos)
        self.dw = torch.where(ok, self.dw + 1, self.dw)
        self.bin_index[bn, self.ar] = torch.where(ok, self.dw, bin_idx)
        return (torch.where(ok, new_n, bin_n),
                torch.where(ok, new_low, bin_low))

    def update(self, ctx, bit, m):
        ar = self.ar
        tc = self.total[ctx, ar] + 1
        zc = self.zero[ctx, ar] + (bit == 0).to(torch.int64)
        resc = tc >= C.CONTEXT_RESCALING_CAP
        tc = torch.where(resc, tc >> 1, tc)
        zc = torch.where(resc & (zc > tc), zc >> 1, zc)
        self.total[ctx, ar] = torch.where(m, tc, self.total[ctx, ar])
        self.zero[ctx, ar] = torch.where(m, zc, self.zero[ctx, ar])


def _decode_plane_plain(seg, st: _Lanes, h, w, is_hl, is_hh, lsb, mag_bits,
                        active, rows=None):
    """One bitplane of every active lane, in place on seg (hmax, wmax,
    n); the counterpart of decode_lanes.decode_plane_lanes.  ``rows``
    (a range, default all) decodes only those rows, so a caller can step
    one round's ``st`` row by row, as kernel 2's wavefront does."""
    hmax, wmax, n = seg.shape
    lut = st.lut
    magmask = (1 << mag_bits) - 1
    prev = lsb + 1
    zeros = torch.zeros(n, dtype=torch.int64, device=seg.device)

    def sig(r, c, plane):
        return (((seg[r, c] & magmask) >> plane) != 0).to(torch.int64)

    def sgn(r, c, plane):
        return torch.where(sig(r, c, plane) != 0,
                           -((seg[r, c] >> mag_bits) & 1), 0)

    for r in range(hmax) if rows is None else rows:
        row_act = active & (r < h)
        if not bool(row_act.any()):
            continue
        up = r > 0
        for c in range(wmax):
            act = row_act & (c < w) & ~st.err
            if not bool(act.any()):
                continue
            v = seg[r, c]
            cat = torch.clamp(msb_index((v & magmask) | 1) - lsb, 0, 3)
            down = (r + 1 < h)
            right = (c + 1 < w)
            c1 = min(c + 1, wmax - 1)
            r1 = min(r + 1, hmax - 1)
            hc = (sig(r, c - 1, lsb) if c > 0 else zeros) \
                + torch.where(right, sig(r, c1, prev), 0)
            vc = (sig(r - 1, c, lsb) if up else zeros) \
                + torch.where(down, sig(r1, c, prev), 0)
            dc = (sig(r - 1, c - 1, lsb) if up and c > 0 else zeros) \
                + (torch.where(down, sig(r1, c - 1, prev), 0)
                   if c > 0 else zeros) \
                + (torch.where(right, sig(r - 1, c1, lsb), 0)
                   if up else zeros) \
                + torch.where(down & right, sig(r1, c1, prev), 0)
            hh = torch.where(is_hl, vc, hc)
            vv = torch.where(is_hl, hc, vc)
            ctx0 = torch.where(
                is_hh, lut[LUT_HH + torch.clamp(hh + vv, max=4) * 5 + dc],
                lut[LUT_LL + torch.clamp(hh, max=2) * 15
                    + torch.clamp(vv, max=2) * 5 + dc])
            ctx = torch.where(cat == 0, ctx0,
                              torch.where(cat == 1,
                                          torch.where(hc + vc == 0, 9, 10),
                                          11))
            cat3 = cat == 3
            zc = torch.where(cat3, 1, st.zero[ctx, st.ar])
            tc = torch.where(cat3, 2, st.total[ctx, st.ar])
            bit = st.decode_bit(zc, tc, act)
            ok = act & ~st.err
            seg[r, c] = torch.where(ok, v | (bit << lsb), v)
            st.update(ctx, bit, ok & ~cat3)

            sgn_act = ok & (cat == 0) & (bit == 1)
            if not bool(sgn_act.any()):
                continue
            sh = 2 + (sgn(r, c - 1, lsb) if c > 0 else zeros) \
                + torch.where(right, sgn(r, c1, prev), 0)
            sv = 2 + (sgn(r - 1, c, lsb) if up else zeros) \
                + torch.where(down, sgn(r1, c, prev), 0)
            sh2 = torch.where(is_hl, sv, sh)
            sv2 = torch.where(is_hl, sh, sv)
            sctx = lut[LUT_SCTX + sh2 * 5 + sv2]
            pred = lut[LUT_SPRED + sh2 * 5 + sv2]
            agree = st.decode_bit(st.zero[sctx, st.ar], st.total[sctx, st.ar],
                                  sgn_act)
            ok2 = sgn_act & ~st.err
            seg[r, c] = torch.where(
                ok2, seg[r, c] | (((agree ^ pred) & 1) << mag_bits),
                seg[r, c])
            st.update(sctx, agree, ok2)


def _check_inputs(stream, offs, ebits, lane_end, geom, hmax, wmax):
    if stream.dtype != torch.uint8 or stream.dim() != 1:
        raise ValueError("stream must be a 1-D uint8 tensor")
    if stream.numel() >= MAX_STREAM_BYTES:
        raise ValueError("stream too long for 32-bit bit positions")
    R, n = offs.shape
    for name, t, shape in (("offs", offs, (R, n)), ("ebits", ebits, (R, n)),
                           ("lane_end", lane_end, (n,)),
                           ("geom", geom, (3, n))):
        if t.dtype != torch.int32 or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be int32 of shape {shape}")
        if t.device != stream.device:
            raise ValueError(f"{name} is on {t.device}, stream on "
                             f"{stream.device}")
    if hmax <= 0 or wmax <= 0:
        raise ValueError("empty canvas")


def decode_planes_plain(stream, offs, ebits, lane_end, geom, hmax: int,
                        wmax: int, lsb0: int, mag_bits: int, seg=None):
    """Plain PyTorch version of kernels 2 and 3: a loop over rounds and
    pixels, vectorised over lanes.  Same contract as ``decode_planes``;
    with ``seg`` (hmax * wmax, n) the canvas starts from it (kernel 3)
    instead of zeros."""
    _check_inputs(stream, offs, ebits, lane_end, geom, hmax, wmax)
    R, n = offs.shape
    dev = stream.device
    lut = decode_luts(str(dev)).to(torch.int64)
    s64 = stream.to(torch.int64)
    g = geom.to(torch.int64)
    h, w = g[0], g[1]
    is_hl = g[2] == C.SUBBAND_HL
    is_hh = g[2] == C.SUBBAND_HH
    if seg is None:
        seg = torch.zeros((hmax, wmax, n), dtype=torch.int64, device=dev)
    else:
        seg = seg.to(torch.int64).reshape(hmax, wmax, n).clone()
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    pos = torch.zeros((R, n), dtype=torch.int32, device=dev)
    for r in range(R):
        off = offs[r].to(torch.int64)
        alive = alive & (off >= 0)
        base = torch.clamp(off, min=0)
        readable = torch.where(alive, lane_end.to(torch.int64) - base, 0)
        st = _Lanes(s64, base, readable, ebits[r].to(torch.int64), lut)
        _decode_plane_plain(seg, st, h, w, is_hl, is_hh, lsb0 - r, mag_bits,
                            alive)
        pos[r] = st.pos.to(torch.int32)
        alive = alive & ~st.err
    return (seg.reshape(hmax * wmax, n).to(torch.int32),
            (~alive).to(torch.int32), pos)


def _placement_arg(placement: str) -> int:
    if placement not in ("auto", "device"):
        raise ValueError(f"canvas placement {placement!r} is not 'auto' or "
                         "'device'")
    return int(placement == "device")


def decode_planes(stream, offs, ebits, lane_end, geom, hmax: int, wmax: int,
                  lsb0: int, mag_bits: int, *, _placement: str = "auto"):
    """Kernel 2: decode R plane rounds of n lanes (contract above).

    CUDA tensors launch ``csrc/plane_decode.cu``; CPU tensors run the
    plain version.  The kernel keeps a lane's canvas in shared memory
    where it fits and in ``out`` otherwise; ``_placement="device"``
    forces the latter (for tests of that placement; no entry point
    passes it).  ``decode_planes.placement`` records the last launch's
    choice ("shared" or "device")."""
    force_device = _placement_arg(_placement)
    if stream.device.type == "cpu":
        return decode_planes_plain(stream, offs, ebits, lane_end, geom,
                                   hmax, wmax, lsb0, mag_bits)
    if stream.device.type != "cuda":
        raise ValueError(f"unsupported device {stream.device}")
    _check_inputs(stream, offs, ebits, lane_end, geom, hmax, wmax)
    R, n = offs.shape
    if not 1 <= R <= MAX_ROUNDS:
        raise ValueError(f"{R} rounds; kernel 2 runs 1 to {MAX_ROUNDS}")
    dev = stream.device
    args = [t.contiguous() for t in (stream, offs, ebits, lane_end, geom)]
    out = torch.zeros((hmax * wmax, n), dtype=torch.int32, device=dev)
    err = torch.empty(n, dtype=torch.int32, device=dev)
    pos = torch.empty((R, n), dtype=torch.int32, device=dev)
    luts = decode_luts(str(dev))
    fn = kernels.load("plane_decode").plane_decode_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 \
        + [ctypes.c_void_p] * 3
    where = ctypes.c_int(0)
    runs = kernels.run_slot(dev, "plane_decode")
    with torch.cuda.device(dev):
        cs = torch.cuda.current_stream(dev).cuda_stream
        status = fn(*(t.data_ptr() for t in args), luts.data_ptr(),
                    out.data_ptr(), err.data_ptr(), pos.data_ptr(), R, n,
                    hmax, wmax, lsb0, mag_bits, LUT_SIZE, force_device,
                    ctypes.byref(where), runs, cs)
    kernels.check(status, "plane_decode")
    decode_planes.launches += 1
    decode_planes.placement = _PLACEMENTS[where.value]
    return out, err, pos


decode_planes.launches = 0
decode_planes.placement = None


def _check_seed(seg, stream, n, hmax, wmax):
    if seg.dtype != torch.int32 or tuple(seg.shape) != (hmax * wmax, n):
        raise ValueError(f"seg must be int32 of shape {(hmax * wmax, n)}")
    if seg.device != stream.device:
        raise ValueError(f"seg is on {seg.device}, stream on {stream.device}")


def decode_plane_seeded_plain(stream, offs, ebits, lane_end, geom, seg,
                              hmax: int, wmax: int, lsb: int, mag_bits: int):
    """Plain PyTorch version of kernel 3 (one round of
    ``decode_planes_plain`` on the seed canvas)."""
    _check_seed(seg, stream, offs.shape[0], hmax, wmax)
    out, err, pos = decode_planes_plain(
        stream, offs[None], ebits[None], lane_end, geom, hmax, wmax, lsb,
        mag_bits, seg=seg)
    return out, err, pos[0]


def decode_plane_seeded(stream, offs, ebits, lane_end, geom, seg, hmax: int,
                        wmax: int, lsb: int, mag_bits: int, *,
                        _placement: str = "auto"):
    """Kernel 3: decode bitplane ``lsb`` of n lanes on the seed canvas
    ``seg``; returns (out (hmax * wmax, n), err (n,), pos (n,)).

    CUDA tensors launch ``csrc/plane_decode.cu``; CPU tensors run the
    plain version.  ``_placement`` as for ``decode_planes``."""
    force_device = _placement_arg(_placement)
    if stream.device.type == "cpu":
        return decode_plane_seeded_plain(stream, offs, ebits, lane_end, geom,
                                         seg, hmax, wmax, lsb, mag_bits)
    if stream.device.type != "cuda":
        raise ValueError(f"unsupported device {stream.device}")
    n = offs.shape[0]
    _check_inputs(stream, offs[None], ebits[None], lane_end, geom, hmax,
                  wmax)
    _check_seed(seg, stream, n, hmax, wmax)
    dev = stream.device
    args = [t.contiguous()
            for t in (stream, offs, ebits, lane_end, geom, seg)]
    out = torch.empty((hmax * wmax, n), dtype=torch.int32, device=dev)
    err = torch.empty(n, dtype=torch.int32, device=dev)
    pos = torch.empty(n, dtype=torch.int32, device=dev)
    luts = decode_luts(str(dev))
    fn = kernels.load("plane_decode").plane_decode_seeded_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 \
        + [ctypes.c_void_p] * 3
    where = ctypes.c_int(0)
    runs = kernels.run_slot(dev, "plane_decode_seeded")
    with torch.cuda.device(dev):
        cs = torch.cuda.current_stream(dev).cuda_stream
        status = fn(*(t.data_ptr() for t in args), luts.data_ptr(),
                    out.data_ptr(), err.data_ptr(), pos.data_ptr(), n, hmax,
                    wmax, lsb, mag_bits, LUT_SIZE, force_device,
                    ctypes.byref(where), runs, cs)
    kernels.check(status, "plane_decode_seeded")
    decode_plane_seeded.launches += 1
    decode_plane_seeded.placement = _PLACEMENTS[where.value]
    return out, err, pos


decode_plane_seeded.launches = 0
decode_plane_seeded.placement = None
