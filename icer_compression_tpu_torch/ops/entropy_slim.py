"""Slim interleaved coder: kernel 1 (``csrc/slim_encode.cu``) and its tail.

Counterpart: ``icer_compression_tpu/ops/pallas_entropy.py``, slim part in
fused-key mode: ``make_encode_lanes_slim`` (its ``_slim_step``),
``slim_sort_operand_packed``, ``slim_decode_packed`` and
``order_and_pack_lane_packed``.

Contract of kernel 1 (kept bit for bit from the TPU kernel):
  in      words  (L, lanes) int32 emission words valid | ctx<<1 | bit<<6
  out     rec    (L, lanes) one fused-key record per step:
                 [30:16] allocation ordinal (0x7FFF: no record), [15:11]
                 bin; golomb bins [10:1] k, [0] cb; custom bins [10:6]
                 k, [5:3] nb, [0] cb; uncoded bin [0] cb
          fstate (17, lanes) final bin state (open_alloc+1) | k<<17 | nb<<27
          misc   (8, lanes)  row 0 fallback flag, 1 codewords allocated,
                 2 evictions
          ev     (32, lanes) fused-key records of the codewords evicted by
                 the CIRC_BUF_SIZE reorder window (rows past the count are
                 0x7FFF << 16)
Each lane is one segment-bitplane stream.  ``encode_lanes_slim`` runs the
CUDA kernel on a CUDA tensor and the plain PyTorch version
``encode_lanes_slim_plain`` on a CPU tensor; the sort, codeword rebuild
and bit packing after it are PyTorch ops on either device.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..core import constants as C
from .. import kernels
from .pack import bitrev16, pack_records

BIG = 2 ** 30
BIG15 = 0x7FFF
BIGPK = BIG15 << 16
NEV = 32            # eviction side-buffer rows per lane
CHUNK = 256         # stream lengths are padded to a multiple of this

# LUT layout shared with csrc/slim_encode.cu (int32 offsets)
LUT_CUT = 0         # 16 bin cutoffs
LUT_GM = 16         # 17 golomb m per bin (1 for non-golomb bins)
LUT_CINB = 33       # 8 x 32 custom input-pattern lengths, bin-major
LUT_FLV = 289       # 8 x 8 x 32 custom flush bits, (bin, nb, prefix)
LUT_SIZE = 2337


def fused_key_ok(L: int) -> bool:
    """Fused-key records need every allocation ordinal below 2**15."""
    return L + 17 + NEV < (1 << 15)


def _build_luts() -> np.ndarray:
    cut = np.asarray(C.BIN_PROBABILITY_CUTOFFS[:16], np.int64)
    # the kernels count satisfied cutoffs, which equals the reference's
    # top-down scan (icer_util.c:48-56) only for an ascending ladder
    assert (np.diff(cut) >= 0).all()
    lut = np.zeros(LUT_SIZE, np.int64)
    lut[LUT_CUT:LUT_CUT + 16] = cut
    gm = np.ones(17, np.int64)
    gm[8:] = C.GOLOMB_M[8:17]
    lut[LUT_GM:LUT_GM + 17] = gm
    cinb = np.zeros((8, 32), np.int64)
    flv = np.zeros((8, 8, 32), np.int64)
    for b in range(1, 8):
        cinb[b] = [int(C.CUSTOM_IN_BITS[b, v]) for v in range(32)]
        for (pv, pn), (av, _an) in C.CUSTOM_FLUSH_BITS[b].items():
            flv[b, pn, pv] = av
    lut[LUT_CINB:LUT_CINB + 256] = cinb.reshape(-1)
    lut[LUT_FLV:LUT_FLV + 2048] = flv.reshape(-1)
    return lut.astype(np.int32)


_LUT_NP = _build_luts()


@functools.lru_cache(maxsize=None)
def slim_luts(device: str) -> torch.Tensor:
    return torch.as_tensor(_LUT_NP, device=device)


def encode_lanes_slim_plain(words: torch.Tensor):
    """Plain PyTorch version of kernel 1: a loop over the L steps,
    vectorised over lanes.  Same contract as ``encode_lanes_slim``."""
    L, lanes = words.shape
    dev = words.device
    lut = slim_luts(str(dev)).to(torch.int64)
    cut = lut[LUT_CUT:LUT_CUT + 16]
    gm = lut[LUT_GM:LUT_GM + 17]
    cinb = lut[LUT_CINB:LUT_CINB + 256]
    flv = lut[LUT_FLV:LUT_FLV + 2048]
    rows = torch.arange(17, device=dev)[:, None]
    ar = torch.arange(lanes, device=dev)

    zt = torch.full((17, lanes), C.DEFAULT_CONTEXT_TOTAL_COUNT
                    | (C.DEFAULT_CONTEXT_ZERO_COUNT << 16),
                    dtype=torch.int64, device=dev)
    bs = torch.zeros((17, lanes), dtype=torch.int64, device=dev)
    alloc = torch.zeros(lanes, dtype=torch.int64, device=dev)
    flg = torch.zeros(lanes, dtype=torch.int64, device=dev)
    ec = torch.zeros(lanes, dtype=torch.int64, device=dev)
    evbuf = torch.full((NEV + 1, lanes), BIGPK, dtype=torch.int64,
                       device=dev)
    rec = torch.empty((L, lanes), dtype=torch.int32, device=dev)
    words = words.to(torch.int64)

    for i in range(L):
        w = words[i]
        v = (w & 1) != 0
        c = (w >> 1) & 31
        b = (w >> 6) & 1
        cc = torch.clamp(c, max=16)

        # ---- counters & bin
        ztc = zt[cc, ar]
        tc = ztc & 0xFFFF
        zc = ztc >> 16
        unc = c >= 17
        zcu = torch.where(unc, 1, zc)
        tcu = torch.where(unc, 2, tc)
        inv = zcu < (tcu >> 1)
        zeff = torch.where(inv, tcu - zcu, zcu)
        cb = b ^ inv.to(torch.int64)
        bn = ((zeff << 16)[None, :] >= tcu[None, :] * cut[:, None]).sum(0)
        tc2 = tc + 1
        zc2 = zc + (b == 0).to(torch.int64)
        resc = tc2 >= C.CONTEXT_RESCALING_CAP
        tc2 = torch.where(resc, tc2 >> 1, tc2)
        zc2 = torch.where(resc & (zc2 > tc2), zc2 >> 1, zc2)
        zt[cc, ar] = torch.where(v & ~unc, tc2 | (zc2 << 16), ztc)

        # ---- bin state and reorder-window eviction
        bsb = bs[bn, ar]
        op1 = bsb & 0x1FFFF
        k = (bsb >> 17) & 1023
        nb = (bsb >> 27) & 31
        newly = op1 == 0
        opening = v & newly
        opq = bs & 0x1FFFF
        amin = torch.where(opq > 0, opq - 1, BIG).min(0).values
        ev = opening & (amin + C.CIRC_BUF_SIZE <= alloc)
        if bool(ev.any()):
            ise = (opq == (amin + 1)[None, :]) & (rows >= 1)
            ebin = (ise.to(torch.int64) * rows).max(0).values
            erow = bs[ebin, ar]
            ek = (erow >> 17) & 1023
            enb = (erow >> 27) & 31
            gpl = ((ebin << 11) | (ek << 1)
                   | (ek != gm[ebin] - 1).to(torch.int64))
            fv = flv[(ebin.clamp(max=7) * 8 + (enb & 7)) * 32 + (ek & 31)]
            fv = torch.where(ebin < 8, fv, 0)
            final = (ek | (fv << torch.where(ebin < 8, enb, 0))) & 31
            pl = torch.where(ebin >= 8, gpl, (ebin << 11) | (final << 6))
            eo = (amin << 16) | pl
            bs[ebin, ar] = torch.where(ev, 0, erow)
            slot = torch.where(ev & (ec < NEV), ec, NEV)
            evbuf[slot, ar] = torch.where(ev, eo, evbuf[slot, ar])
            flg = flg | (ev & (ec >= NEV)).to(torch.int64)
            ec = ec + ev.to(torch.int64)
        op1 = torch.where(newly, alloc + 1, op1)
        alloc = alloc + opening.to(torch.int64)
        k = torch.where(newly, 0, k)
        nb = torch.where(newly, 0, nb)

        # ---- codeword progress and completion
        isg = bn >= 8
        isc = (bn >= 1) & (bn <= 7)
        kz = k + (cb == 0).to(torch.int64)
        g_complete = (cb == 1) | (kz >= gm[bn])
        val = (k | (cb << nb)) & 31
        nb2 = nb + 1
        c_complete = cinb[bn.clamp(max=7) * 32 + val] == nb2
        complete = v & ((isg & g_complete) | (isc & c_complete)
                        | (~isg & ~isc))
        newk = torch.where(isg, kz, val)
        newrow = torch.where(complete, 0,
                             op1 | (newk << 17) | ((nb2 & 31) << 27))
        bs[bn, ar] = torch.where(v, newrow, bsb)
        pl = torch.where(
            isg, (bn << 11) | (k << 1) | cb,
            torch.where(isc, (bn << 11) | (k << 6) | ((nb & 7) << 3) | cb,
                        cb))
        rec[i] = torch.where(complete, ((op1 - 1) << 16) | pl,
                             BIGPK).to(torch.int32)

    misc = torch.zeros((8, lanes), dtype=torch.int64, device=dev)
    misc[0] = flg
    misc[1] = alloc
    misc[2] = ec
    return rec, _to_i32(bs), misc.to(torch.int32), evbuf[:NEV].to(torch.int32)


def _to_i32(x: torch.Tensor) -> torch.Tensor:
    """Low 32 bits of non-negative int64 values, as int32 bit patterns."""
    x = x & 0xFFFFFFFF
    return (x - ((x >> 31) << 32)).to(torch.int32)


def encode_lanes_slim(words: torch.Tensor):
    """Kernel 1: the slim coder over (L, lanes) int32 emission words.

    A CUDA tensor launches ``csrc/slim_encode.cu``; a CPU tensor runs the
    plain version.  Returns (rec, fstate, misc, ev) as described in the
    module docstring."""
    if words.dtype != torch.int32 or words.dim() != 2:
        raise ValueError("words must be a 2-D int32 tensor (L, lanes)")
    L, lanes = words.shape
    if L % CHUNK:
        raise ValueError(f"stream length {L} is not a multiple of {CHUNK}")
    if not fused_key_ok(L):
        raise ValueError(
            f"stream length {L} needs 15-bit-plus allocation keys; the "
            "two-word record mode for such lanes is not ported")
    if words.device.type == "cpu":
        return encode_lanes_slim_plain(words)
    if words.device.type != "cuda":
        raise ValueError(f"unsupported device {words.device}")
    words = words.contiguous()
    dev = words.device
    rec = torch.empty((L, lanes), dtype=torch.int32, device=dev)
    fstate = torch.empty((17, lanes), dtype=torch.int32, device=dev)
    misc = torch.empty((8, lanes), dtype=torch.int32, device=dev)
    ev = torch.empty((NEV, lanes), dtype=torch.int32, device=dev)
    luts = slim_luts(str(dev))
    lib = kernels.load("slim_encode")
    fn = lib.slim_encode_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = fn(words.data_ptr(), rec.data_ptr(), fstate.data_ptr(),
                    misc.data_ptr(), ev.data_ptr(), luts.data_ptr(), L,
                    lanes, LUT_SIZE, stream)
    kernels.check(status, "slim_encode")
    encode_lanes_slim.launches += 1
    return rec, fstate, misc, ev


encode_lanes_slim.launches = 0


# ---- tail: ordering sort, codeword rebuild, packing ---------------------

_GOL_M = np.ones(32, np.int64)
_GOL_L = np.ones(32, np.int64)
_GOL_I = np.zeros(32, np.int64)
_GOL_M[8:17] = C.GOLOMB_M[8:17]
_GOL_L[8:17] = C.GOLOMB_L[8:17]
_GOL_I[8:17] = C.GOLOMB_I[8:17]
_COUT = np.zeros((32, 32), np.int64)
_COBITS = np.zeros((32, 32), np.int64)
for _b in range(1, 8):
    _COUT[_b] = [int(C.CUSTOM_OUT_CODE[_b, v]) for v in range(32)]
    _COBITS[_b] = [int(C.CUSTOM_OUT_BITS[_b, v]) for v in range(32)]


@functools.lru_cache(maxsize=None)
def _tail_tables(device: str):
    return tuple(torch.as_tensor(t, device=device)
                 for t in (_GOL_M, _GOL_L, _GOL_I, _COUT.reshape(-1),
                           _COBITS.reshape(-1), _LUT_NP[LUT_FLV:]))


def slim_sort_operand_packed(rec: torch.Tensor, fstate: torch.Tensor,
                             ev: torch.Tensor) -> torch.Tensor:
    """Kernel outputs -> one (L + 17 + NEV, lanes) int32 sort operand:
    the records, the 17 end-of-plane flush records of the still-open
    codewords (golomb flush == completion with (k, cb=1), or (m-1, cb=0)
    for the full run; custom flush == completion whose k is the
    flush-extended prefix value with nb = cb = 0), and the evictions."""
    gm, _gl, _gi, _co, _cb, flv = _tail_tables(str(rec.device))
    f = fstate.to(torch.int64)
    fop1 = f & 0x1FFFF
    fk = (f >> 17) & 1023
    fnb = (f >> 27) & 31
    b = torch.arange(17, device=rec.device)[:, None].expand_as(f)
    gpl = (b << 11) | (fk << 1) | (fk != gm[b] - 1).to(torch.int64)
    fv = flv[(b.clamp(max=7) * 8 + (fnb & 7)) * 32 + (fk & 31)]
    cust = (b >= 1) & (b <= 7)
    final = (fk | (torch.where(cust, fv, 0)
                   << torch.where(cust, fnb, 0))) & 31
    pl = torch.where(b >= 8, gpl, (b << 11) | (final << 6))
    tail = torch.where((fop1 > 0) & (b >= 1), ((fop1 - 1) << 16) | pl, BIGPK)
    return torch.cat([rec, tail.to(torch.int32), ev])


def slim_decode_packed(w: torch.Tensor):
    """Sorted fused-key records -> (code, nbits), int64.  Rows must be
    masked by the caller's record-valid flags."""
    gm, gl, gi, cout, cobits, _flv = _tail_tables(str(w.device))
    w = w.to(torch.int64)
    bn = (w >> 11) & 31
    isg = bn >= 8
    isc = (bn >= 1) & (bn <= 7)
    k = torch.where(isg, (w >> 1) & 1023, (w >> 6) & 31)
    cb = w & 1
    nb = torch.where(isc, (w >> 3) & 7, 0)
    m_e, l_e, i_e = gm[bn], gl[bn], gi[bn]
    run_done = (cb == 0) & (k + 1 >= m_e)
    adj = torch.where(k < i_e, k, k + i_e)
    glen = l_e + (k >= i_e).to(torch.int64)
    g_code = torch.where(run_done, 1, bitrev16(adj, glen))
    g_bits = torch.where(run_done, 1, glen)
    val = (k | (cb << nb)) & 31
    code = torch.where(isg, g_code, torch.where(isc, cout[bn * 32 + val], cb))
    nbits = torch.where(isg, g_bits,
                        torch.where(isc, cobits[bn * 32 + val], 1))
    return code, nbits


def order_and_pack_lanes(ops: torch.Tensor, max_bits: int, slice_to: int):
    """(rows, lanes) fused-key sort operand -> per lane (payload uint8
    (lanes, max_bits // 8), total bits int64, overflow bool).  The sort
    orders records by allocation ordinal (the reference's output order);
    a lane with more than ``slice_to`` records or more than ``max_bits``
    bits sets its overflow flag."""
    s = torch.sort(ops.t(), dim=-1).values
    over = torch.zeros(s.shape[0], dtype=torch.bool, device=s.device)
    if slice_to < s.shape[-1]:
        over = (s[:, slice_to] >> 16) != BIG15
        s = s[:, :slice_to]
    rv = (s >> 16) != BIG15
    code, nbits = slim_decode_packed(s)
    payload, total, over2 = pack_records(code, nbits, rv, max_bits)
    return payload, total, over | over2
