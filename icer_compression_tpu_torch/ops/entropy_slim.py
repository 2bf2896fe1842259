"""Slim interleaved coder: kernel 1 (``csrc/slim_encode.cu``) and its tail.

Counterpart: ``icer_compression_tpu/ops/pallas_entropy.py``, slim part:
``make_encode_lanes_slim`` (its ``_slim_step``) in both record modes, and
its tails ``slim_sort_operand_packed``, ``slim_decode_packed`` and
``order_and_pack_lane_packed`` (fused key) and ``slim_sort_operands``,
``slim_decode_op`` and ``order_and_pack_lane_slim`` (two words).

Contract of kernel 1 (kept bit for bit from the TPU kernel where a lane's
allocation ordinals fit 17 bits and its evictions 32 rows):
  in      words  (L, lanes) int32 emission words valid | ctx<<1 | bit<<6,
                 L a multiple of CHUNK
  fused-key mode, while L + 17 + NEV < 2**15 (``fused_key_ok``):
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
  two-word mode, for longer lanes (any L), with a side buffer of ``nev``
  rows (32 in the TPU kernel; ``eviction_rows(L)`` rows, which no lane can
  overflow, on the encoder's path):
  out     rec1   (L, lanes) 1 | bin<<1 | k<<6 | cb<<16 | (nb&7)<<17 when a
                 codeword completes, else 0
          rec2   (L, lanes) its allocation ordinal, else BIG
          fstate as above, its ordinal field the open ordinal's low 17
                 bits; misc as above (row 0: more than nev evictions)
          ev1    (nev, lanes) the evicted codewords, already built:
                 1 | code<<1 | nbits<<17 | 1<<22 (rows past the count 0)
          ev2    (nev, lanes) their allocation ordinals (else BIG)
          fopen  (17, lanes) each bin's open ordinal + 1 (0: closed), the
                 full-width counterpart of fstate's ordinal field
Each lane is one segment-bitplane stream.  ``encode_lanes_slim`` runs the
fused-key mode and ``encode_lanes_slim_two_word`` the two-word mode;
``code_lanes_slim`` picks the mode from L and runs the kernel and its
tail.  The wrappers run the CUDA kernel on a CUDA tensor and the
plain PyTorch version ``encode_lanes_slim_plain`` on a CPU tensor.

The tail (sort and pack) puts a lane's records in allocation order,
rebuilds each codeword and packs them LSB-first: ``pack_lanes_slim`` and
``pack_lanes_slim_two_word`` launch ``csrc/slim_pack.cu`` on CUDA tensors,
which writes each record at its ordinal (the ordinals of a lane's valid
records are 0 .. misc[1] - 1, each once), and on CPU tensors run the plain
version, a sort of the records (``order_and_pack_lanes``,
``order_and_pack_lanes_two_word``).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..core import constants as C
from .. import kernels
from ..utils import trace
from .pack import bitrev16, pack_records

BIG = 2 ** 30
BIG15 = 0x7FFF
BIGPK = BIG15 << 16
NEV = 32            # eviction side-buffer rows per lane (TPU kernel)
CHUNK = 256         # stream lengths are padded to a multiple of this

# LUT layout shared with csrc/slim_encode.cu and csrc/full_encode.cu
# (int32 offsets)
LUT_CUT = 0         # 16 bin cutoffs
LUT_GM = 16         # 17 golomb m per bin (1 for non-golomb bins)
LUT_CINB = 33       # 8 x 32 custom input-pattern lengths, bin-major
LUT_FLV = 289       # 8 x 8 x 32 custom flush bits, (bin, nb, prefix)
LUT_FUSED = 2337    # the tables above: all the fused-key instance reads
LUT_GL = 2337       # 17 golomb l per bin (1 below bin 8)
LUT_GI = 2354       # 17 golomb i per bin (0 below bin 8)
LUT_COUT = 2371     # 8 x 32 custom output codes, bin-major
LUT_COBITS = 2627   # 8 x 32 custom output code lengths
LUT_SIZE = 2883     # the two-word instance and kernels 4/5 read all of it


def fused_key_ok(L: int) -> bool:
    """Fused-key records need every allocation ordinal below 2**15."""
    return L + 17 + NEV < (1 << 15)


def eviction_rows(L: int) -> int:
    """Side-buffer rows that no lane of L steps overflows: after bin q is
    evicted, its next codeword opens at an ordinal no smaller than the
    allocation count then, so it is evicted again only CIRC_BUF_SIZE
    allocations later; bin 0 never stays open, and a lane allocates at
    most L codewords."""
    return 16 * (L // C.CIRC_BUF_SIZE + 1)


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
    gl = np.ones(17, np.int64)
    gi = np.zeros(17, np.int64)
    gl[8:] = C.GOLOMB_L[8:17]
    gi[8:] = C.GOLOMB_I[8:17]
    lut[LUT_GL:LUT_GL + 17] = gl
    lut[LUT_GI:LUT_GI + 17] = gi
    for b in range(1, 8):
        lut[LUT_COUT + 32 * b:LUT_COUT + 32 * b + 32] = [
            int(C.CUSTOM_OUT_CODE[b, v]) for v in range(32)]
        lut[LUT_COBITS + 32 * b:LUT_COBITS + 32 * b + 32] = [
            int(C.CUSTOM_OUT_BITS[b, v]) for v in range(32)]
    return lut.astype(np.int32)


_LUT_NP = _build_luts()


@functools.lru_cache(maxsize=None)
def slim_luts(device: str) -> torch.Tensor:
    return torch.as_tensor(_LUT_NP, device=device)


def encode_lanes_slim_plain(words: torch.Tensor, two_word: bool = False,
                            nev: int = NEV):
    """Plain PyTorch version of kernel 1: a loop over the L steps,
    vectorised over lanes.  Returns the fused-key outputs (rec, fstate,
    misc, ev), or with ``two_word`` (rec1, rec2, fstate, misc, ev1, ev2,
    fopen) with ``nev`` side-buffer rows, as described in the module
    docstring."""
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
    bo = torch.zeros((17, lanes), dtype=torch.int64, device=dev)  # open+1
    bs = torch.zeros((17, lanes), dtype=torch.int64, device=dev)  # k|nb<<16
    alloc = torch.zeros(lanes, dtype=torch.int64, device=dev)
    flg = torch.zeros(lanes, dtype=torch.int64, device=dev)
    ec = torch.zeros(lanes, dtype=torch.int64, device=dev)
    evbuf = torch.full((nev + 1, lanes), 0 if two_word else BIGPK,
                       dtype=torch.int64, device=dev)
    evbuf2 = torch.full((nev + 1, lanes), BIG, dtype=torch.int64,
                        device=dev)
    rec = torch.empty((L, lanes), dtype=torch.int32, device=dev)
    rec2 = torch.empty((L, lanes), dtype=torch.int32, device=dev)
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
        bob = bo[bn, ar]
        op1 = bob
        k = bsb & 0xFFFF
        nb = (bsb >> 16) & 31
        newly = op1 == 0
        opening = v & newly
        amin = torch.where(bo > 0, bo - 1, BIG).min(0).values
        ev = opening & (amin + C.CIRC_BUF_SIZE <= alloc)
        if bool(ev.any()):
            ise = (bo == (amin + 1)[None, :]) & (rows >= 1)
            ebin = (ise.to(torch.int64) * rows).max(0).values
            erow = bs[ebin, ar]
            ek = erow & 0xFFFF
            enb = (erow >> 16) & 31
            if two_word:
                ecode, ebits = _flush_code(ebin, ek, enb)
                eo = 1 | (ecode << 1) | (ebits << 17) | (1 << 22)
            else:
                gpl = ((ebin << 11) | (ek << 1)
                       | (ek != gm[ebin] - 1).to(torch.int64))
                fv = flv[(ebin.clamp(max=7) * 8 + (enb & 7)) * 32
                         + (ek & 31)]
                fv = torch.where(ebin < 8, fv, 0)
                final = (ek | (fv << torch.where(ebin < 8, enb, 0))) & 31
                pl = torch.where(ebin >= 8, gpl,
                                 (ebin << 11) | (final << 6))
                eo = (amin << 16) | pl
            bs[ebin, ar] = torch.where(ev, 0, erow)
            bo[ebin, ar] = torch.where(ev, 0, bo[ebin, ar])
            slot = torch.where(ev & (ec < nev), ec, nev)
            evbuf[slot, ar] = torch.where(ev, eo, evbuf[slot, ar])
            evbuf2[slot, ar] = torch.where(ev, amin, evbuf2[slot, ar])
            flg = flg | (ev & (ec >= nev)).to(torch.int64)
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
        bs[bn, ar] = torch.where(v, torch.where(complete, 0,
                                                newk | ((nb2 & 31) << 16)),
                                 bsb)
        bo[bn, ar] = torch.where(v, torch.where(complete, 0, op1), bob)
        if two_word:
            rec[i] = torch.where(complete, 1 | (bn << 1) | (k << 6)
                                 | (cb << 16) | ((nb & 7) << 17), 0)
            rec2[i] = torch.where(complete, op1 - 1, BIG)
        else:
            pl = torch.where(
                isg, (bn << 11) | (k << 1) | cb,
                torch.where(isc,
                            (bn << 11) | (k << 6) | ((nb & 7) << 3) | cb,
                            cb))
            rec[i] = torch.where(complete, ((op1 - 1) << 16) | pl, BIGPK)

    misc = torch.zeros((8, lanes), dtype=torch.int64, device=dev)
    misc[0] = flg
    misc[1] = alloc
    misc[2] = ec
    fstate = _to_i32((bo & 0x1FFFF) | ((bs & 0xFFFF) << 17)
                     | (((bs >> 16) & 31) << 27))
    state = (fstate, misc.to(torch.int32))
    ev_rows = evbuf[:nev].to(torch.int32)
    if two_word:
        return (rec, rec2) + state + (ev_rows, evbuf2[:nev].to(torch.int32),
                                      bo.to(torch.int32))
    return (rec,) + state + (ev_rows,)


def _to_i32(x: torch.Tensor) -> torch.Tensor:
    """Low 32 bits of non-negative int64 values, as int32 bit patterns."""
    x = x & 0xFFFFFFFF
    return (x - ((x >> 31) << 32)).to(torch.int32)


def _check_words(words: torch.Tensor) -> None:
    if words.dtype != torch.int32 or words.dim() != 2:
        raise ValueError("words must be a 2-D int32 tensor (L, lanes)")
    L = words.shape[0]
    if L % CHUNK:
        raise ValueError(f"stream length {L} is not a multiple of {CHUNK}")
    if words.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {words.device}")


def _launch(words: torch.Tensor, nev: int | None):
    """One launch of kernel 1's fused-key instance (``nev`` None) or its
    two-word one with ``nev`` side-buffer rows."""
    words = words.contiguous()
    L, lanes = words.shape
    dev = words.device

    def out(rows):
        return torch.empty((rows, lanes), dtype=torch.int32, device=dev)

    lib = kernels.load("slim_encode")
    if nev is None:
        outs = [out(L), out(17), out(8), out(NEV)]
        fn, sizes = lib.slim_encode_launch, (L, lanes)
    else:
        outs = [out(L), out(L), out(17), out(8), out(nev), out(nev),
                out(17)]
        fn, sizes = lib.slim_encode_two_word_launch, (L, lanes, nev)
    luts = slim_luts(str(dev))
    runs = kernels.run_slot(dev, "slim_encode" if nev is None
                            else "slim_encode_two_word")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * (len(outs) + 2) \
        + [ctypes.c_int] * (len(sizes) + 1) + [ctypes.c_void_p] * 2
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = fn(words.data_ptr(), *(t.data_ptr() for t in outs),
                    luts.data_ptr(), *sizes, LUT_SIZE, runs, stream)
    kernels.check(status, "slim_encode")
    return tuple(outs)


def encode_lanes_slim(words: torch.Tensor):
    """Kernel 1 in its fused-key mode: the slim coder over (L, lanes)
    int32 emission words, L within ``fused_key_ok``.

    A CUDA tensor launches ``csrc/slim_encode.cu``; a CPU tensor runs the
    plain version.  Returns (rec, fstate, misc, ev) as described in the
    module docstring."""
    _check_words(words)
    if not fused_key_ok(words.shape[0]):
        raise ValueError(f"stream length {words.shape[0]} is past the "
                         "fused-key limit; use the two-word mode")
    if words.device.type == "cpu":
        return encode_lanes_slim_plain(words)
    res = _launch(words, None)
    encode_lanes_slim.launches += 1
    return res


encode_lanes_slim.launches = 0


def encode_lanes_slim_two_word(words: torch.Tensor, nev: int = NEV):
    """Kernel 1 in its two-word mode, at any length, with ``nev`` rows of
    eviction side buffer (a lane past them sets its flag): returns (rec1,
    rec2, fstate, misc, ev1, ev2, fopen).  A CUDA tensor launches the
    two-word instance of ``csrc/slim_encode.cu``; a CPU tensor runs the
    plain version."""
    _check_words(words)
    if not (1 <= nev and words.shape[0] + 17 + nev < BIG):
        raise ValueError(f"side buffer of {nev} rows for a stream of "
                         f"{words.shape[0]} steps")
    if words.device.type == "cpu":
        return encode_lanes_slim_plain(words, two_word=True, nev=nev)
    res = _launch(words, nev)
    encode_lanes_slim_two_word.launches += 1
    return res


encode_lanes_slim_two_word.launches = 0


def code_lanes_slim(words: torch.Tensor, max_bits: int, slice_to: int):
    """Kernel 1 and its tail over (L, lanes) emission words, in the
    fused-key mode where ``fused_key_ok(L)`` and in the two-word mode
    otherwise (as ``encode_jax.py`` picks it per bucket).  Returns per
    lane (payload uint8 (lanes, max_bits // 8), total bits int64, flag
    bool): the flag marks a lane past ``slice_to`` records, past
    ``max_bits`` bits or past the fused-key side buffer, which the caller
    re-encodes on the host.  The two-word mode sizes its side buffer by
    ``eviction_rows``, so its evictions flag no lane.  On the card it marks
    the kernel's stage and then the tail's (utils/trace)."""
    _check_words(words)
    L = words.shape[0]
    trace.mark(trace.CODER_KERNEL, words)
    if fused_key_ok(L):
        rec, fstate, misc, ev = encode_lanes_slim(words)
        trace.mark(trace.SORT_PACK, words)
        payload, total, over = pack_lanes_slim(rec, fstate, ev, misc,
                                               max_bits, slice_to)
    else:
        rec1, rec2, fstate, misc, ev1, ev2, fopen = \
            encode_lanes_slim_two_word(words, eviction_rows(L))
        trace.mark(trace.SORT_PACK, words)
        payload, total, over = pack_lanes_slim_two_word(
            rec1, rec2, fstate, fopen, ev1, ev2, misc, max_bits, slice_to)
    return payload, total, over | (misc[0] != 0)


# ---- tail on the card: csrc/slim_pack.cu ---------------------------------

PACK_CHUNK = 2048   # ordinals one block of slim_pack.cu sums and packs
PACK_ALIGN = 16     # scratch rows are padded to this many ordinals


def _pack_launch(recs, misc, max_bits: int, slice_to: int):
    """One launch of ``csrc/slim_pack.cu`` over kernel 1's outputs:
    ``recs`` (rec, fstate, ev) in the fused-key mode or (rec1, rec2,
    fstate, fopen, ev1, ev2) in the two-word mode.  Returns (payload,
    total, over) as ``order_and_pack_lanes``."""
    two_word = len(recs) == 6
    recs = [t.contiguous() for t in recs]
    misc = misc.contiguous()
    L, lanes = recs[0].shape
    nev = recs[-1].shape[0]
    dev = recs[0].device
    stride = -(-max(slice_to, 1) // PACK_ALIGN) * PACK_ALIGN
    nch = -(-max(slice_to, 1) // PACK_CHUNK)
    scratch = torch.empty((lanes, stride), dtype=torch.int32, device=dev)
    sums = torch.empty((lanes, nch), dtype=torch.int32, device=dev)
    payload = torch.empty((lanes, max_bits // 8), dtype=torch.uint8,
                          device=dev)
    total = torch.empty(lanes, dtype=torch.int64, device=dev)
    over = torch.empty(lanes, dtype=torch.bool, device=dev)
    if two_word:
        rec1, rec2, fstate, fopen, ev1, ev2 = recs
    else:
        (rec1, fstate, ev1), rec2, fopen, ev2 = recs, None, None, None
    lib = kernels.load("slim_pack")
    fn = lib.slim_pack_two_word_launch if two_word else lib.slim_pack_launch
    runs = kernels.run_slot(dev, "slim_pack_two_word" if two_word
                            else "slim_pack")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 \
        + [ctypes.c_longlong, ctypes.c_int] + [ctypes.c_void_p] * 7

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = fn(*map(ptr, (rec1, rec2, fstate, fopen, ev1, ev2, misc,
                               slim_luts(str(dev)))),
                    L, lanes, nev, slice_to, stride, nch, max_bits, LUT_SIZE,
                    *map(ptr, (scratch, sums, payload, total, over)), runs,
                    stream)
    kernels.check(status, "slim_pack")
    return payload, total, over


def _check_pack(max_bits: int, slice_to: int) -> None:
    if max_bits % 32 or max_bits < 0 or slice_to < 0:
        raise ValueError(f"payload cap {max_bits} bits is not a multiple of "
                         f"32, or slice {slice_to} is negative")


def pack_lanes_slim(rec, fstate, ev, misc, max_bits: int, slice_to: int):
    """Sort and pack after kernel 1's fused-key mode: (rec, fstate, misc,
    ev) -> per lane (payload uint8 (lanes, max_bits // 8), total bits
    int64, overflow bool), as ``order_and_pack_lanes`` on
    ``slim_sort_operand_packed``, equal to it on every lane whose misc[0]
    is 0.  A CUDA tensor launches ``csrc/slim_pack.cu``; a CPU tensor runs
    that sort-based plain version."""
    _check_pack(max_bits, slice_to)
    if rec.device.type == "cpu":
        return order_and_pack_lanes(slim_sort_operand_packed(rec, fstate, ev),
                                    max_bits, slice_to)
    res = _pack_launch((rec, fstate, ev), misc, max_bits, slice_to)
    pack_lanes_slim.launches += 1
    return res


pack_lanes_slim.launches = 0


def pack_lanes_slim_two_word(rec1, rec2, fstate, fopen, ev1, ev2, misc,
                             max_bits: int, slice_to: int):
    """Sort and pack after kernel 1's two-word mode, as
    ``order_and_pack_lanes_two_word`` on ``slim_sort_operands``; a CUDA
    tensor launches ``csrc/slim_pack.cu``, a CPU tensor runs that plain
    version."""
    _check_pack(max_bits, slice_to)
    if rec1.device.type == "cpu":
        return order_and_pack_lanes_two_word(
            *slim_sort_operands(rec1, rec2, fstate, fopen, ev1, ev2),
            max_bits, slice_to)
    res = _pack_launch((rec1, rec2, fstate, fopen, ev1, ev2), misc,
                       max_bits, slice_to)
    pack_lanes_slim_two_word.launches += 1
    return res


pack_lanes_slim_two_word.launches = 0


# ---- plain tail: ordering sort, codeword rebuild, packing ---------------

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
                           _COBITS.reshape(-1), _LUT_NP[LUT_FLV:LUT_FUSED]))


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


def _codewords(bn, k, cb, nb):
    """(code, nbits) of completed codewords from their (bin, k, cb, nb)
    fields, int64: the golomb remainder or full run, the custom output
    table of the prefix value, or the uncoded bit."""
    gm, gl, gi, cout, cobits, _flv = _tail_tables(str(bn.device))
    isg = bn >= 8
    isc = (bn >= 1) & (bn <= 7)
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


def _flush_code(b, k, nb):
    """(code, nbits) that flush the open codeword (k, nb) of bin ``b``
    (1..16), int64: a golomb bin's partial run, or the full-run '1' at
    k = m-1; a custom bin's prefix extended by its flush bits, through the
    output table (icer_encoding.c:141-189)."""
    _gm, _gl, _gi, _co, _cb, flv = _tail_tables(str(b.device))
    cust = b <= 7
    fv = torch.where(cust, flv[(b.clamp(max=7) * 8 + (nb & 7)) * 32
                               + (k & 31)], 0)
    final = (k | (fv << torch.where(cust, nb, 0))) & 31
    return _codewords(b, torch.where(cust, final, k),
                      torch.zeros_like(k), torch.zeros_like(k))


def slim_decode_packed(w: torch.Tensor):
    """Sorted fused-key records -> (code, nbits), int64.  Rows must be
    masked by the caller's record-valid flags."""
    w = w.to(torch.int64)
    bn = (w >> 11) & 31
    isg = bn >= 8
    isc = (bn >= 1) & (bn <= 7)
    k = torch.where(isg, (w >> 1) & 1023, (w >> 6) & 31)
    nb = torch.where(isc, (w >> 3) & 7, 0)
    return _codewords(bn, k, w & 1, nb)


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


# ---- two-word tail (lanes past the fused-key limit) ---------------------

def slim_sort_operands(rec1, rec2, fstate, fopen, ev1, ev2):
    """Two-word kernel outputs -> (ops, keys), each (L + 17 + nev, lanes)
    int32: the records, then the 17 end-of-plane flush rows of the
    still-open codewords, built from the final bin state (k and nb from
    ``fstate``, the open ordinal from ``fopen``, at full width) and marked
    with bit 22 (1 | code<<1 | nbits<<17 | 1<<22, key = their ordinal),
    then the evictions, which arrive built from the kernel.  Keys are
    allocation ordinals, BIG for rows without a codeword."""
    f = fstate.to(torch.int64)
    fop1 = fopen.to(torch.int64)
    b = torch.arange(17, device=f.device)[:, None].expand_as(f)
    code, nbits = _flush_code(b, (f >> 17) & 1023, (f >> 27) & 31)
    is_open = fop1 > 0
    tail_op = torch.where(is_open,
                          1 | (code << 1) | (nbits << 17) | (1 << 22), 0)
    tail_key = torch.where(is_open, fop1 - 1, BIG)
    return (torch.cat([rec1, tail_op.to(torch.int32), ev1]),
            torch.cat([rec2, tail_key.to(torch.int32), ev2]))


def slim_decode_op(p2: torch.Tensor):
    """Sorted two-word records -> (code, nbits), int64: regular records
    rebuild their codeword from (bin, k, cb, nb); bit-22 rows carry it
    inline.  Rows must be masked by the caller's record-valid flags."""
    p2 = p2.to(torch.int64)
    code, nbits = _codewords((p2 >> 1) & 31, (p2 >> 6) & 1023,
                             (p2 >> 16) & 1, (p2 >> 17) & 7)
    tail = ((p2 >> 22) & 1) != 0
    return (torch.where(tail, (p2 >> 1) & 0xFFFF, code),
            torch.where(tail, (p2 >> 17) & 31, nbits))


def order_and_pack_lanes_two_word(ops: torch.Tensor, keys: torch.Tensor,
                                  max_bits: int, slice_to: int):
    """(rows, lanes) two-word sort operands -> per lane (payload uint8
    (lanes, max_bits // 8), total bits int64, overflow bool), as
    ``order_and_pack_lanes``: the records in allocation order (keys are
    unique but for BIG), cut to ``slice_to``."""
    skey, order = torch.sort(keys.t(), dim=-1)
    over = torch.zeros(skey.shape[0], dtype=torch.bool, device=skey.device)
    if slice_to < skey.shape[-1]:
        over = skey[:, slice_to] != BIG
        skey, order = skey[:, :slice_to], order[:, :slice_to]
    code, nbits = slim_decode_op(torch.gather(ops.t(), -1, order))
    payload, total, over2 = pack_records(code, nbits, skey != BIG, max_bits)
    return payload, total, over | over2
