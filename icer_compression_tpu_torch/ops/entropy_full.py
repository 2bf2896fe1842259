"""Full state-machine coder: kernels 4 and 5 (``csrc/full_encode.cu``) and
the record tail of the ``pallas`` coder backend.

Counterparts: ``icer_compression_tpu/ops/pallas_entropy.py``
(``make_encode_lanes_pallas`` with ``_coder_step`` and ``_tail_flush`` for
kernel 4, ``make_encode_lanes_pallas_tiled`` for kernel 5,
``order_and_pack_lane`` for the tail, whose flush detection is
``ops/entropy_sorted.detect_flush_records``).

Contract of kernels 4 and 5 (kept bit for bit from the TPU kernels):
  in      valid, ctx, bit  (L, lanes) int32 emission streams
  out     code, nbits, open  (L + 17, lanes) int32:
          rows below L: the codeword completed at that emission (nbits 0
          and open BIG where none completed), open = the emission that
          opened it;
          rows L + b: bin b's end-of-plane flush word, open = the bin's
          opening emission, or BIG (and code = nbits = 0) where the bin is
          closed.
Each lane is one segment-bitplane stream.  ``encode_lanes_full`` and
``encode_lanes_full_tiled`` launch the CUDA kernels on CUDA tensors;
``encode_lanes_full_plain`` is the plain PyTorch version of both and runs
on CPU tensors.  The tail orders the records by opening emission, detects
the reorder-window flush (a lane that needs it is re-encoded on the host:
these kernels have no in-kernel eviction) and packs the bits.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..core import constants as C
from .. import kernels
from . import entropy_slim as ES
from .entropy_sorted import detect_flush_records
from .pack import bitrev16, pack_records

BIG = 2 ** 30

# LUT layout shared with csrc/full_encode.cu (int32 offsets): kernel 1's
# LUT (ops/entropy_slim), which holds every table the full coder reads, so
# both coders read one flush table.
LUT_CUT, LUT_GM, LUT_CINB, LUT_FLV = (ES.LUT_CUT, ES.LUT_GM, ES.LUT_CINB,
                                      ES.LUT_FLV)
LUT_GL, LUT_GI, LUT_COUT, LUT_COBITS = (ES.LUT_GL, ES.LUT_GI, ES.LUT_COUT,
                                        ES.LUT_COBITS)
LUT_SIZE = ES.LUT_SIZE
full_luts = ES.slim_luts


def encode_lanes_full_plain(valid: torch.Tensor, ctx: torch.Tensor,
                            bit: torch.Tensor):
    """Plain PyTorch version of kernels 4 and 5: a loop over the L steps,
    vectorised over lanes.  Same contract as ``encode_lanes_full``."""
    L, lanes = valid.shape
    dev = valid.device
    lut = full_luts(str(dev)).to(torch.int64)
    cut = lut[LUT_CUT:LUT_CUT + 16]
    gm = lut[LUT_GM:LUT_GM + 17]
    gl = lut[LUT_GL:LUT_GL + 17]
    gi = lut[LUT_GI:LUT_GI + 17]
    cinb = lut[LUT_CINB:LUT_CINB + 256]
    cout = lut[LUT_COUT:LUT_COUT + 256]
    cobits = lut[LUT_COBITS:LUT_COBITS + 256]
    flv = lut[LUT_FLV:LUT_FLV + 2048]
    ar = torch.arange(lanes, device=dev)
    z = functools.partial(torch.zeros, dtype=torch.int64, device=dev)

    zero = torch.full((17, lanes), C.DEFAULT_CONTEXT_ZERO_COUNT,
                      dtype=torch.int64, device=dev)
    total = torch.full((17, lanes), C.DEFAULT_CONTEXT_TOTAL_COUNT,
                       dtype=torch.int64, device=dev)
    bk, bnb = z((17, lanes)), z((17, lanes))
    bop = torch.full((17, lanes), -1, dtype=torch.int64, device=dev)
    code = z((L + 17, lanes))
    nbits = z((L + 17, lanes))
    opn = torch.full((L + 17, lanes), BIG, dtype=torch.int64, device=dev)
    valid = valid.to(torch.int64) != 0
    ctx = ctx.to(torch.int64)
    bit = bit.to(torch.int64)

    for i in range(L):
        v, c, b = valid[i], ctx[i], bit[i]
        # ---- counters & bin (the uncoded context codes with (1, 2))
        unc = c >= 17
        cc = torch.clamp(c, max=16)
        zc = zero[cc, ar]
        tc = total[cc, ar]
        zcu = torch.where(unc, 1, zc)
        tcu = torch.where(unc, 2, tc)
        inv = zcu < (tcu >> 1)
        zeff = torch.where(inv, tcu - zcu, zcu)
        cb = b ^ inv.to(torch.int64)
        bn = ((zeff << 16)[None, :] >= tcu[None, :] * cut[:, None]).sum(0)
        upd = v & ~unc
        tc2 = tc + 1
        zc2 = zc + (b == 0).to(torch.int64)
        resc = tc2 >= C.CONTEXT_RESCALING_CAP
        tc2 = torch.where(resc, tc2 >> 1, tc2)
        zc2 = torch.where(resc & (zc2 > tc2), zc2 >> 1, zc2)
        zero[cc, ar] = torch.where(upd, zc2, zc)
        total[cc, ar] = torch.where(upd, tc2, tc)

        # ---- the bin's open codeword
        k = bk[bn, ar]
        nb = bnb[bn, ar]
        op = bop[bn, ar]
        newly = op < 0
        op2 = torch.where(newly, i, op)
        k = torch.where(newly, 0, k)
        nb = torch.where(newly, 0, nb)
        isg = bn >= 8
        isc = (bn >= 1) & (bn <= 7)

        # golomb: a one ends the run (codeword of the k zeros before it),
        # m zeros are a full run (the 1-bit codeword '1')
        m_e, l_e, i_e = gm[bn], gl[bn], gi[bn]
        kz = k + (cb == 0).to(torch.int64)
        run_done = (cb == 0) & (kz >= m_e)
        adj = torch.where(k < i_e, k, k + i_e)
        glen = l_e + (k >= i_e).to(torch.int64)
        g_code = torch.where(run_done, 1, bitrev16(adj, glen))
        g_bits = torch.where(run_done, 1, glen)
        g_complete = (cb == 1) | run_done

        # custom: the input prefix grows by one bit (nb <= 4 in these bins)
        val = (k | (cb << torch.where(isc, nb, 0))) & 31
        nb2 = nb + 1
        key = torch.clamp(bn, max=7) * 32 + val
        c_complete = cinb[key] == nb2

        complete = v & ((isg & g_complete) | (isc & c_complete)
                        | (~isg & ~isc))
        cw = torch.where(isg, g_code, torch.where(isc, cout[key], cb))
        cn = torch.where(isg, g_bits, torch.where(isc, cobits[key], 1))
        newk = torch.where(isg, kz, val)
        bk[bn, ar] = torch.where(v, torch.where(complete, 0, newk), bk[bn, ar])
        bnb[bn, ar] = torch.where(v, torch.where(complete, 0, nb2),
                                  bnb[bn, ar])
        bop[bn, ar] = torch.where(v, torch.where(complete, -1, op2),
                                  bop[bn, ar])
        code[i] = torch.where(complete, cw, 0)
        nbits[i] = torch.where(complete, cn, 0)
        opn[i] = torch.where(complete, op2, BIG)

    # ---- end-of-plane flush words of the open bins
    b = torch.arange(17, device=dev)[:, None].expand(17, lanes)
    m_e, l_e, i_e = gm[b], gl[b], gi[b]
    adj = torch.where(bk < i_e, bk, bk + i_e)
    glen = l_e + (bk >= i_e).to(torch.int64)
    run = bk == m_e - 1
    g_code = torch.where(run, 1, bitrev16(adj, glen))
    g_bits = torch.where(run, 1, glen)
    isc = (b >= 1) & (b <= 7)
    bc = torch.clamp(b, max=7)
    fv = flv[(bc * 8 + (bnb & 7)) * 32 + (bk & 31)]
    final = (bk | (torch.where(isc, fv, 0)
                   << torch.where(isc, bnb, 0))) & 31
    c_code = cout[bc * 32 + final]
    c_bits = cobits[bc * 32 + final]
    is_open = (bop >= 0) & (b >= 1)
    code[L:] = torch.where(is_open, torch.where(b >= 8, g_code, c_code), 0)
    nbits[L:] = torch.where(is_open, torch.where(b >= 8, g_bits, c_bits), 0)
    opn[L:] = torch.where(is_open, bop, BIG)
    return code.to(torch.int32), nbits.to(torch.int32), opn.to(torch.int32)


def _check_inputs(valid, ctx, bit):
    for name, t in (("valid", valid), ("ctx", ctx), ("bit", bit)):
        if t.dtype != torch.int32 or t.dim() != 2:
            raise ValueError(f"{name} must be a 2-D int32 tensor (L, lanes)")
        if t.shape != valid.shape or t.device != valid.device:
            raise ValueError(f"{name} must match valid's shape and device")
    if valid.shape[0] + 17 >= BIG:
        raise ValueError("stream too long for the open-index sentinel")


def _launch(entry: str, valid, ctx, bit):
    L, lanes = valid.shape
    dev = valid.device
    args = [t.contiguous() for t in (valid, ctx, bit)]
    outs = [torch.empty((L + 17, lanes), dtype=torch.int32, device=dev)
            for _ in range(3)]
    luts = full_luts(str(dev))
    fn = getattr(kernels.load("full_encode"), entry)
    fn.restype = ctypes.c_int
    runs = kernels.run_slot(dev, entry.removesuffix("_launch"))
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p] * 2
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = fn(*(t.data_ptr() for t in args + outs), luts.data_ptr(),
                    L, lanes, LUT_SIZE, runs, stream)
    kernels.check(status, entry)
    return tuple(outs)


def encode_lanes_full(valid: torch.Tensor, ctx: torch.Tensor,
                      bit: torch.Tensor):
    """Kernel 4: the full state-machine coder over (L, lanes) streams, one
    lane per one-warp block stepping tiles of 32 rows.

    A CUDA tensor launches ``csrc/full_encode.cu``; a CPU tensor runs the
    plain version.  ``ctx`` >= 17 is the uncoded context and ``bit`` is 0
    or 1 (the kernel reads ``bit & 1``).  Returns (code, nbits, open) as
    in the module docstring."""
    _check_inputs(valid, ctx, bit)
    if valid.device.type == "cpu":
        return encode_lanes_full_plain(valid, ctx, bit)
    if valid.device.type != "cuda":
        raise ValueError(f"unsupported device {valid.device}")
    out = _launch("full_encode_launch", valid, ctx, bit)
    encode_lanes_full.launches += 1
    return out


encode_lanes_full.launches = 0


def encode_lanes_full_tiled(valid: torch.Tensor, ctx: torch.Tensor,
                            bit: torch.Tensor):
    """Kernel 5: kernel 4's kernel with the TPU kernel's 8-row tiles (and
    a deeper ring).  Same contract and plain version."""
    _check_inputs(valid, ctx, bit)
    if valid.device.type == "cpu":
        return encode_lanes_full_plain(valid, ctx, bit)
    if valid.device.type != "cuda":
        raise ValueError(f"unsupported device {valid.device}")
    out = _launch("full_encode_tiled_launch", valid, ctx, bit)
    encode_lanes_full_tiled.launches += 1
    return out


encode_lanes_full_tiled.launches = 0


# ---- tail: ordering sort, flush detection, packing ----------------------

def order_and_pack_lanes(code: torch.Tensor, nbits: torch.Tensor,
                         opn: torch.Tensor, max_bits: int):
    """Kernel 4/5 outputs ((L + 17, lanes) each) -> per lane (payload uint8
    (lanes, max_bits // 8), total bits int64, flag bool).  Records are
    ordered by opening emission (the reference's output order); the flag
    marks lanes that need the reorder-window flush or pass ``max_bits``
    (both re-encode on the host)."""
    L = code.shape[0] - 17
    dev = code.device
    rows = torch.arange(L + 17, device=dev)
    done = torch.where(rows < L, rows, BIG)
    nb = nbits.t().to(torch.int64)
    rkey = torch.where(nb > 0, opn.t().to(torch.int64), BIG)
    skey, order = torch.sort(rkey, dim=-1, stable=True)
    rv = skey != BIG
    c2 = torch.gather(code.t().to(torch.int64) & 0xFFFF, -1, order)
    n2 = torch.gather(nb & 31, -1, order)
    flush = detect_flush_records(skey, done[order], rv)
    payload, total, over = pack_records(c2, n2, rv, max_bits)
    return payload, total, flush | over
