"""The port's constant tables and host format layer vs the JAX package's
(the "carry across" check: the codec has no weights, only these tables)."""

import numpy as np
import pytest

from icer_compression_tpu.core import constants as JC
from icer_compression_tpu.core import header as JH
from icer_compression_tpu.core import packets as JP
from icer_compression_tpu.core import partition as JPa
from icer_compression_tpu.core import subbands as JSb
from icer_compression_tpu.models import grayscale as JG
from icer_compression_tpu.ops import decode_lanes as JDL
from icer_compression_tpu.ops import pallas_entropy as JPE
from icer_compression_tpu_torch.core import constants as TC
from icer_compression_tpu_torch.core import header as TH
from icer_compression_tpu_torch.core import packets as TP
from icer_compression_tpu_torch.core import partition as TPa
from icer_compression_tpu_torch.core import subbands as TSb
from icer_compression_tpu_torch.core.status import IcerError, IcerStatus
from icer_compression_tpu_torch.ops import entropy_slim as TES
from icer_compression_tpu_torch.ops import plane_decode as TPD


def _public(mod):
    return {k: v for k, v in vars(mod).items()
            if not k.startswith("_") and isinstance(
                v, (int, str, dict, list, tuple, np.ndarray))}


def test_every_constant_table_matches():
    ref, port = _public(JC), _public(TC)
    assert set(ref) == set(port)
    for name, v in ref.items():
        if isinstance(v, np.ndarray):
            assert v.dtype == port[name].dtype, name
            assert np.array_equal(v, port[name]), name
        else:
            assert v == port[name], name
    assert TC.CIRC_BUF_SIZE == 2048 and TC.CONTEXT_RESCALING_CAP == 500


def test_kernel_luts_match_the_jax_tables():
    # decode: custom refill LUT, golomb parameters, context tables
    for a, b in zip(TPD._build_custom_refill_lut(),
                    JDL._build_custom_refill_lut()):
        assert np.array_equal(a, b)
    lut = TPD._LUT_NP
    assert np.array_equal(lut[TPD.LUT_CUT:TPD.LUT_CUT + 16],
                          JDL._CUT.astype(np.int32))
    for off, ref in ((TPD.LUT_GM, JDL._GOL_M), (TPD.LUT_GL, JDL._GOL_L),
                     (TPD.LUT_GI, JDL._GOL_I)):
        assert np.array_equal(lut[off + 8:off + 17], ref[8:17])
    for off, ref in ((TPD.LUT_LL, JDL._LL), (TPD.LUT_HH, JDL._HH),
                     (TPD.LUT_SCTX, JDL._SCTX), (TPD.LUT_SPRED, JDL._SPRED)):
        assert np.array_equal(lut[off:off + ref.size], ref.reshape(-1))
    # encode: cutoffs, golomb m, completion masks, flush rules
    lut = TES._LUT_NP
    assert lut[TES.LUT_CUT:TES.LUT_CUT + 16].tolist() == JPE._CUT
    assert lut[TES.LUT_GM + 8:TES.LUT_GM + 17].tolist() == \
        [JPE._GOL[b][0] for b in range(8, 17)]
    cinb = lut[TES.LUT_CINB:TES.LUT_CINB + 256].reshape(8, 32)
    flv = lut[TES.LUT_FLV:TES.LUT_FLV + 2048].reshape(8, 8, 32)
    for b in range(1, 8):
        for n in range(6):
            mask = sum(1 << v for v in range(32) if cinb[b, v] == n)
            assert mask == JPE._CMPL[b][n], (b, n)
        for (pv, pn), (av, _an) in JC.CUSTOM_FLUSH_BITS[b].items():
            assert flv[b, pn, pv] == av
        assert (flv[b] != 0).sum() == sum(
            1 for (_p, (av, _a)) in JC.CUSTOM_FLUSH_BITS[b].items() if av)
    # the tables kernel 1's two-word instance and kernels 4/5 build
    # codewords from: golomb l and i, custom output codes and lengths
    for off, k in ((TES.LUT_GL, 1), (TES.LUT_GI, 2)):
        assert lut[off + 8:off + 17].tolist() == \
            [JPE._GOL[b][k] for b in range(8, 17)]
    for off, ref in ((TES.LUT_COUT, JC.CUSTOM_OUT_CODE),
                     (TES.LUT_COBITS, JC.CUSTOM_OUT_BITS)):
        table = lut[off:off + 256].reshape(8, 32)
        assert all(table[b].tolist() == [int(ref[b, v]) for v in range(32)]
                   for b in range(1, 8))


@pytest.mark.parametrize("w,h", [(64, 64), (96, 80), (33, 47), (512, 512),
                                 (17, 129)])
def test_geometry_and_packet_order_match(w, h):
    for stages in range(1, 5):
        if JSb.dim_low(w, stages) < 3 or JSb.dim_low(h, stages) < 3:
            continue
        assert TSb.decode_subband_order(stages) == \
            JSb.decode_subband_order(stages)
        for stage, sb in JSb.decode_subband_order(stages):
            jv = JSb.subband_view(w, h, stage, sb)
            tv = TSb.subband_view(w, h, stage, sb)
            assert (tv.row, tv.col, tv.h, tv.w) == (jv.row, jv.col, jv.h, jv.w)
            for segs in (1, 6, 17):
                try:
                    jr = JPa.partition_segments(jv.w, jv.h, segs)
                except Exception as e:
                    with pytest.raises(IcerError):
                        TPa.partition_segments(tv.w, tv.h, segs)
                    assert e.status == IcerStatus.TOO_MANY_SEGMENTS
                    continue
                tr = TPa.partition_segments(tv.w, tv.h, segs)
                assert [(r.index, r.row, r.col, r.h, r.w) for r in tr] == \
                    [(r.index, r.row, r.col, r.h, r.w) for r in jr]
        for bitplanes in (7, 9):
            jp = JP.sort_packets(JP.build_packets_grayscale(
                w, h, stages, 37, bitplanes))
            tp = TP.sort_packets(TP.build_packets_grayscale(
                w, h, stages, 37, bitplanes))
            assert [(p.decomp_level, p.subband_type, p.lsb, p.priority,
                     p.ll_mean_val) for p in tp] == \
                [(p.decomp_level, p.subband_type, p.lsb, p.priority,
                  p.ll_mean_val) for p in jp]
            assert TP.rearrange_order_grayscale(bitplanes) == \
                JP.rearrange_order_grayscale(bitplanes)


def test_scan_bytestream_matches():
    rng = np.random.default_rng(4)
    img = rng.integers(0, 200, (48, 40)).astype(np.uint16)
    stream = JG.compress(img, JG.CodecConfig(3, 0, 4, 5000))
    garbled = bytearray(b"\x5b\x60junk" + stream + b"tail")
    garbled[200] ^= 0xFF           # corrupt one segment
    for data in (stream, bytes(garbled)):
        for kw in ({}, {"with_offsets": True, "with_payload": False}):
            jf = JH.scan_bytestream(data, **kw)
            tf = TH.scan_bytestream(data, **kw)
            assert len(jf) == len(tf)
            for a, b in zip(jf, tf):
                assert vars(a[0]) == vars(b[0])
                assert a[1:] == b[1:]
    assert TH.crc32(b"123456789") == 0xCBF43926
