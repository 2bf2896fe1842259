"""Port's emission words vs the JAX package's plane_emissions_words."""

import numpy as np
import pytest
import torch

from icer_compression_tpu.core import constants as JC
from icer_compression_tpu.ops import context_model as JCM
from icer_compression_tpu_torch.ops import context_model as TCM


@pytest.mark.parametrize("mag_bits", [7, 15])
def test_plane_emissions_words_match(mag_bits):
    rng = np.random.default_rng(mag_bits)
    n, h, w = 12, 9, 13
    mag = rng.integers(0, 1 << mag_bits, (n, h, w))
    mag = np.where(rng.random((n, h, w)) < 0.3, mag >> 4, mag)
    sign = rng.integers(0, 2, (n, h, w))
    seg = (mag | (sign << mag_bits)).astype(np.int32)
    sub = (np.arange(n) % 4).astype(np.int32)
    pv = np.ones((n, h, w), np.int32)
    pv[::3, 6:, :] = 0
    pv[1::3, :, 10:] = 0
    seg = seg * pv
    for lsb in range(0, JC.BITPLANES_8 if mag_bits == 7 else JC.BITPLANES_16):
        r0, r1 = JCM.plane_emissions_words(seg, sub, pv, lsb, mag_bits, np)
        t0, t1 = TCM.plane_emissions_words(torch.from_numpy(seg),
                                           torch.from_numpy(sub),
                                           torch.from_numpy(pv), lsb,
                                           mag_bits)
        assert np.array_equal(t0.numpy(), np.asarray(r0)), lsb
        assert np.array_equal(t1.numpy(), np.asarray(r1)), lsb


def test_closed_forms_match_tables():
    h, v, d = np.meshgrid(np.arange(3), np.arange(3), np.arange(5),
                          indexing="ij")
    t = torch.from_numpy
    assert np.array_equal(TCM._ctx_ll(t(h), t(v), t(d)).numpy(),
                          JC.CONTEXT_TABLE_LL_LH_HL[h, v, d])
    s, d = np.meshgrid(np.arange(5), np.arange(5), indexing="ij")
    assert np.array_equal(TCM._ctx_hh(t(s), t(d)).numpy(),
                          JC.CONTEXT_TABLE_HH[s, d])
    sctx, pred = TCM._sign_ctx(t(s), t(d))
    assert np.array_equal(sctx.numpy(), JC.SIGN_CONTEXT_TABLE[s, d])
    assert np.array_equal(pred.numpy(), JC.SIGN_PREDICTION_TABLE[s, d])
