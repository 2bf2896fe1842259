"""The port's sort-centric coder (the ``sorted`` backend) vs the JAX
package's ``entropy_jax2.encode_emissions_sorted`` run with numpy, lane by
lane (exact: payload, total bits and flush flag)."""

import numpy as np
import pytest
import torch

from icer_compression_tpu.backend import sequential as JS
from icer_compression_tpu.ops import entropy_jax2 as E2
from icer_compression_tpu_torch.ops import entropy_sorted as SO
from test_torch_entropy_slim import one_torch_thread  # noqa: F401


def _random_lanes(rng, L, lanes):
    ctx = rng.integers(0, 18, (lanes, L)).astype(np.int32)
    p = rng.random((lanes, 18))
    bit = (rng.random((lanes, L))
           < p[np.arange(lanes)[:, None], ctx]).astype(np.int32)
    valid = (rng.random((lanes, L)) < 0.9).astype(np.int32)
    return valid, ctx, bit


def _golomb_lanes(rng, L, lanes):
    """Long zero runs in one or two contexts, with sparse ones."""
    ctx = rng.integers(0, 2, (lanes, L)).astype(np.int32)
    bit = (rng.random((lanes, L)) < 0.01).astype(np.int32)
    return np.ones((lanes, L), np.int32), ctx, bit


def _flush_lanes(rng, L, lanes):
    """A golomb run held open while uncoded codewords allocate behind it:
    lanes past ~2048 allocations need the reorder-window flush."""
    warm = 64
    n_unc = np.arange(lanes) * 170 + 1700
    valid = np.ones((lanes, L), np.int32)
    ctx = np.full((lanes, L), 17, np.int32)
    bit = rng.integers(0, 2, (lanes, L)).astype(np.int32)
    ctx[:, :warm] = 0
    bit[:, :warm] = 0
    valid[:, warm:] = np.arange(L - warm)[None, :] < n_unc[:, None]
    return valid, ctx, bit


@pytest.mark.parametrize("case,L,lanes", [("random", 700, 6),
                                          ("golomb", 1500, 4),
                                          ("flush", 2432, 5)])
def test_sorted_coder_matches_jax_package(case, L, lanes):
    rng = np.random.default_rng(23)
    make = {"random": _random_lanes, "golomb": _golomb_lanes,
            "flush": _flush_lanes}[case]
    valid, ctx, bit = make(rng, L, lanes)
    mb = -(-(10 * L) // 32) * 32
    payload, total, flag = SO.encode_emissions_sorted(
        *(torch.from_numpy(a) for a in (valid, ctx, bit)), max_bits=mb)
    flags = []
    for lane in range(lanes):
        rp, rt, rf = E2.encode_emissions_sorted(valid[lane], ctx[lane],
                                                bit[lane], np, max_bits=mb)
        assert int(total[lane]) == int(rt), lane
        assert bool(flag[lane]) == bool(rf), lane
        assert np.array_equal(payload[lane].numpy(), np.asarray(rp)), lane
        flags.append(bool(rf))
        if not rf:
            seq = JS.encode_emissions(valid[lane] != 0, ctx[lane], bit[lane])
            nb = int(rt)
            assert (bytes(payload[lane, :(nb + 7) // 8].numpy()), nb) \
                == seq[:2], lane
    if case == "flush":
        assert any(flags) and not all(flags)
