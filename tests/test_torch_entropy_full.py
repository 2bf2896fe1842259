"""Plain kernels 4/5 (full state-machine coder) vs the Pallas kernel in
interpret mode, and the port's record tail vs the JAX package's
(exact, tolerance 0)."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from icer_compression_tpu.ops import pallas_entropy as PE  # noqa: E402
from icer_compression_tpu_torch.ops import entropy_full as EF  # noqa: E402
from icer_compression_tpu_torch.ops import entropy_slim as ES  # noqa: E402
from test_torch_entropy_slim import _eviction_lanes  # noqa: E402
from test_torch_entropy_slim import one_torch_thread  # noqa: E402,F401


def _random_lanes(rng, L, lanes):
    """The random-lane case of the JAX package's full coder test."""
    ctx = rng.integers(0, 18, (L, lanes)).astype(np.int32)
    p = rng.random((18, lanes))
    bit = (rng.random((L, lanes))
           < p[ctx, np.arange(lanes)[None, :]]).astype(np.int32)
    valid = (rng.random((L, lanes)) < 0.9).astype(np.int32)
    return valid, ctx, bit


def _golomb_lanes(rng, L, lanes):
    """All-zero lanes: golomb run splitting and flush tails."""
    z = np.zeros((L, lanes), np.int32)
    return np.ones((L, lanes), np.int32), z, z.copy()


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("case,L", [("random", 160), ("golomb", 160)])
def test_plain_kernel_and_tail_match_pallas(case, L):
    rng = np.random.default_rng(17)
    make = _random_lanes if case == "random" else _golomb_lanes
    valid, ctx, bit = make(rng, L, PE.LANES)
    run = PE.make_encode_lanes_pallas(L, chunk=80, interpret=True)
    ref = [np.asarray(x) for x in run(jnp.asarray(valid), jnp.asarray(ctx),
                                      jnp.asarray(bit))]
    out = EF.encode_lanes_full(*_t(valid, ctx, bit))
    for name, a, b in zip(("code", "nbits", "open"), out, ref):
        assert np.array_equal(a.numpy(), b), name
    assert EF.encode_lanes_full_tiled(*_t(valid, ctx, bit))[0].equal(out[0])

    # the tail against the JAX package's host post-pass on the same inputs
    rp, rt, rf = PE.encode_lanes_pallas_full(
        jnp.asarray(valid), jnp.asarray(ctx), jnp.asarray(bit), run=run,
        host_post=True)
    mb = -(-10 * (L + 17) // 32) * 32
    payload, total, flag = EF.order_and_pack_lanes(*out, mb)
    assert np.array_equal(total.numpy(), np.asarray(rt))
    assert np.array_equal(flag.numpy(), np.asarray(rf))
    for lane in range(PE.LANES):
        nb = int(rt[lane])
        assert np.array_equal(payload[lane, :(nb + 7) // 8].numpy(),
                              np.asarray(rp)[lane, :(nb + 7) // 8]), lane


def test_tail_flags_the_lanes_that_evict():
    """Kernel 4 has no in-kernel eviction: its tail must flag exactly the
    lanes where kernel 1 evicts from the reorder window."""
    rng = np.random.default_rng(5)
    L, lanes = 2432, 128
    valid, ctx, bit = _eviction_lanes(rng, L, lanes)
    out = EF.encode_lanes_full(*_t(valid, ctx, bit))
    mb = ((3 * L // 2 + 170 + 255) // 256) * 256
    _p, _t_, flag = EF.order_and_pack_lanes(*out, mb)
    words = torch.from_numpy(
        PE.pack_emissions(valid, ctx, bit, np).astype(np.int32))
    misc = ES.encode_lanes_slim_plain(words)[2]
    evicts = misc[2].numpy() > 0
    assert evicts.any() and not evicts.all()
    assert np.array_equal(flag.numpy(), evicts)


def test_wrappers_reject_bad_inputs():
    z = torch.zeros((8, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        EF.encode_lanes_full(z, z.to(torch.int64), z)
    with pytest.raises(ValueError):
        EF.encode_lanes_full_tiled(z, z[:4], z)
