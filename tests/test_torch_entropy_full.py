"""Plain kernels 4/5 (full state-machine coder) vs the Pallas kernels in
interpret mode (the plain one and its 8-row tiled variant), on the cases
the CUDA kernels treat apart (a length that is no multiple of their
tiles, compacted valid-first lanes, all-empty lanes and tiles), and the
port's record tail vs the JAX package's (exact, tolerance 0)."""

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


def _pallas(L, tiled=False):
    if tiled:
        return PE.make_encode_lanes_pallas_tiled(L, chunk=80, tile=8,
                                                 interpret=True)
    return PE.make_encode_lanes_pallas(L, chunk=80, interpret=True)


def _run(run, valid, ctx, bit):
    return [np.asarray(x) for x in run(jnp.asarray(valid), jnp.asarray(ctx),
                                       jnp.asarray(bit))]


@pytest.mark.parametrize("case,L,tiled", [
    pytest.param("random", 160, False, id="random-160"),
    pytest.param("golomb", 160, False, id="golomb-160"),
    pytest.param("random", 160, True, id="random-160-tiled"),
    pytest.param("golomb", 160, True, id="golomb-160-tiled"),
])
def test_plain_kernel_and_tail_match_pallas(case, L, tiled):
    """Kernel 4's wrapper against make_encode_lanes_pallas and kernel 5's
    against make_encode_lanes_pallas_tiled (tile 8)."""
    rng = np.random.default_rng(17)
    make = _random_lanes if case == "random" else _golomb_lanes
    valid, ctx, bit = make(rng, L, PE.LANES)
    run = _pallas(L, tiled)
    ref = _run(run, valid, ctx, bit)
    mine, other = ((EF.encode_lanes_full_tiled, EF.encode_lanes_full)
                   if tiled else
                   (EF.encode_lanes_full, EF.encode_lanes_full_tiled))
    out = mine(*_t(valid, ctx, bit))
    for name, a, b in zip(("code", "nbits", "open"), out, ref):
        assert np.array_equal(a.numpy(), b), name
    for a, b in zip(other(*_t(valid, ctx, bit)), out):
        assert a.equal(b)

    # the tail against the JAX package's host post-pass on the same inputs
    # (fed the kernel's outputs above: an interpreted call takes seconds)
    rp, rt, rf = PE.encode_lanes_pallas_full(
        jnp.asarray(valid), jnp.asarray(ctx), jnp.asarray(bit),
        run=lambda *_: ref, host_post=True)
    mb = -(-10 * (L + 17) // 32) * 32
    payload, total, flag = EF.order_and_pack_lanes(*out, mb)
    assert np.array_equal(total.numpy(), np.asarray(rt))
    assert np.array_equal(flag.numpy(), np.asarray(rf))
    for lane in range(PE.LANES):
        nb = int(rt[lane])
        assert np.array_equal(payload[lane, :(nb + 7) // 8].numpy(),
                              np.asarray(rp)[lane, :(nb + 7) // 8]), lane


@pytest.mark.parametrize("tiled", [False, True], ids=["K4", "K5"])
def test_length_off_the_tile_matches_padded_pallas(tiled):
    """L = 200 (no multiple of 64 or of 8) against the JAX kernel at
    L = 240, the 40 rows past 200 invalid: rows below 200 and the 17 flush
    rows agree, and the JAX kernel's padding rows complete nothing."""
    rng = np.random.default_rng(23)
    L, Lp = 200, 240
    valid, ctx, bit = _random_lanes(rng, Lp, PE.LANES)
    valid[L:] = 0
    ref = _run(_pallas(Lp, tiled), valid, ctx, bit)
    fn = EF.encode_lanes_full_tiled if tiled else EF.encode_lanes_full
    out = fn(*_t(valid[:L], ctx[:L], bit[:L]))
    for name, a, b in zip(("code", "nbits", "open"), out, ref):
        a = a.numpy()
        assert a.shape == (L + 17, PE.LANES), name
        assert np.array_equal(a[:L], b[:L]), name
        assert np.array_equal(a[L:], b[Lp:]), name
    assert not ref[1][L:Lp].any()


def test_compacted_lanes_match_pallas():
    """Compacted, valid-first lanes (the ``pallas`` backend's layout) of
    different valid lengths, one of them all-empty, others ending inside
    a tile, against the JAX kernel."""
    rng = np.random.default_rng(29)
    L = 160
    valid, ctx, bit = _random_lanes(rng, L, PE.LANES)
    n = rng.integers(0, L + 1, PE.LANES)
    n[0], n[1], n[2], n[3] = 0, L, 1, 63
    valid = (np.arange(L)[:, None] < n[None, :]).astype(np.int32)
    ref = _run(_pallas(L), valid, ctx, bit)
    for fn in (EF.encode_lanes_full, EF.encode_lanes_full_tiled):
        out = fn(*_t(valid, ctx, bit))
        for name, a, b in zip(("code", "nbits", "open"), out, ref):
            assert np.array_equal(a.numpy(), b), name
    # the all-empty lane completes nothing and flushes nothing
    assert not ref[1][:, 0].any() and (ref[2][:, 0] == EF.BIG).all()


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
