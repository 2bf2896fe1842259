"""Plain kernel 1 (slim coder) vs the Pallas kernel in interpret mode, and
its packed payloads vs the sequential reference coder (exact)."""

import os
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from icer_compression_tpu.backend import sequential as JS  # noqa: E402
from icer_compression_tpu.ops import pallas_entropy as PE  # noqa: E402
from icer_compression_tpu_torch.backend import sequential as TS  # noqa: E402
from icer_compression_tpu_torch.core import constants as TC  # noqa: E402
from icer_compression_tpu_torch.ops import entropy_slim as ES  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain kernels launch thousands of tiny ops per call: beside the
    other test workers, torch's default per-process thread pool
    oversubscribes the cores and every op waits on it, so the port's
    tests run torch on one thread (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _random_lanes(rng, L, lanes):
    """The random-lane case of the JAX package's slim coder test."""
    ctx = rng.integers(0, 18, (L, lanes)).astype(np.int32)
    p = rng.random((18, lanes))
    bit = (rng.random((L, lanes))
           < p[ctx, np.arange(lanes)[None, :]]).astype(np.int32)
    valid = (rng.random((L, lanes)) < 0.9).astype(np.int32)
    valid[:, -4:] = 1
    ctx[:, -4:] = 0
    bit[:, -4:] = 0
    return valid, ctx, bit


def _eviction_lanes(rng, L, lanes):
    """The reorder-window eviction case: a golomb run held open while
    uncoded codewords allocate behind it."""
    warm = 64
    n_unc = np.arange(lanes) * 17 + 90
    valid = np.ones((L, lanes), np.int32)
    ctx = np.full((L, lanes), 17, np.int32)
    bit = rng.integers(0, 2, (L, lanes)).astype(np.int32)
    ctx[:warm] = 0
    bit[:warm] = 0
    mask = np.arange(L - warm)[:, None] >= n_unc[None, :]
    valid[warm:] = np.where(mask, 0, 1)
    return valid, ctx, bit


def _noisy_overflow_lanes(rng, L, lanes, warm=3072, feed=144):
    """Skewed contexts warmed up into many bins, then uncoded emissions
    with one zero fed to each context in turn every 16 * ``feed`` steps:
    every feed opens a codeword that the reorder window evicts later, so
    lanes collect more than NEV evictions and must raise the flag."""
    p = np.exp(rng.uniform(np.log(0.003), np.log(0.2), (16, lanes)))
    ctx = np.full((L, lanes), 17)
    bit = rng.integers(0, 2, (L, lanes))
    wc = rng.integers(0, 16, (warm, lanes))
    ctx[:warm] = wc
    bit[:warm] = rng.random((warm, lanes)) < p[wc, np.arange(lanes)]
    t = np.arange(L - warm)[:, None]
    fed = (t % feed) == 0
    ctx[warm:] = np.where(fed, (t // feed) % 16, 17)
    bit[warm:] = np.where(fed, 0, bit[warm:])
    return (np.ones((L, lanes), np.int32), ctx.astype(np.int32),
            bit.astype(np.int32))


def _worst_eviction_lanes(rng, L, lanes):
    """Lanes near the eviction bound: the 16 coded contexts warmed up to a
    zero share in the middle of bins 1-16 (a fixed pattern of bits), then
    uncoded emissions, and every CIRC_BUF_SIZE + 16 steps one bit to each
    context, chosen from its counters so that it opens a codeword that
    stays open (a golomb zero run, a custom prefix that does not
    complete); the window evicts each of them later."""
    ctx = np.full((L, lanes), 17)
    bit = rng.integers(0, 2, (L, lanes))
    cut = np.asarray(TC.BIN_PROBABILITY_CUTOFFS, np.float64) / 65536
    share = np.append((cut[:15] + cut[1:16]) / 2, 0.9995)
    warm = 16 * 480
    ctx[:warm] = (np.arange(warm) % 16)[:, None]
    n, one = np.arange(warm) // 16, 1 - share[ctx[:warm, 0]]
    bit[:warm] = (np.floor((n + 1) * one) > np.floor(n * one))[:, None]
    period = TC.CIRC_BUF_SIZE + 16
    for j in range(lanes):
        cnt = TS.ContextCounters()
        for i in range(warm):
            cnt.update(int(ctx[i, j]), int(bit[i, j]))
        for start in range(warm, L - 16, period):
            for c in range(16):
                z, t = cnt.zero[c], cnt.total[c]
                inv = z < (t >> 1)
                b = TS.compute_bin(t - z if inv else z, t)
                cb = int(1 <= b <= 7 and int(TC.CUSTOM_IN_BITS[b, 0]) == 1)
                ctx[start + c, j] = c
                bit[start + c, j] = cb ^ int(inv)
                cnt.update(c, int(bit[start + c, j]))
    return (np.ones((L, lanes), np.int32), ctx.astype(np.int32),
            bit.astype(np.int32))


@pytest.mark.parametrize("case,L,chunk,two_word", [
    pytest.param("random", 256, 64, False, id="random-256-64"),
    pytest.param("eviction", 2432, 128, False, id="eviction-2432-128"),
    pytest.param("random", 256, 64, True, id="random-256-64-two_word"),
    pytest.param("eviction", 2432, 128, True,
                 id="eviction-2432-128-two_word")])
def test_plain_kernel_matches_pallas_and_sequential(case, L, chunk,
                                                    two_word):
    """Both record modes: the plain version output for output against the
    Pallas kernel (``fused_key`` as the mode; the two-word mode's extra
    full-width open ordinals equal the 17-bit field of its final state
    here), its sort operands against the JAX package's, its packed lanes
    against the sequential coder."""
    rng = np.random.default_rng(11)
    lanes = 128
    make = _random_lanes if case == "random" else _eviction_lanes
    valid, ctx, bit = make(rng, L, lanes)
    words = PE.pack_emissions(valid, ctx, bit, np).astype(np.int32)

    run = PE.make_encode_lanes_slim(L, chunk=chunk, interpret=True,
                                    lanes=lanes, fused_key=not two_word)
    with jax.default_device(jax.devices("cpu")[0]):
        ref = [np.asarray(x) for x in run(jnp.asarray(words))]
        j = [jnp.asarray(x) for x in ref]
        if two_word:
            ref_ops = [np.asarray(x) for x in PE.slim_sort_operands(
                *j[:3], jnp, j[4], j[5])]
        else:
            ref_ops = [np.asarray(PE.slim_sort_operand_packed(
                j[0], j[1], j[3], jnp))]
    out = ES.encode_lanes_slim_plain(torch.from_numpy(words),
                                     two_word=two_word)
    names = (("rec1", "rec2", "fstate", "misc", "ev1", "ev2") if two_word
             else ("rec", "fstate", "misc", "ev"))
    assert len(out) == len(ref) + two_word and len(ref) == len(names)
    for name, a, b in zip(names, out, ref):
        assert np.array_equal(a.numpy(), b), name
    misc = out[names.index("misc")]
    if two_word:
        assert torch.equal(out[6], out[2] & 0x1FFFF)
        ops = ES.slim_sort_operands(*out[:3], out[6], out[4], out[5])
    else:
        ops = (ES.slim_sort_operand_packed(*out[:2], out[3]),)
    for a, b in zip(ops, ref_ops):
        assert np.array_equal(a.numpy(), b)
    if case == "eviction":
        assert misc[2].max() >= 1 and not misc[0].any()

    mb = ((3 * L // 2 + 170 + 255) // 256) * 256
    if two_word:
        payload, total, over = ES.order_and_pack_lanes_two_word(
            *ops, mb, ops[0].shape[0])
    else:
        payload, total, over = ES.order_and_pack_lanes(ops[0], mb,
                                                       ops[0].shape[0])
    for lane in range(lanes):
        seq = TS.encode_emissions(valid[:, lane] != 0, ctx[:, lane],
                                  bit[:, lane])
        assert seq == JS.encode_emissions(valid[:, lane] != 0, ctx[:, lane],
                                          bit[:, lane])
        assert int(misc[2, lane]) == seq[2]
        assert not bool(over[lane])
        nb = int(total[lane])
        assert (bytes(payload[lane, :(nb + 7) // 8].numpy()), nb) \
            == seq[:2], lane


def test_side_buffer_overflow_flags_fallback():
    rng = np.random.default_rng(5)
    L, lanes = 16384, 6
    valid, ctx, bit = _noisy_overflow_lanes(rng, L, lanes)
    words = torch.from_numpy(
        PE.pack_emissions(valid, ctx, bit, np).astype(np.int32))
    rec, fstate, misc, ev = ES.encode_lanes_slim(words)
    flagged = misc[0].numpy() != 0
    assert flagged.any()
    for lane in range(lanes):
        _pl, _nb, nflush = TS.encode_emissions(valid[:, lane] != 0,
                                               ctx[:, lane], bit[:, lane])
        assert int(misc[2, lane]) == nflush
        assert flagged[lane] == (nflush > ES.NEV)


def test_two_word_side_buffer_overflow_flags_fallback():
    """The two-word instance with the TPU kernel's 32 side-buffer rows:
    lanes past them raise the flag, and every output the overflow leaves
    in place (the records, the final state, the open ordinals, the
    allocation and eviction counts, the 32 rows) equals the run with the
    buffer the encoder sizes."""
    rng = np.random.default_rng(5)
    L, lanes = 16384, 6
    valid, ctx, bit = _noisy_overflow_lanes(rng, L, lanes)
    words = torch.from_numpy(
        PE.pack_emissions(valid, ctx, bit, np).astype(np.int32))
    small = ES.encode_lanes_slim_two_word(words, ES.NEV)
    sized = ES.encode_lanes_slim_two_word(words, ES.eviction_rows(L))
    rec1, rec2, fstate, misc, ev1, ev2, fopen = small
    assert ev1.shape == ev2.shape == (ES.NEV, lanes)
    flagged = misc[0].numpy() != 0
    assert flagged.any() and not sized[3][0].any()
    for a, b in zip((rec1, rec2, fstate, misc[1:], ev1, ev2, fopen),
                    (*sized[:3], sized[3][1:], sized[4][:ES.NEV],
                     sized[5][:ES.NEV], sized[6])):
        assert torch.equal(a, b)
    for lane in range(lanes):
        _pl, _nb, nflush = TS.encode_emissions(valid[:, lane] != 0,
                                               ctx[:, lane], bit[:, lane])
        assert int(misc[2, lane]) == nflush
        assert flagged[lane] == (nflush > ES.NEV)


def test_two_word_lanes_past_the_fused_key_limit():
    """L = 33,024 (past the fused-key limit), in the two-word mode with
    the side buffer the encoder sizes (``eviction_rows``).
    chip_smoke.py's long block (allocation ordinals past
    2**15, evictions in two of its three lanes) and a noisy lane past the
    TPU kernel's 32 rows: every lane's packed payload equals the
    sequential coder's, and none is flagged for the host."""
    sys.path.insert(0, REPO)
    import chip_smoke
    L = 33024
    assert not ES.fused_key_ok(L)
    noisy = _noisy_overflow_lanes(np.random.default_rng(3), L, 1)
    words = torch.cat([chip_smoke.long_ordinal_words(
        np.random.default_rng(3), L), torch.from_numpy(
            PE.pack_emissions(*noisy, np).astype(np.int32))], dim=1)
    valid, ctx, bit = (((words >> s) & m).numpy()
                       for s, m in ((0, 1), (1, 31), (6, 1)))
    rec1, rec2, fstate, misc, ev1, ev2, fopen = \
        ES.encode_lanes_slim_two_word(words, ES.eviction_rows(L))
    ops, keys = ES.slim_sort_operands(rec1, rec2, fstate, fopen, ev1, ev2)
    payload, total, over = ES.order_and_pack_lanes_two_word(
        ops, keys, ((2 * L + 170 + 255) // 256) * 256, ops.shape[0])
    for lane in range(4):
        seq = TS.encode_emissions(valid[:, lane] != 0, ctx[:, lane],
                                  bit[:, lane])
        assert int(misc[2, lane]) == seq[2]
        assert (seq[2] > ES.NEV) == (lane == 3)
        assert not bool(misc[0, lane])
        nb = int(total[lane])
        assert (bytes(payload[lane, :(nb + 7) // 8].numpy()), nb) \
            == seq[:2], lane
        if lane == 3:
            continue
        assert int(misc[1, lane]) > 1 << 15
        assert lane == 0 or seq[2] > 0
        assert int(torch.where(rec1[:, lane] != 0, rec2[:, lane], 0).max()) \
            > 1 << 15
        assert not bool(over[lane])


@pytest.mark.parametrize("make,lanes", [(_noisy_overflow_lanes, 6),
                                        (_worst_eviction_lanes, 2)],
                         ids=["noisy", "worst"])
def test_two_word_codes_lanes_past_the_side_buffer(make, lanes):
    """L = 16,384 with a side buffer of ``eviction_rows(L)``: lanes with
    more than the TPU kernel's 32 evictions are coded, not flagged (the
    plain version's packed payloads equal the sequential coder's), and
    every lane's eviction count stays within the bound 16 * (allocations
    // 2048 + 1) that sizes the buffer; on the worst-case lanes it reaches
    more than half of it."""
    L = 16384
    valid, ctx, bit = make(np.random.default_rng(5), L, lanes)
    words = torch.from_numpy(
        PE.pack_emissions(valid, ctx, bit, np).astype(np.int32))
    rec1, rec2, fstate, misc, ev1, ev2, fopen = \
        ES.encode_lanes_slim_two_word(words, ES.eviction_rows(L))
    ops, keys = ES.slim_sort_operands(rec1, rec2, fstate, fopen, ev1, ev2)
    payload, total, over = ES.order_and_pack_lanes_two_word(
        ops, keys, ((2 * L + 170 + 255) // 256) * 256, ops.shape[0])
    assert int(misc[2].max()) > ES.NEV and not misc[0].any()
    for lane in range(lanes):
        seq = TS.encode_emissions(valid[:, lane] != 0, ctx[:, lane],
                                  bit[:, lane])
        ec, alloc = int(misc[2, lane]), int(misc[1, lane])
        assert ec == seq[2] <= 16 * (alloc // TC.CIRC_BUF_SIZE + 1) \
            <= ES.eviction_rows(L)
        if make is _worst_eviction_lanes:
            assert 2 * ec > 16 * (alloc // TC.CIRC_BUF_SIZE + 1)
        assert not bool(over[lane])
        nb = int(total[lane])
        assert (bytes(payload[lane, :(nb + 7) // 8].numpy()), nb) \
            == seq[:2], lane


def test_sort_operands_read_the_full_width_open_ordinal():
    """The end-of-plane flush rows take their keys from ``fopen``, past
    2**17, and their codewords from fstate's k and nb fields; closed bins
    and bin 0 give BIG."""
    lanes = 2
    fopen = torch.zeros((17, lanes), dtype=torch.int32)
    fopen[9, 0] = (1 << 17) + 5           # golomb bin 9, k = 3
    fopen[3, 1] = (1 << 20) + 1           # custom bin 3, prefix 1 of 1 bit
    fstate = fopen & 0x1FFFF
    fstate[9, 0] |= 3 << 17
    fstate[3, 1] |= (1 << 17) | (1 << 27)
    empty = torch.zeros((0, lanes), dtype=torch.int32)
    ev1 = torch.zeros((4, lanes), dtype=torch.int32)
    ev2 = torch.full((4, lanes), ES.BIG, dtype=torch.int32)
    ops, keys = ES.slim_sort_operands(empty, empty, fstate, fopen, ev1, ev2)
    want = torch.full((21, lanes), ES.BIG, dtype=torch.int32)
    want[9, 0], want[3, 1] = (1 << 17) + 4, 1 << 20
    assert torch.equal(keys, want)
    b = torch.tensor([9, 3])
    code, nbits = ES._flush_code(b, torch.tensor([3, 1]), torch.tensor([0, 1]))
    for lane, row in ((0, 9), (1, 3)):
        assert int(ops[row, lane]) == (1 | int(code[lane]) << 1
                                       | int(nbits[lane]) << 17 | 1 << 22)
    assert int((ops != 0).sum()) == 2


def test_wrapper_rejects_bad_shapes():
    """Lengths off the chunk, the fused-key limit, and a two-word side
    buffer of no rows are refused; the two-word mode has no length limit
    of its own (``code_lanes_slim`` codes 2**17 slots and more)."""
    with pytest.raises(ValueError):
        ES.encode_lanes_slim(torch.zeros((100, 4), dtype=torch.int32))
    with pytest.raises(ValueError):
        ES.encode_lanes_slim(torch.zeros((1 << 15, 1), dtype=torch.int32))
    with pytest.raises(ValueError):
        ES.encode_lanes_slim_two_word(torch.zeros((100, 1),
                                                  dtype=torch.int32))
    with pytest.raises(ValueError):
        ES.encode_lanes_slim_two_word(torch.zeros((256, 1),
                                                  dtype=torch.int32), nev=0)
    assert ES.eviction_rows(1 << 17) == 16 * 65


@pytest.mark.parametrize("words", [
    torch.zeros((256, 4), dtype=torch.int64),
    torch.zeros(256, dtype=torch.int32)], ids=["int64", "1-D"])
def test_wrapper_rejects_a_bad_dtype_or_rank(words):
    with pytest.raises(ValueError):
        ES.encode_lanes_slim(words)


def _zero_context_lanes(L=16384, lanes=4):
    """Uncoded emissions with a zero fed to context 16 every 150, 400,
    1,000 and 97 steps by lane: context 16 codes only zeros, so it skews
    into golomb bins whose runs stay open until the reorder window evicts
    them; the last lane stops half way."""
    rng = np.random.default_rng(23)
    t = np.arange(L)[:, None]
    fed = t % np.array([[150, 400, 1000, 97]]) == 0
    ctx = np.where(fed, 16, 17)
    bit = np.where(fed, 0, rng.integers(0, 2, (L, lanes)))
    valid = np.ones((L, lanes), bool)
    valid[L // 2:, 3] = False
    words = np.where(valid, 1 | (ctx << 1) | (bit << 6), 0)
    return torch.from_numpy(words.astype(np.int32))


@pytest.mark.parametrize("two_word", [False, True])
def test_valid_records_take_every_ordinal_once(two_word):
    """The property the sort-and-pack kernel (``csrc/slim_pack.cu``) rests
    on: in every lane the allocation ordinals of the valid records (the
    completions, the evictions and the end-of-plane flushes) are exactly
    0 .. misc[1] - 1, each once, so each record can be written to its slot
    without a sort.  A lane with more than ``slice_to`` allocations sets
    the sort-based tail's flag."""
    words = _zero_context_lanes()
    L, lanes = words.shape
    slice_to = 3 * L // 4
    if two_word:
        rec1, rec2, fstate, misc, ev1, ev2, fopen = \
            ES.encode_lanes_slim_plain(words, True, ES.eviction_rows(L))
        ops, keys = ES.slim_sort_operands(rec1, rec2, fstate, fopen, ev1,
                                          ev2)
        ords = [keys[:, j][keys[:, j] != ES.BIG] for j in range(lanes)]
        over = ES.order_and_pack_lanes_two_word(ops, keys, 2 * L,
                                                slice_to)[2]
    else:
        rec, fstate, misc, ev = ES.encode_lanes_slim_plain(words)
        ops = ES.slim_sort_operand_packed(rec, fstate, ev)
        keys = ops >> 16
        ords = [keys[:, j][keys[:, j] != ES.BIG15] for j in range(lanes)]
        over = ES.order_and_pack_lanes(ops, 2 * L, slice_to)[2]
    assert not misc[0].any() and bool((misc[2] >= 4).all())
    for j in range(lanes):
        assert torch.equal(torch.sort(ords[j].to(torch.int64)).values,
                           torch.arange(int(misc[1, j]))), j
    cut = misc[1] > slice_to
    assert 0 < int(cut.sum()) < lanes
    assert bool(over[cut].all())
