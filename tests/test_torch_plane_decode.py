"""Plain kernel 2 (multi-round plane decoder) vs the JAX package's lane
model (decode_lanes, round by round) and its Pallas kernel in interpret
mode (exact, tolerance 0)."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from icer_compression_tpu.backend import sequential as JS  # noqa: E402
from icer_compression_tpu.ops import decode_lanes as DL  # noqa: E402
from icer_compression_tpu.ops import pallas_decode as PD  # noqa: E402
from icer_compression_tpu.ops.context_model import plane_emissions  # noqa: E402
from icer_compression_tpu_torch.ops import plane_decode as TPD  # noqa: E402
from test_torch_entropy_slim import one_torch_thread  # noqa: E402,F401


def _lanes_case(rng, n, Hmax, Wmax, mag_bits, R):
    """Random segments (sparse, zero and dense lanes), every plane encoded
    with the sequential coder into one stream blob.  Returns the decoder
    inputs and the original coefficients."""
    lsb0 = (7 if mag_bits == 7 else 9) - 1
    h = rng.integers(1, Hmax + 1, n).astype(np.int32)
    w = rng.integers(1, Wmax + 1, n).astype(np.int32)
    h[0], w[0] = Hmax, Wmax
    sub = rng.integers(0, 4, n).astype(np.int32)
    blob = bytearray()
    offs = np.full((R, n), -1, np.int64)
    ebits = np.zeros((R, n), np.int64)
    for lane in range(n):
        hi = 1 << mag_bits if mag_bits == 7 else 1 << 10
        mag = rng.integers(0, hi, (h[lane], w[lane]))
        if lane % 3 == 1:
            mag = (mag > hi // 2) * mag
        elif lane % 3 == 2:
            mag = mag >> 5
        full = (mag | (rng.integers(0, 2, mag.shape) << mag_bits)).astype(
            np.int32)
        for r in range(R):
            v, c, b = plane_emissions(full, int(sub[lane]), lsb0 - r,
                                      mag_bits)
            pl, nb, _ = JS.encode_emissions(v, c, b)
            offs[r, lane] = len(blob)
            ebits[r, lane] = nb
            blob += pl
            blob += bytes(rng.integers(0, 256, 3).astype(np.uint8))
    # retirement: a missing middle plane and a stream error (a payload
    # whose frozen length is too short); one lane reads past its payload
    # into the following bytes (the reference's over-read)
    offs[R // 2, 3] = -1
    ebits[1, 5] += 4000
    ebits[2, 6] = 1
    return h, w, sub, bytes(blob), offs, ebits, lsb0


def _torch_inputs(h, w, sub, blob, offs, ebits):
    n = len(h)
    return (torch.from_numpy(np.frombuffer(blob, np.uint8).copy()),
            torch.from_numpy(offs.astype(np.int32)),
            torch.from_numpy(ebits.astype(np.int32)),
            torch.full((n,), len(blob), dtype=torch.int32),
            torch.from_numpy(np.stack([h, w, sub]).astype(np.int32)))


@pytest.mark.parametrize("mag_bits", [7, 15])
def test_plain_kernel_matches_lane_model_round_by_round(mag_bits):
    rng = np.random.default_rng(20 + mag_bits)
    n, Hmax, Wmax, R = 10, 5, 7, 5
    h, w, sub, blob, offs, ebits, lsb0 = _lanes_case(rng, n, Hmax, Wmax,
                                                     mag_bits, R)
    sdata = np.frombuffer(blob, np.uint8)
    seg = np.zeros((Hmax, Wmax, n), np.int32)
    alive = np.ones(n, bool)
    for r in range(R):
        alive &= offs[r] >= 0
        base = np.maximum(offs[r], 0)
        readable = np.where(alive, len(blob) - base, 0)
        data = np.zeros((n, max(int(readable.max()), 8)), np.uint8)
        for lane in range(n):
            data[lane, :readable[lane]] = sdata[base[lane]:]  \
                if alive[lane] else 0
        dec = DL.LaneDecoders(data, readable, ebits[r])
        ok = DL.decode_plane_lanes(seg, h, w, sub,
                                   np.full(n, lsb0 - r, np.int32),
                                   np.full(n, mag_bits, np.int32), dec,
                                   alive)
        alive &= ok
        # the plain kernel over rounds 0..r
        args = _torch_inputs(h, w, sub, blob, offs[:r + 1], ebits[:r + 1])
        out, err, pos = TPD.decode_planes(*args, Hmax, Wmax, lsb0, mag_bits)
        assert np.array_equal(out.numpy().reshape(Hmax, Wmax, n), seg), r
        assert np.array_equal(err.numpy() != 0, ~alive), r
        assert np.array_equal(pos[r].numpy(), dec.pos), r
    assert not alive[3] and not alive[6] and alive.sum() >= 4


def _wavefront_decode(rng, h, w, sub, blob, offs, ebits, Hmax, Wmax, lsb0,
                      mag_bits):
    """Kernel 2's schedule on the plain decoder: each round steps its own
    decoder row by row on one shared canvas, round k taking row r only
    after round k-1 has finished row min(r+1, Hmax-1), in an order drawn
    from ``rng``.  Rounds after a lane's stream error run on; at the end
    they are discarded as the kernel does.  Returns (out, err, pos,
    whether some round ran ahead of its predecessor's last row, whether
    the discard changed the canvas)."""
    stream, o, e, lane_end, geom = _torch_inputs(h, w, sub, blob, offs,
                                                 ebits)
    R, n = offs.shape
    lut = TPD.decode_luts("cpu").to(torch.int64)
    g = geom.to(torch.int64)
    is_hl, is_hh = g[2] == 1, g[2] == 3
    runs = np.array([next((k for k in range(R) if offs[k, j] < 0), R)
                     for j in range(n)])
    seg = torch.zeros((Hmax, Wmax, n), dtype=torch.int64)
    sts, act = [], []
    for k in range(R):
        active = torch.from_numpy(k < runs)
        base = torch.clamp(o[k].to(torch.int64), min=0)
        readable = torch.where(active, lane_end.to(torch.int64) - base, 0)
        sts.append(TPD._Lanes(stream.to(torch.int64), base, readable,
                              e[k].to(torch.int64), lut))
        act.append(active)
    done = [0] * R
    overlapped = False
    while True:
        ready = [k for k in range(R) if done[k] < Hmax and (
            k == 0 or done[k - 1] >= min(done[k] + 2, Hmax))]
        if not ready:
            break
        k = ready[rng.integers(len(ready))]
        overlapped |= k > 0 and done[k - 1] < Hmax
        TPD._decode_plane_plain(seg, sts[k], g[0], g[1], is_hl, is_hh,
                                lsb0 - k, mag_bits, act[k],
                                rows=range(done[k], done[k] + 1))
        done[k] += 1
    assert done == [Hmax] * R

    errs = np.stack([(sts[k].err & act[k]).numpy() for k in range(R)])
    fin = np.where(errs.any(0), errs.argmax(0), runs)
    kk = np.arange(R)[:, None]
    pos = np.where((kk < runs) & (kk <= fin),
                   np.stack([st.pos.numpy() for st in sts]), 0)
    out = seg.numpy()
    raw = out.copy()
    magmask = (1 << mag_bits) - 1
    for j in np.flatnonzero(fin + 1 < runs):
        keep = magmask & ~((1 << (lsb0 - fin[j])) - 1)
        mg = out[:, :, j] & keep
        out[:, :, j] = np.where(mg != 0, mg | (out[:, :, j] & (magmask + 1)),
                                0)
    return (out.reshape(Hmax * Wmax, n), (fin < R).astype(np.int32), pos,
            overlapped, not np.array_equal(raw, out))


@pytest.mark.parametrize("mag_bits", [7, 15])
@pytest.mark.parametrize("seed", [0, 1])
def test_wavefront_order_matches_sequential_rounds(mag_bits, seed):
    """Kernel 2 runs a lane's rounds at once, round k one row behind
    round k-1 plus one; any such interleaving, with the discard rule for
    rounds after a stream error, gives the sequential decoder's out, err
    and pos (the stream error in round 2 of lane 6, the missing middle
    plane of lane 3 and lane 5's over-read included)."""
    rng = np.random.default_rng(50 + mag_bits)
    n, Hmax, Wmax, R = 10, 5, 7, 5
    h, w, sub, blob, offs, ebits, lsb0 = _lanes_case(rng, n, Hmax, Wmax,
                                                     mag_bits, R)
    want = TPD.decode_planes_plain(*_torch_inputs(h, w, sub, blob, offs,
                                                  ebits),
                                   Hmax, Wmax, lsb0, mag_bits)
    out, err, pos, overlapped, discarded = _wavefront_decode(
        np.random.default_rng(seed), h, w, sub, blob, offs, ebits, Hmax,
        Wmax, lsb0, mag_bits)
    assert overlapped and discarded
    assert np.array_equal(out, want[0].numpy())
    assert np.array_equal(err, want[1].numpy())
    assert np.array_equal(pos, want[2].numpy())
    assert err[3] == 1 and err[6] == 1


def test_plain_kernel_matches_pallas_multi_round():
    rng = np.random.default_rng(31)
    n, Hmax, Wmax, R, mag_bits = 12, 3, 8, 3, 7
    h, w, sub, blob, offs, ebits, lsb0 = _lanes_case(rng, n, Hmax, Wmax,
                                                     mag_bits, R)
    out, err, _pos = TPD.decode_planes_plain(
        *_torch_inputs(h, w, sub, blob, offs, ebits), Hmax, Wmax, lsb0,
        mag_bits)

    # the Pallas kernel's inputs: per-round windows covering the whole
    # remainder of the stream (so no window ever clips the over-read)
    lanes = PD.LANES
    NW = max(16, -(-(len(blob) + 8) // 32) * 8)
    sdata = np.frombuffer(blob + bytes(4 * NW), np.uint8)
    words = np.zeros((R, NW, lanes), np.int32)
    geom = np.zeros((R, 8, lanes), np.int32)
    present = np.ones(n, bool)
    for r in range(R):
        present &= offs[r] >= 0
        for lane in range(n):
            if not present[lane]:
                continue
            o = offs[r, lane]
            wb = sdata[o:o + 4 * NW].copy()
            wb[len(blob) - o:] = 0
            words[r, :, lane] = wb.view(np.int32)
        geom[r, 0, :n] = h
        geom[r, 1, :n] = w
        geom[r, 2, :n] = sub
        geom[r, 3] = lsb0 - r
        geom[r, 4] = mag_bits
        geom[r, 5, :n] = present | (0x3FFF << 6)
        geom[r, 6, :n] = ebits[r]
        geom[r, 7, :n] = np.where(present, (len(blob) - np.maximum(
            offs[r], 0)) * 8, 0)
    run = PD.make_decode_plane_pallas(Hmax * Wmax, Wmax, NW, nrounds=R,
                                      interpret=True)
    p_out, p_err, _ = run(jnp.asarray(words.reshape(R * NW, lanes)),
                          jnp.asarray(geom.reshape(R * 8, lanes)))
    p_out = np.asarray(p_out)[:, :n]
    assert np.array_equal(out.numpy(), p_out)
    assert np.array_equal(err.numpy() != 0, np.asarray(p_err)[:n] != 0)


def test_wrapper_checks_inputs():
    s = torch.zeros(16, dtype=torch.uint8)
    o = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError):
        TPD.decode_planes(s, o, o.to(torch.int64), o[0], torch.zeros(
            (3, 3), dtype=torch.int32), 2, 2, 6, 7)
    with pytest.raises(ValueError):
        TPD.decode_planes(s, o, o, o[0], torch.zeros((2, 3),
                          dtype=torch.int32), 2, 2, 6, 7)


@pytest.mark.parametrize("seeded", [False, True])
def test_wrappers_check_the_canvas_placement(seeded):
    s = torch.zeros(16, dtype=torch.uint8)
    o = torch.zeros((1, 3), dtype=torch.int32)
    g = torch.ones((3, 3), dtype=torch.int32)
    with pytest.raises(ValueError):
        if seeded:
            TPD.decode_plane_seeded(s, o[0], o[0], o[0], g,
                                    torch.zeros((4, 3), dtype=torch.int32),
                                    2, 2, 1, 7, _placement="registers")
        else:
            TPD.decode_planes(s, o, o, o[0], g, 2, 2, 1, 7,
                              _placement="registers")


def _seeded_case(rng, kind):
    """The seeded single-plane constructions of the JAX package's Pallas
    decoder tests: planes above ``lsb`` already decoded into the seed
    canvas, one plane to decode per lane (``model``: ragged segments and
    a truncated payload; ``multitile``: two 8-column tiles per row)."""
    n, mag_bits = PD.LANES, 7
    if kind == "model":
        Hmax, Wpad, lsb = 4, 8, 2
        h = rng.integers(1, Hmax + 1, n).astype(np.int32)
        w = rng.integers(1, Wpad + 1, n).astype(np.int32)
    else:
        Hmax, Wpad, lsb = 3, 16, 1
        h = np.full(n, Hmax, np.int32)
        w = rng.integers(9, Wpad + 1, n).astype(np.int32)
    sub = rng.integers(0, 4, n).astype(np.int32)
    full = np.zeros((Hmax, Wpad, n), np.int32)
    for lane in range(n):
        mag = rng.integers(0, 1 << mag_bits, (h[lane], w[lane]))
        if lane % 3 == 1:
            mag = (mag > 64) * mag
        if lane % 3 == 2 and kind == "model":
            mag = np.zeros_like(mag)
        sign = rng.integers(0, 2, (h[lane], w[lane]))
        full[:h[lane], :w[lane], lane] = mag | (sign << mag_bits)
    payloads = []
    for lane in range(n):
        v, c, b = plane_emissions(full[:h[lane], :w[lane], lane],
                                  int(sub[lane]), lsb, mag_bits)
        pl, nb, _ = JS.encode_emissions(v, c, b)
        payloads.append((pl, nb))
    if kind == "model":
        payloads[9] = (payloads[9][0][:1], payloads[9][1])   # truncated
    magmask = (1 << mag_bits) - 1
    seg0 = (full & magmask & ~((1 << (lsb + 1)) - 1)).astype(np.int32)
    seg0 |= np.where((seg0 & magmask) != 0, full & (1 << mag_bits), 0)
    return h, w, sub, payloads, seg0, lsb, mag_bits


@pytest.mark.parametrize("kind", ["model", "multitile"])
def test_plain_seeded_plane_matches_pallas_and_lane_model(kind):
    rng = np.random.default_rng(12345)
    h, w, sub, payloads, seg0, lsb, mag_bits = _seeded_case(rng, kind)
    Hmax, Wpad, n = seg0.shape

    # the lane model and the Pallas kernel on per-lane payload windows
    maxb = max(len(p) for p, _ in payloads) + 8
    data = np.zeros((n, maxb), np.uint8)
    readable = np.array([len(p) for p, _ in payloads], np.int64)
    ebits = np.array([nb for _, nb in payloads], np.int64)
    for lane, (p, _nb) in enumerate(payloads):
        data[lane, :len(p)] = np.frombuffer(bytes(p), np.uint8)
    ref = seg0.copy()
    ok_ref = DL.decode_plane_lanes(
        ref, h, w, sub, np.full(n, lsb, np.int32),
        np.full(n, mag_bits, np.int32), DL.LaneDecoders(data, readable, ebits),
        np.ones(n, bool))
    NW = max(16, ((maxb + 3) // 4 + 7) // 8 * 8)
    wbytes = np.zeros((NW * 4, n), np.uint8)
    wbytes[:maxb] = data.T
    words = np.ascontiguousarray(wbytes.T).view("<u4").view(np.int32).T
    geom8 = np.stack([h, w, sub, np.full(n, lsb), np.full(n, mag_bits),
                      np.ones(n), ebits, readable * 8,
                      ]).astype(np.int32)
    run = PD.make_decode_plane_pallas(Hmax * Wpad, Wpad, NW, interpret=True)
    p_out, p_err, _ = run(jnp.asarray(words), jnp.asarray(geom8),
                          jnp.asarray(seg0.reshape(Hmax * Wpad, n)))

    # the port: every payload in one stream, each lane reading to its end
    blob = b"".join(bytes(p) for p, _ in payloads)
    starts = np.cumsum([0] + [len(p) for p, _ in payloads])
    out, err, pos = TPD.decode_plane_seeded(
        torch.from_numpy(np.frombuffer(blob, np.uint8).copy()),
        torch.from_numpy(starts[:-1].astype(np.int32)),
        torch.from_numpy(ebits.astype(np.int32)),
        torch.from_numpy(starts[1:].astype(np.int32)),
        torch.from_numpy(np.stack([h, w, sub]).astype(np.int32)),
        torch.from_numpy(seg0.reshape(Hmax * Wpad, n)), Hmax, Wpad, lsb,
        mag_bits)
    out = out.numpy()
    assert np.array_equal(out, np.asarray(p_out))
    assert np.array_equal(err.numpy() != 0, np.asarray(p_err) != 0)
    assert np.array_equal(out.reshape(Hmax, Wpad, n), ref)
    assert np.array_equal(err.numpy() != 0, ~ok_ref)


def test_seeded_plane_continues_a_multi_round_decode():
    """Kernel 3 seeded with rounds 0..R-2 of kernel 2 equals kernel 2's R
    rounds; a lane retired before round R-1 gets offs -1 and keeps its
    canvas."""
    rng = np.random.default_rng(41)
    n, Hmax, Wmax, R, mag_bits = 10, 5, 7, 4, 7
    h, w, sub, blob, offs, ebits, lsb0 = _lanes_case(rng, n, Hmax, Wmax,
                                                     mag_bits, R)
    full = TPD.decode_planes(*_torch_inputs(h, w, sub, blob, offs, ebits),
                             Hmax, Wmax, lsb0, mag_bits)
    head = TPD.decode_planes(*_torch_inputs(h, w, sub, blob, offs[:-1],
                                            ebits[:-1]),
                             Hmax, Wmax, lsb0, mag_bits)
    stream, o, e, lane_end, geom = _torch_inputs(h, w, sub, blob, offs,
                                                 ebits)
    last = torch.where(head[1] != 0, -1, o[-1])
    out, err, pos = TPD.decode_plane_seeded(stream, last, e[-1], lane_end,
                                            geom, head[0], Hmax, Wmax,
                                            lsb0 - (R - 1), mag_bits)
    assert torch.equal(out, full[0])
    assert torch.equal((err != 0), (full[1] != 0))
    assert torch.equal(((head[1] != 0) | (err != 0)), (full[1] != 0))
    assert torch.equal(pos, full[2][-1])
    assert bool((head[1] != 0).any())


def test_seeded_wrapper_checks_the_seed():
    s = torch.zeros(16, dtype=torch.uint8)
    o = torch.zeros(3, dtype=torch.int32)
    g = torch.ones((3, 3), dtype=torch.int32)
    with pytest.raises(ValueError):
        TPD.decode_plane_seeded(s, o, o, o, g, torch.zeros(
            (4, 3), dtype=torch.int32), 2, 3, 1, 7)
