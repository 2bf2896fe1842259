"""First-use check of a freshly built kernel library.

Counterpart: ``icer_compression_tpu/backend/aot_cache.py``
(``_first_exec_check`` and the rebuild-once rule of ``_load_or_compile``).
``kernels.build_all`` calls ``check_library`` on every library it has just
compiled, before the library takes its final name: each kernel instance
the library holds runs once on a small fixed input, made from a seed with
numpy, and its outputs must equal the plain PyTorch version's on CPU copies
of the same input, at tolerance 0.  The inputs are small (coder blocks of
256 steps x 8 lanes, one 16x11 decode unit of 4 lanes and 9 rounds), so
the check costs seconds, mostly the plain versions on the host.  Kernel
1's two-word instance also runs on a block of 133,120 steps whose
allocation ordinals pass 2**17 and whose evictions pass 32 rows, with the
side buffer the encoder sizes; its plain version takes a minute there, so
its outputs are held to pinned digests of the plain version's
(``WIDE_DIGESTS``, which the CPU tests recompute).  Kernel W1 (one pass of
the inverse DWT) runs on seeded pairs of canvases, on both axes of stage
blocks smaller than the canvas, at every filter, both sample widths and
lines of 2-9 samples.  The stage marks (``utils/trace``) run once per
stage, stage S S + 1 times, into a count per stage.  Sort and pack (both
record modes) runs on the plain kernel 1's outputs for a block of 2,560
steps whose lanes pass 2,048 ordinals and evict, uncut and with a slice
and a payload cap that flag some lanes each, against the sort-based plain
version.

This module imports the kernel wrappers, which import ``kernels``; it is
imported lazily by ``kernels.build_all`` for that reason.
"""

from __future__ import annotations

import functools
import hashlib
from dataclasses import dataclass
from collections.abc import Callable

import numpy as np
import torch

from . import kernels
from .ops import entropy_full as EF
from .ops import entropy_slim as ES
from .ops import plane_decode as PD
from .ops import wavelet as WV
from .utils import trace

SEED = 20261017
L, LANES = 256, 8                 # coder check blocks
WIDE_L = 133120                   # the two-word block past 2**17 ordinals
PACK_L = 2560                     # the sort-and-pack block
# (payload cap bits, slice) of the sort-and-pack check: every record kept,
# then cuts that flag some lanes by their allocations (past 2,170) and
# others by their bits (past 2,048)
PACK_CUTS = ((8192, PACK_L + 17 + 32), (2048, 2170))
UNIT_H, UNIT_W = 32, 22           # one stage: four 16x11 subbands
UNIT_QUOTA = 1600                 # cuts the stream inside its last plane
W1_CANVAS = (2, 11, 12)           # two canvases larger than every block
W1_LENGTHS = range(2, 10)
W1_FILTERS = range(7)             # A-F, Q


class KernelMismatch(RuntimeError):
    """A kernel instance's output differs from its plain version's."""


@dataclass(frozen=True)
class Instance:
    label: str                    # the kernel and its mode
    symbol: str                   # the library's launch function
    outputs: tuple[str, ...]
    run: Callable                 # device -> tuple of output tensors
    pinned: dict | None = None    # the plain version's output digests


@functools.lru_cache(maxsize=None)
def coder_words() -> torch.Tensor:
    """(L, LANES) int32 emission words (valid | ctx << 1 | bit << 6):
    skewed adaptive contexts mixed with uncoded emissions and invalid
    steps, a few lanes empty past random lengths."""
    rng = np.random.default_rng(SEED)
    p = np.exp(rng.uniform(np.log(0.01), np.log(0.5), (17, LANES)))
    ctx = np.where(rng.random((L, LANES)) < 0.2, 17,
                   rng.integers(0, 17, (L, LANES)))
    bit = rng.random((L, LANES)) < np.where(
        ctx < 17, p[np.minimum(ctx, 16), np.arange(LANES)], 0.5)
    valid = rng.random((L, LANES)) < 0.85
    valid &= np.arange(L)[:, None] < rng.integers(L // 2, L + 1, LANES)
    valid[:, 0] = False
    words = np.where(valid, 1 | (ctx << 1) | (bit << 6), 0)
    return torch.from_numpy(words.astype(np.int32))


@functools.lru_cache(maxsize=None)
def decode_unit():
    """(blob, unit) of one decode unit: a seeded 32x22 uint16 image encoded
    at one stage and one segment (four lanes of 16x11, nine rounds) by the
    port on the host, cut by a byte quota inside its last planes."""
    from .models import decode as D
    from .models import grayscale as T
    rng = np.random.default_rng(SEED)
    ramp = np.add.outer(np.arange(UNIT_H) * 9, np.arange(UNIT_W) * 5)
    img = (ramp + rng.integers(0, 48, ramp.shape)).astype(np.uint16)
    cfg = T.CodecConfig(1, 0, 1, UNIT_QUOTA)
    stream = T.compress(img, cfg, device="cpu")
    _w, _h, _ll, blob, units = D.plan_batch([stream], cfg, np.uint16)
    (unit,) = units
    return blob, unit


def _unit_args(dev):
    blob, u = decode_unit()
    return [torch.as_tensor(blob).to(dev)] + [
        torch.as_tensor(u[k]).to(dev)
        for k in ("offs", "ebits", "lane_end", "geom")]


def _k1(dev):
    return ES.encode_lanes_slim(coder_words().to(dev))


def _k1_two_word(dev):
    return ES.encode_lanes_slim_two_word(coder_words().to(dev))


@functools.lru_cache(maxsize=None)
def wide_words() -> torch.Tensor:
    """(WIDE_L, 2) int32 emission words whose allocation ordinals pass
    2**17 and whose evictions pass 32 rows: uncoded emissions (each one
    allocates a codeword), and a zero fed every 150 (400) steps to one
    (one of two) coded contexts, which skew into golomb bins whose runs
    stay open until the reorder window evicts them."""
    rng = np.random.default_rng(SEED)
    t = np.arange(WIDE_L)[:, None]
    feed = np.array([[150, 400]])
    fed = t % feed == 0
    ctx = np.where(fed, (t // feed) % np.array([[1, 2]]), 17)
    bit = np.where(fed, 0, rng.integers(0, 2, (WIDE_L, 2)))
    return torch.from_numpy((1 | (ctx << 1) | (bit << 6)).astype(np.int32))


def _k1_wide(dev):
    return ES.encode_lanes_slim_two_word(wide_words().to(dev),
                                         ES.eviction_rows(WIDE_L))


@functools.lru_cache(maxsize=None)
def pack_words() -> torch.Tensor:
    """(PACK_L, LANES) int32 emission words for the sort-and-pack check:
    skewed contexts warmed up into many bins, then uncoded emissions with a
    zero fed to each context in turn (every 4 to 64 steps by lane), so that
    lanes pass one block's 2,048 ordinals and the reorder window evicts up
    to a few codewords a lane; lane 0 empty, lane 7 cut short."""
    rng = np.random.default_rng(SEED)
    warm = 384
    p = np.exp(rng.uniform(np.log(0.003), np.log(0.2), (16, LANES)))
    ctx = np.full((PACK_L, LANES), 17)
    bit = rng.integers(0, 2, (PACK_L, LANES))
    wc = rng.integers(0, 16, (warm, LANES))
    ctx[:warm] = wc
    bit[:warm] = rng.random((warm, LANES)) < p[wc, np.arange(LANES)]
    t = np.arange(PACK_L - warm)[:, None]
    feed = np.array([[8, 4, 16, 32, 8, 64, 12, 6]])
    fed = t % feed == 0
    ctx[warm:] = np.where(fed, (t // feed) % 16, 17)
    bit[warm:] = np.where(fed, 0, bit[warm:])
    valid = np.ones((PACK_L, LANES), bool)
    valid[:, 0] = False
    valid[1500:, 7] = False
    words = np.where(valid, 1 | (ctx << 1) | (bit << 6), 0)
    return torch.from_numpy(words.astype(np.int32))


@functools.lru_cache(maxsize=None)
def _pack_records(two_word: bool) -> tuple:
    """Kernel 1's outputs on ``pack_words``, from its plain version (so the
    check of the sort-and-pack library needs no other library)."""
    w = pack_words()
    if two_word:
        return ES.encode_lanes_slim_plain(w, True, ES.eviction_rows(PACK_L))
    return ES.encode_lanes_slim_plain(w)


def _pack(dev, two_word: bool):
    """Sort and pack of ``_pack_records`` at each of PACK_CUTS."""
    outs = [t.to(dev) for t in _pack_records(two_word)]
    if two_word:
        rec1, rec2, fstate, misc, ev1, ev2, fopen = outs
        args = (rec1, rec2, fstate, fopen, ev1, ev2, misc)
        fn = ES.pack_lanes_slim_two_word
    else:
        rec, fstate, misc, ev = outs
        args, fn = (rec, fstate, ev, misc), ES.pack_lanes_slim
    return sum((fn(*args, max_bits, slice_to)
                for max_bits, slice_to in PACK_CUTS), ())


def digest(t: torch.Tensor) -> str:
    """A short digest of a tensor's shape, type and values."""
    t = t.cpu().contiguous()
    return hashlib.sha256(f"{t.dtype} {tuple(t.shape)}".encode()
                          + t.numpy().tobytes()).hexdigest()[:16]


def _split(dev):
    w = coder_words().to(dev)
    return w & 1, (w >> 1) & 31, (w >> 6) & 1


def _k2(dev):
    _blob, u = decode_unit()
    return PD.decode_planes(*_unit_args(dev), u["hmax"], u["wmax"], 8, 15)


@functools.lru_cache(maxsize=None)
def _k3_seed():
    """Kernel 3's inputs: the plain version's first R - 1 rounds of the
    unit as the seed canvas, and the last round's offsets (lanes that
    retired earlier get -1)."""
    _blob, u = decode_unit()
    st, offs, ebits, lane_end, geom = _unit_args("cpu")
    seed, err, _pos = PD.decode_planes_plain(st, offs[:-1], ebits[:-1],
                                             lane_end, geom, u["hmax"],
                                             u["wmax"], 8, 15)
    return seed, torch.where(err != 0, -1, offs[-1])


def _k3(dev):
    _blob, u = decode_unit()
    st, offs, ebits, lane_end, geom = _unit_args(dev)
    seed, last = _k3_seed()
    R = offs.shape[0]
    return PD.decode_plane_seeded(st, last.to(dev), ebits[-1], lane_end,
                                  geom, seed.to(dev), u["hmax"], u["wmax"],
                                  8 - (R - 1), 15)


@functools.lru_cache(maxsize=None)
def w1_cases():
    """[(filt, mag_bits, axis, low_h, low_w, canvases)]: for every filter
    and sample width, a column pass on lines of each length of W1_LENGTHS
    and a row pass on lines of each, over a stage block inside seeded
    W1_CANVAS canvases; values across the whole signed range in half the
    cases (most of those lines overflow) and across an eighth of it in
    the others."""
    rng = np.random.default_rng(SEED)
    cases = []
    for filt in W1_FILTERS:
        for mag_bits in (7, 15):
            for n in W1_LENGTHS:
                for axis, lh, lw in ((0, n, 10 - n % 3), (1, 9 - n % 2, n)):
                    amp = 1 << (mag_bits - 3 * ((n + axis + filt) & 1))
                    x = rng.integers(-amp, amp, W1_CANVAS).astype(np.int32)
                    cases.append((filt, mag_bits, axis, lh, lw,
                                  torch.from_numpy(x)))
    return cases


def _w1(dev):
    outs = [WV.inverse_pass(x.to(dev), lh, lw, axis, filt, mag_bits)
            for filt, mag_bits, axis, lh, lw, x in w1_cases()]
    return (torch.stack([out for out, _ov in outs]),
            torch.cat([ov for _out, ov in outs]))


def _marks(dev):
    counts = torch.zeros(len(trace.STAGES), dtype=torch.int64, device=dev)
    for stage in range(len(trace.STAGES)):
        for _ in range(stage + 1):
            trace.mark_into(stage, counts)
    return (counts,)


_SLIM = ("rec", "fstate", "misc", "ev")
_TWO_WORD = ("rec1", "rec2", "fstate", "misc", "ev1", "ev2", "fopen")
# ``digest`` of each output of the plain version on ``wide_words`` (largest
# ordinal 132,850, evictions 70 and 54)
WIDE_DIGESTS = {
    "rec1": "1020222683451c9d", "rec2": "d11bfd0ff4627abb",
    "fstate": "544691770cc1429a", "misc": "f938ab6c4148f003",
    "ev1": "8e9868f99d8f1134", "ev2": "6d4ba91385b48d7d",
    "fopen": "bdb7501232e7e689"}
_PACK = tuple(f"{out} at cut {i}" for i in range(len(PACK_CUTS))
              for out in ("payload", "total", "over"))
_FULL = ("code", "nbits", "open")
_DECODE = ("out", "err", "pos")

# every kernel instance of each library in kernels.KERNELS
CHECKS = {
    "slim_encode": (
        Instance("K1 fused-key", "slim_encode_launch", _SLIM, _k1),
        Instance("K1 two-word", "slim_encode_two_word_launch", _TWO_WORD,
                 _k1_two_word),
        Instance("K1 two-word past 2^17", "slim_encode_two_word_launch",
                 _TWO_WORD, lambda dev: _k1_wide(dev), WIDE_DIGESTS)),
    "slim_pack": (
        Instance("sort and pack fused-key", "slim_pack_launch", _PACK,
                 lambda dev: _pack(dev, False)),
        Instance("sort and pack two-word", "slim_pack_two_word_launch",
                 _PACK, lambda dev: _pack(dev, True))),
    "plane_decode": (
        Instance("K2", "plane_decode_launch", _DECODE, _k2),
        Instance("K3", "plane_decode_seeded_launch", _DECODE, _k3)),
    "full_encode": (
        Instance("K4", "full_encode_launch", _FULL,
                 lambda dev: EF.encode_lanes_full(*_split(dev))),
        Instance("K5", "full_encode_tiled_launch", _FULL,
                 lambda dev: EF.encode_lanes_full_tiled(*_split(dev)))),
    "wavelet": (
        Instance("W1", "wavelet_inverse_pass_launch",
                 ("canvas", "overflow"), _w1),),
    "stage_mark": (
        Instance("stage marks", "stage_mark_launch", ("counts",), _marks),),
}

# the wrappers' launch counts, which the check leaves as it found them (and
# the device's run counts, kernels.run_counters)
_COUNTED = (ES.encode_lanes_slim, ES.encode_lanes_slim_two_word,
            ES.pack_lanes_slim, ES.pack_lanes_slim_two_word,
            EF.encode_lanes_full, EF.encode_lanes_full_tiled,
            PD.decode_planes, PD.decode_plane_seeded,
            WV.inverse_pass)


def first_difference(label: str, name: str, got: torch.Tensor,
                     want: torch.Tensor) -> str | None:
    """None if ``got`` equals ``want`` exactly, else a line naming the
    kernel, the output and the first differing index."""
    got = got.cpu()
    if got.shape != want.shape or got.dtype != want.dtype:
        return (f"{label}: output {name} is {got.dtype} "
                f"{tuple(got.shape)}, the plain version's {want.dtype} "
                f"{tuple(want.shape)}")
    diff = (got != want).nonzero()
    if not len(diff):
        return None
    idx = tuple(diff[0].tolist())
    return (f"{label}: output {name} differs from the plain version first "
            f"at index {idx} ({int(got[idx])} against {int(want[idx])}; "
            f"{len(diff)} elements differ)")


def check_library(name: str, device="cuda") -> tuple[str, ...]:
    """Run every instance of library ``name`` on ``device`` and hold each
    output equal to the plain version on the host (or, for a pinned
    instance, its digest to the plain version's).  Returns the instances
    checked; raises ``KernelMismatch`` at the first difference."""
    counts = [fn.launches for fn in _COUNTED]
    runs = kernels.run_counters(device).clone()
    try:
        for inst in CHECKS[name]:
            got = inst.run(torch.device(device))
            if inst.pinned is not None:
                for out, a in zip(inst.outputs, got, strict=True):
                    if digest(a) != inst.pinned[out]:
                        raise KernelMismatch(
                            f"{inst.label}: output {out} differs from the "
                            f"plain version (digest {digest(a)}, the plain "
                            f"version's {inst.pinned[out]})")
                continue
            want = inst.run(torch.device("cpu"))
            for out, a, b in zip(inst.outputs, got, want, strict=True):
                problem = first_difference(inst.label, out, a, b)
                if problem:
                    raise KernelMismatch(problem)
    finally:
        for fn, n in zip(_COUNTED, counts):
            fn.launches = n
        kernels.run_counters(device).copy_(runs)
    return tuple(inst.label for inst in CHECKS[name])
