"""Differential fuzz of the port's codec against a reference codec.

Counterpart: ``tests/fuzz_oracle.py`` (its sampling envelope) and
``tests/fuzz_jax.py`` (colour trials beside grayscale ones).  Each trial
draws a geometry, a configuration, a sample type and content from a
seeded generator, runs it through the port on ``device`` (``compress``,
``decompress``, ``compress_yuv``, ``decompress_yuv``, ``compress_batch``,
``decompress_batch``) and through the reference, and compares the streams
byte for byte, the decodes pixel for pixel and the refusals by
``IcerStatus``.  The reference is a ``Codec``: ``native_codec()`` is the
port's own host codec on its native runtime (the C++ runtime that the JAX
package's soak holds against the reference build); ``tests/fuzz_torch.py``
adds the JAX package's host codec.  On a mismatch the trial's
configuration, images and streams are written to a temporary directory.

Sampling (``fuzz_oracle.py:41-61``): sides 8-160, and up to ``big_side``
on a share of trials; stages 1-6 with an LL of at least 3 pixels a side;
segments 1 to min(32, the smallest subband's pixels); filters A-F and Q;
content kinds 0-3 (uniform noise, a ramp with noise, sparse spikes, a
constant) and, beyond ``fuzz_oracle.py``, kind 4: uniform noise of 10 to
16 bits (past the 9 coded bitplanes of uint16, the reference's MSB loss;
``tests/test_extremes.py``); quota factors 0.05-2.0 of 2 bytes a pixel,
and on a share of trials a quota of 28-63 bytes (the JAX package pins
quotas from 29 bytes); uint8 and uint16.  A share of trials is colour
(three planes) and a share a batch of 2-4 images of one geometry.  uint8
content is mostly held to 0-127, the signed range the 8-bit DWT keeps, so
that most uint8 trials encode; the rest overflow, and their refusals are
compared.  On a share of trials the port runs with kernel 1's fused-key
limit lowered (``Trial.two_word_from``), so that buckets of small images
take the two-word instance and its sized side buffer.

Sharded trials (``sample_sharded``; counterpart ``tests/fuzz_sharded.py``)
draw from the same envelope a mesh (data, seg) of (1, 2) or (2, 1) and a
grayscale or colour batch of 1-4 images whose count is a multiple of
data.  Every rank of a world of two runs the same list
(``sharded_results``): ``ShardedGrayscaleEncoder.compress_batch`` or
``ShardedColorEncoder.compress_batch``, then, for grayscale,
``ShardedGrayscaleDecoder`` or ``decode_batch_sharded`` on its own
streams.  ``check_sharded`` holds every rank's results to the
reference's single-image calls and to each other.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from collections import Counter
from dataclasses import dataclass, field
from typing import Callable

import numpy as np

from ..core.status import IcerError
from ..core.subbands import dim_low, subband_view
from ..models import color as CL
from ..models import grayscale as T
from ..models.decode import decompress_batch
from ..ops import entropy_slim as ES

QUOTA_FACTORS = (0.05, 0.2, 0.6, 1.0, 2.0)
BIG_SHARE = 1 / 16            # trials whose sides reach big_side
COLOR_SHARE = 1 / 8
BATCH_SHARE = 1 / 8
TINY_QUOTA_SHARE = 1 / 16     # trials with a quota of 28-63 bytes
TWO_WORD_SHARE = 1 / 4        # trials with the fused-key limit lowered
TWO_WORD_FROM = (256, 1024, 4096)
SHARDED_MESHES = ((1, 2), (2, 1))   # (data, seg) of a world of two
SHARDED_COLOR_SHARE = 1 / 3


@dataclass
class Codec:
    """One codec's operations; a reference needs no batch operations
    (each image of a batch goes through the single ones)."""
    name: str
    compress: Callable            # (image, config) -> bytes
    decompress: Callable          # (stream, config, dtype) -> array
    compress_yuv: Callable        # (y, u, v, config) -> bytes
    decompress_yuv: Callable      # (stream, config, dtype) -> (y, u, v)
    compress_batch: Callable | None = None     # (images, config) -> [bytes]
    decompress_batch: Callable | None = None   # (streams, config, dtype)


def port_codec(device) -> Codec:
    """The port's card path on ``device`` (CPU tensors run the kernels'
    plain versions)."""
    return Codec(
        f"port on {device}",
        lambda img, cfg: T.compress(img, cfg, device=device),
        lambda s, cfg, dt: T.decompress(s, cfg, dtype=dt, device=device),
        lambda y, u, v, cfg: CL.compress_yuv(y, u, v, cfg, device=device),
        lambda s, cfg, dt: CL.decompress_yuv(s, cfg, dtype=dt, device=device),
        lambda imgs, cfg: T.compress_batch(imgs, cfg, device=device),
        lambda ss, cfg, dt: decompress_batch(ss, cfg, dtype=dt,
                                             device=device))


def native_codec() -> Codec:
    """The port's host codec on the native runtime."""
    return Codec(
        "native host codec",
        lambda img, cfg: T.compress(img, cfg, backend="native"),
        lambda s, cfg, dt: T.decompress(s, cfg, dtype=dt, backend="native"),
        lambda y, u, v, cfg: CL.compress_yuv(y, u, v, cfg, backend="native"),
        lambda s, cfg, dt: CL.decompress_yuv(s, cfg, dtype=dt,
                                             backend="native"))


@dataclass
class Trial:
    index: int
    kind: str                     # "gray", "color", "batch" or "sharded"
    w: int
    h: int
    stages: int
    filt: int
    segments: int
    quota: int
    dtype: type
    content: list = field(default_factory=list)
    images: list = field(default_factory=list)   # arrays, or 3 planes
    # buckets of this many slots or more take kernel 1's two-word
    # instance in the port's run (None: the fused-key limit as it is)
    two_word_from: int | None = None
    # sharded trials: the mesh (data, seg), the planes of an image (1, or
    # 3 for colour, ``images`` then holding y, u, v of each image in
    # turn) and the grayscale decode ("mesh": ShardedGrayscaleDecoder,
    # "round robin": decode_batch_sharded)
    mesh: tuple | None = None
    planes: int = 1
    decoder: str = "mesh"

    @property
    def config(self):
        return T.CodecConfig(self.stages, self.filt, self.segments,
                             self.quota)

    def describe(self) -> dict:
        return {"index": self.index, "kind": self.kind, "w": self.w,
                "h": self.h, "stages": self.stages, "filt": self.filt,
                "segments": self.segments, "quota": self.quota,
                "dtype": np.dtype(self.dtype).name, "content": self.content,
                "two_word_from": self.two_word_from,
                **({"mesh": list(self.mesh), "planes": self.planes,
                    "decoder": self.decoder} if self.mesh else {})}


@contextlib.contextmanager
def fused_key_limit(two_word_from: int | None):
    """Inside, buckets of ``two_word_from`` slots or more take kernel 1's
    two-word instance (None: no change)."""
    real = ES.fused_key_ok
    if two_word_from is not None:
        ES.fused_key_ok = lambda L: L < two_word_from and real(L)
    try:
        yield
    finally:
        ES.fused_key_ok = real


def content(rng, h: int, w: int, kind: int, dtype,
            halve: bool | None = None) -> np.ndarray:
    """One image of content ``kind`` (``fuzz_oracle.py``'s four, and
    noise of 10 to 16 bits), in ``dtype``: uint8 content is cut to 0-255
    and halved into 0-127 where ``halve`` (None: on 9 of 10 images)."""
    if kind == 0:
        img = rng.integers(0, 256, (h, w))
    elif kind == 1:
        base = np.add.outer(np.arange(h) * 3, np.arange(w)) % 200
        img = base + rng.integers(0, 40, (h, w))
    elif kind == 2:
        img = (rng.random((h, w)) < rng.random()) * int(rng.integers(1, 512))
    elif kind == 3:
        img = np.full((h, w), int(rng.integers(0, 500)))
    else:
        img = rng.integers(0, 1 << int(rng.integers(10, 17)), (h, w))
    if np.dtype(dtype) == np.uint8:
        if halve is None:
            halve = rng.random() < 0.9
        img = np.minimum(img, 255) >> int(halve)
    return img.astype(dtype)


def smallest_subband(w: int, h: int, stages: int) -> int:
    return min(subband_view(w, h, st, sb).h * subband_view(w, h, st, sb).w
               for st, sb in T.all_subbands(stages))


def _geometry(rng, max_side: int, big_side: int, big: float,
              min_side: int = 8) -> tuple:
    """(w, h, stages, segments, filt, quota factor, dtype) from ``rng``."""
    while True:
        side = big_side if (big_side > max_side and rng.random() < big) \
            else max_side
        h = int(rng.integers(min_side, side + 1))
        w = int(rng.integers(min_side, side + 1))
        stages = int(rng.integers(1, 7))
        if min(dim_low(w, stages), dim_low(h, stages)) >= 3:
            break
    segments = int(rng.integers(1, min(32, smallest_subband(w, h, stages))
                                + 1))
    filt = int(rng.integers(0, 7))
    qf = float(rng.choice(QUOTA_FACTORS))
    dtype = np.uint8 if rng.random() < 0.5 else np.uint16
    return w, h, stages, segments, filt, qf, dtype


def _quota_and_limit(rng, h: int, w: int, per_image: int, qf: float):
    """(byte quota, two_word_from): the quota factor's quota, or on a
    share of trials 28-63 bytes; the lowered fused-key limit on a share."""
    quota = max(64, int(h * w * per_image * qf))
    if rng.random() < TINY_QUOTA_SHARE:
        quota = int(rng.integers(28, 64))
    two_word_from = int(rng.choice(TWO_WORD_FROM)) \
        if rng.random() < TWO_WORD_SHARE else None
    return quota, two_word_from


def sample(rng, index: int, max_side: int = 160, big_side: int = 1024,
           shares=(BIG_SHARE, COLOR_SHARE, BATCH_SHARE)) -> Trial:
    """One trial from ``rng``; ``max_side`` and ``big_side`` bound the
    sides (a ``big_side`` of ``max_side`` or less turns the large share
    off)."""
    big, color, batch = shares
    w, h, stages, segments, filt, qf, dtype = _geometry(rng, max_side,
                                                        big_side, big)
    u = rng.random()
    kind = "color" if u < color else ("batch" if u < color + batch
                                      else "gray")
    n = {"gray": 1, "color": 3, "batch": int(rng.integers(2, 5))}[kind]
    kinds = [int(rng.integers(0, 5)) for _ in range(n)]
    images = [content(rng, h, w, k, dtype) for k in kinds]
    quota, two_word_from = _quota_and_limit(
        rng, h, w, 6 if kind == "color" else 2, qf)
    return Trial(index, kind, w, h, stages, filt, segments, quota, dtype,
                 kinds, images, two_word_from)


def sample_sharded(rng, index: int, max_side: int = 160,
                   big_side: int = 1024, min_side: int = 8) -> Trial:
    """One sharded trial from ``rng``: ``sample``'s envelope (sides from
    ``min_side``), a mesh of ``SHARDED_MESHES`` and a grayscale or colour
    batch of 1-4 images of one content kind, a multiple of the mesh's
    data axis."""
    w, h, stages, segments, filt, qf, dtype = _geometry(
        rng, max_side, big_side, BIG_SHARE, min_side)
    mesh = SHARDED_MESHES[int(rng.integers(0, len(SHARDED_MESHES)))]
    planes = 3 if rng.random() < SHARDED_COLOR_SHARE else 1
    count = mesh[0] * int(rng.integers(1, 4 // mesh[0] + 1))
    # one content kind and one uint8 range for the batch, so that a
    # batch is refused about as often as a single image
    kind, halve = int(rng.integers(0, 5)), bool(rng.random() < 0.9)
    kinds = [kind] * (count * planes)
    images = [content(rng, h, w, kind, dtype, halve) for _ in kinds]
    quota, two_word_from = _quota_and_limit(rng, h, w, 2 * planes, qf)
    decoder = "mesh" if rng.random() < 0.5 else "round robin"
    return Trial(index, "sharded", w, h, stages, filt, segments, quota,
                 dtype, kinds, images, two_word_from, mesh, planes, decoder)


def sharded_trials(seed: int, count: int, max_side: int = 160,
                   big_side: int = 1024, min_side: int = 8) -> list[Trial]:
    """The fixed list of ``count`` sharded trials from ``seed`` that every
    rank of a world and the reference draw alike."""
    rng = np.random.default_rng(seed)
    return [sample_sharded(rng, i, max_side, big_side, min_side)
            for i in range(count)]


def _call(fn, *args):
    """("ok", result), ("error", IcerStatus name), or for any other
    exception ("crash", its type and message), which ``compare`` counts
    as a mismatch wherever it comes from."""
    try:
        return "ok", fn(*args)
    except IcerError as e:
        return "error", e.status.name
    except Exception as e:   # noqa: BLE001 - a crash is a finding
        return "crash", f"{type(e).__name__}: {e}"


def _same(a, b) -> bool:
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.dtype == b.dtype and np.array_equal(a, b)
    return a == b


def _dump(trial: Trial, problem: str, streams: dict) -> str:
    """Write the trial to a new temporary directory; returns its path."""
    out = tempfile.mkdtemp(prefix=f"icer_fuzz_{trial.index}_")
    with open(os.path.join(out, "trial.json"), "w") as fh:
        json.dump({**trial.describe(), "problem": problem}, fh, indent=1)
    for i, img in enumerate(trial.images):
        np.save(os.path.join(out, f"image{i}.npy"), img)
    for name, s in streams.items():
        if isinstance(s, bytes):
            with open(os.path.join(out, f"{name}.icer"), "wb") as fh:
                fh.write(s)
    return out


def compare(trial: Trial, port: Codec, ref: Codec) -> tuple[str | None,
                                                           dict]:
    """Run one trial through both codecs: (None, streams) when they agree,
    else (what differs, the streams made)."""
    with fused_key_limit(trial.two_word_from):
        return _compare(trial, port, ref)


def _compare(trial: Trial, port: Codec, ref: Codec):
    cfg, dt = trial.config, trial.dtype
    if trial.kind == "color":
        enc = (_call(port.compress_yuv, *trial.images, cfg),
               _call(ref.compress_yuv, *trial.images, cfg))
        dec_port, dec_ref = port.decompress_yuv, ref.decompress_yuv
    elif trial.kind == "gray":
        enc = (_call(port.compress, trial.images[0], cfg),
               _call(ref.compress, trial.images[0], cfg))
        dec_port, dec_ref = port.decompress, ref.decompress
    else:
        return _compare_batch(trial, port, ref)
    (pk, ps), (rk, rs) = enc
    streams = {"port": ps, "reference": rs}
    if (pk, ps) != (rk, rs) or pk == "crash":
        return (f"encode: port {pk} {_short(ps)}, reference {rk} "
                f"{_short(rs)}"), streams
    if pk == "error":
        return None, streams
    got, want = _call(dec_port, rs, cfg, dt), _call(dec_ref, rs, cfg, dt)
    if not _same(got, want) or got[0] == "crash":
        return "decode of the reference's stream differs", streams
    return None, streams


def _which(a, b) -> str:
    """How two ranks' results differ: their kinds and messages, or the
    first output whose values differ."""
    if a is None or b is None or a[0] != b[0] or a[0] != "ok":
        return (f" ({None if a is None else a[0]} "
                f"{'' if a is None else _short(a[1])[:200]} against "
                f"{None if b is None else b[0]} "
                f"{'' if b is None else _short(b[1])[:200]})")
    for i, (x, y) in enumerate(zip(a[1], b[1])):
        if not _same(x, y):
            return f" (output {i} first)"
    return f" ({len(a[1])} against {len(b[1])} outputs)"


def _short(x) -> str:
    if isinstance(x, bytes):
        return f"{len(x)} B"
    if isinstance(x, list):
        return f"{len(x)} streams"
    return str(x)


def _compare_batch(trial: Trial, port: Codec, ref: Codec):
    cfg, dt = trial.config, trial.dtype
    refs = [_call(ref.compress, img, cfg) for img in trial.images]
    got = _call(port.compress_batch, np.stack(trial.images), cfg)
    streams = {f"reference{i}": s for i, (_k, s) in enumerate(refs)}
    failed = {s for k, s in refs if k != "ok"}
    if failed:
        # the batch is refused with one of its images' statuses
        if got[0] != "error" or got[1] not in failed:
            return (f"batch encode: port {got[0]} {_short(got[1])}, "
                    f"reference refusals {sorted(failed)}"), streams
        return None, streams
    if got[0] != "ok":
        return f"batch encode refused: {got[1]}", streams
    streams.update({f"port{i}": s for i, s in enumerate(got[1])})
    ref_streams = [s for _k, s in refs]
    if got[1] != ref_streams:
        bad = [i for i, (a, b) in enumerate(zip(got[1], ref_streams))
               if a != b]
        return f"batch streams differ at images {bad}", streams
    dec = _call(port.decompress_batch, ref_streams, cfg, dt)
    want = [_call(ref.decompress, s, cfg, dt) for s in ref_streams]
    failed = {s for k, s in want if k != "ok"}
    if failed:
        # the batch decode is refused with one of its streams' statuses
        # (a stream that a tiny quota leaves without a segment)
        if dec[0] != "error" or dec[1] not in failed:
            return (f"batch decode: port {dec[0]} {_short(dec[1])}, "
                    f"reference refusals {sorted(failed)}"), streams
        return None, streams
    if dec[0] != "ok" or not _same(list(dec[1]), [px for _k, px in want]):
        return "batch decode differs", streams
    return None, streams


def run(port: Codec, ref: Codec, trials: int | None = None,
        seconds: float | None = None, seed: int = 0, max_side: int = 160,
        big_side: int = 1024, log=print) -> dict:
    """Sample and compare trials until ``trials`` have run or ``seconds``
    have passed (whichever is given; both: the first reached).  Returns
    {"trials", "mismatches": [(index, problem, dump dir)], "per_filter",
    "per_kind", "per_dtype", "two_word", "tiny_quota", "seconds"}."""
    if trials is None and seconds is None:
        raise ValueError("give trials or seconds")
    rng = np.random.default_rng(seed)
    per_filter, per_kind, per_dtype = Counter(), Counter(), Counter()
    two_word = tiny_quota = 0
    mismatches = []
    t0 = time.perf_counter()
    n = 0
    while (trials is None or n < trials) and (
            seconds is None or time.perf_counter() - t0 < seconds):
        trial = sample(rng, n, max_side=max_side, big_side=big_side)
        problem, streams = compare(trial, port, ref)
        per_filter["ABCDEFQ"[trial.filt]] += 1
        per_kind[trial.kind] += 1
        per_dtype[np.dtype(trial.dtype).name] += 1
        two_word += trial.two_word_from is not None
        tiny_quota += trial.quota < 64
        if problem:
            where = _dump(trial, problem, streams)
            mismatches.append((n, problem, where))
            log(f"MISMATCH trial {n} {trial.describe()}: {problem} "
                f"(dumped to {where})")
        n += 1
    return {"trials": n, "mismatches": mismatches,
            "per_filter": dict(sorted(per_filter.items())),
            "per_kind": dict(per_kind), "per_dtype": dict(per_dtype),
            "two_word": two_word, "tiny_quota": tiny_quota,
            "seconds": time.perf_counter() - t0}


def sharded_results(trials: list[Trial], device) -> list[dict]:
    """This rank's run of every sharded trial, in a world of two ranks
    (after ``parallel.distributed.initialize``): per trial its
    description, the sharded encode's ``_call`` result and, for grayscale
    trials that encode, the decode's of its streams (else None).  Every
    rank must run the same list."""
    from ..models.grayscale import _mag_bits
    from ..parallel import sharded as SH
    out = []
    for t in trials:
        mesh = SH.make_mesh(data=t.mesh[0], device=device)
        args = (mesh, t.w, t.h, t.stages, t.filt, t.segments,
                _mag_bits(t.dtype))
        imgs = np.stack(t.images)
        with fused_key_limit(t.two_word_from):
            if t.planes == 3:
                got = _call(lambda: SH.ShardedColorEncoder(
                    *args).compress_batch(imgs[0::3], imgs[1::3],
                                          imgs[2::3], t.config))
            else:
                got = _call(lambda: SH.ShardedGrayscaleEncoder(
                    *args).compress_batch(imgs, t.config))
        dec = None
        if t.planes == 1 and got[0] == "ok":
            if t.decoder == "mesh":
                dec = _call(lambda: SH.ShardedGrayscaleDecoder(
                    mesh, t.w, t.h, t.config, t.dtype).decode_batch(got[1]))
            else:
                dec = _call(SH.decode_batch_sharded, got[1], t.config,
                            t.dtype, [device, device])
        out.append({"trial": t.describe(), "encode": got, "decode": dec})
    return out


def sharded_reference(trial: Trial, ref: Codec) -> dict:
    """The reference's single-image calls for a sharded trial: each
    image's encode and, when every image encodes, each stream's decode
    (None for colour trials, which have no sharded decode)."""
    cfg, dt = trial.config, trial.dtype
    if trial.planes == 3:
        ims = trial.images
        enc = [_call(ref.compress_yuv, *ims[i:i + 3], cfg)
               for i in range(0, len(ims), 3)]
        return {"encode": enc, "decode": None}
    enc = [_call(ref.compress, img, cfg) for img in trial.images]
    dec = [_call(ref.decompress, s, cfg, dt) for _k, s in enc] \
        if all(k == "ok" for k, _s in enc) else None
    return {"encode": enc, "decode": dec}


def _refusal(what: str, got, want: list):
    """The problem, if any, of the port's ``got`` against the reference's
    per-image results ``want`` when the reference refuses some of them:
    the port must refuse with one of their statuses."""
    failed = {s for k, s in want if k != "ok"}
    if got[0] != "error" or got[1] not in failed:
        return (f"{what}: port {got[0]} {_short(got[1])}, reference "
                f"refusals {sorted(failed)}")
    return None


def compare_sharded(trial: Trial, ranks: list[dict], ref: dict):
    """One sharded trial's rank results against each other and against
    the reference's (``sharded_reference``): (None, streams) when they
    agree, else (what differs, the streams made)."""
    streams = {f"reference{i}": s for i, (_k, s) in enumerate(ref["encode"])}
    for r, res in enumerate(ranks):
        if res["encode"][0] == "ok":
            streams.update({f"rank{r}_{i}": s
                            for i, s in enumerate(res["encode"][1])})
    if any(res["trial"] != trial.describe() for res in ranks):
        return "a rank drew another trial", streams
    for r, res in enumerate(ranks[1:], 1):
        for part in ("encode", "decode"):
            a, b = ranks[0][part], res[part]
            if (a is None) != (b is None) or a is not None and (
                    a[0] != b[0] or a[0] != "crash" and not _same(a, b)):
                return (f"ranks 0 and {r} disagree on the {part}"
                        + _which(a, b)), streams
    enc, dec = ranks[0]["encode"], ranks[0]["decode"]
    if enc[0] == "crash":
        return f"sharded encode crashed: {enc[1]}", streams
    if any(k != "ok" for k, _s in ref["encode"]):
        return _refusal("sharded encode", enc, ref["encode"]), streams
    if enc[0] != "ok":
        return f"sharded encode refused: {enc[1]}", streams
    want = [s for _k, s in ref["encode"]]
    if enc[1] != want:
        bad = [i for i, (a, b) in enumerate(zip(enc[1], want)) if a != b]
        return f"sharded streams differ at images {bad}", streams
    if trial.planes == 3:
        return None, streams
    if any(k != "ok" for k, _px in ref["decode"]):
        # a stream that a tiny quota leaves without a segment
        return _refusal(f"sharded decode ({trial.decoder})", dec,
                        ref["decode"]), streams
    if dec[0] != "ok" or not _same(list(dec[1]),
                                   [px for _k, px in ref["decode"]]):
        return f"sharded decode ({trial.decoder}) differs", streams
    return None, streams


def check_sharded(trials: list[Trial], ranks: list[list[dict]],
                  refs: list[dict], log=print) -> dict:
    """Compare every sharded trial (``ranks[r][i]``: rank r's result of
    trial i; ``refs[i]``: the reference's) and dump each mismatch.
    Returns {"trials", "mismatches": [(index, problem, dump dir)],
    "per_mesh", "per_filter", "per_quota" (the quota class: 28-63 bytes,
    else the nearest quota factor), "color", "refused", "two_word",
    "tiny_quota"}."""
    mismatches = []
    per_mesh, per_filter, per_quota = Counter(), Counter(), Counter()
    refused = 0
    for t, ref, *res in zip(trials, refs, *ranks):
        problem, streams = compare_sharded(t, res, ref)
        per_mesh["{}x{}".format(*t.mesh)] += 1
        per_filter["ABCDEFQ"[t.filt]] += 1
        per_quota["28-63 B" if t.quota < 64 else "x{}".format(min(
            QUOTA_FACTORS, key=lambda q: abs(
                q - t.quota / (2 * t.planes * t.h * t.w))))] += 1
        refused += res[0]["encode"][0] == "error" or (
            res[0]["decode"] is not None and res[0]["decode"][0] == "error")
        if problem:
            where = _dump(t, problem, streams)
            mismatches.append((t.index, problem, where))
            log(f"MISMATCH sharded trial {t.index} {t.describe()}: "
                f"{problem} (dumped to {where})")
    return {"trials": len(trials), "mismatches": mismatches,
            "per_mesh": dict(sorted(per_mesh.items())),
            "per_filter": dict(sorted(per_filter.items())),
            "per_quota": dict(sorted(per_quota.items())),
            "color": sum(t.planes == 3 for t in trials), "refused": refused,
            "two_word": sum(t.two_word_from is not None for t in trials),
            "tiny_quota": sum(t.quota < 64 for t in trials)}
