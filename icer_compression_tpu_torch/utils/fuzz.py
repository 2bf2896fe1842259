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
    kind: str                     # "gray", "color" or "batch"
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

    @property
    def config(self):
        return T.CodecConfig(self.stages, self.filt, self.segments,
                             self.quota)

    def describe(self) -> dict:
        return {"index": self.index, "kind": self.kind, "w": self.w,
                "h": self.h, "stages": self.stages, "filt": self.filt,
                "segments": self.segments, "quota": self.quota,
                "dtype": np.dtype(self.dtype).name, "content": self.content,
                "two_word_from": self.two_word_from}


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


def content(rng, h: int, w: int, kind: int, dtype) -> np.ndarray:
    """One image of content ``kind`` (``fuzz_oracle.py``'s four, and
    noise of 10 to 16 bits), in ``dtype``: uint8 content is cut to 0-255
    and, on 9 of 10 images, halved into 0-127."""
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
        img = np.minimum(img, 255) >> int(rng.random() < 0.9)
    return img.astype(dtype)


def smallest_subband(w: int, h: int, stages: int) -> int:
    return min(subband_view(w, h, st, sb).h * subband_view(w, h, st, sb).w
               for st, sb in T.all_subbands(stages))


def sample(rng, index: int, max_side: int = 160, big_side: int = 1024,
           shares=(BIG_SHARE, COLOR_SHARE, BATCH_SHARE)) -> Trial:
    """One trial from ``rng``; ``max_side`` and ``big_side`` bound the
    sides (a ``big_side`` of ``max_side`` or less turns the large share
    off)."""
    big, color, batch = shares
    while True:
        side = big_side if (big_side > max_side and rng.random() < big) \
            else max_side
        h = int(rng.integers(8, side + 1))
        w = int(rng.integers(8, side + 1))
        stages = int(rng.integers(1, 7))
        if min(dim_low(w, stages), dim_low(h, stages)) >= 3:
            break
    segments = int(rng.integers(1, min(32, smallest_subband(w, h, stages))
                                + 1))
    filt = int(rng.integers(0, 7))
    qf = float(rng.choice(QUOTA_FACTORS))
    dtype = np.uint8 if rng.random() < 0.5 else np.uint16
    u = rng.random()
    kind = "color" if u < color else ("batch" if u < color + batch
                                      else "gray")
    n = {"gray": 1, "color": 3, "batch": int(rng.integers(2, 5))}[kind]
    kinds = [int(rng.integers(0, 5)) for _ in range(n)]
    images = [content(rng, h, w, k, dtype) for k in kinds]
    per_image = 6 if kind == "color" else 2
    quota = max(64, int(h * w * per_image * qf))
    if rng.random() < TINY_QUOTA_SHARE:
        quota = int(rng.integers(28, 64))
    two_word_from = int(rng.choice(TWO_WORD_FROM)) \
        if rng.random() < TWO_WORD_SHARE else None
    return Trial(index, kind, w, h, stages, filt, segments, quota, dtype,
                 kinds, images, two_word_from)


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
