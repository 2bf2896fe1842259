"""Encode orchestration: image batch -> per-lane payload tables.

Counterpart: ``icer_compression_tpu/ops/encode_jax.py``
(``JaxGrayscaleEncoder``: ``_plan_groups``,
``_plan_buckets``, ``_transform_fn``, ``_make_emit_fn`` with its plane
window, ``_gather_compact_words``, the bucket functions of the three coder
backends -- ``_make_bucket_fn`` (``sorted``), ``_make_bucket_fn_pallas``
and ``_make_bucket_fn_slim`` without the per-plane caps -- ``encode_batch``
and ``_unpack_batch``).

Per batch of B same-geometry images: DWT + LL-mean removal +
sign-magnitude, then per stage group a gather of every segment rectangle
into one padded lane batch and its emission words for every bitplane of
the group's plane window, then per length bucket the coder backend, all on
the device:

  ``auto``   ``slim`` on every bucket (the default);
  ``slim``   kernel 1 over the interleaved words, then the sort/rebuild/
             pack tail (ops/entropy_slim): fused-key records where a
             bucket's allocation ordinals stay below 2^15, two-word records
             for longer lanes, at any length, with the reorder-window
             evictions on the card;
  ``pallas`` the valid-first compaction, kernel 4, then the record tail
             (ops/entropy_full);
  ``sorted`` the valid-first compaction, then the sort-centric coder in
             plain PyTorch (ops/entropy_sorted).

Rate allocation and stream assembly stay on the host (models/grayscale).
``encode_batch`` uploads each pass's images from pinned host memory and
copies its results back the same way, so its dispatch half never waits
for the card (``defer`` returns the collector instead of collecting).
Between those host edges a pass is ``device_pass``: it reads only its
input and the encoder's device tables and writes only its outputs, so on
the card it runs as one captured CUDA graph per pass shape (``graph=``,
backend/graph_cache: eager on a key's first two passes, captured by the
second one's collector and checked against that eager pass, replayed
after), as the JAX encoder runs one compiled program; on the CPU it runs
eagerly.
Lanes that a backend flags (kernel 1's fused-key eviction side buffer
overflow, a reorder-window flush that kernel 4 and the sorted coder leave
to the host, more records or valid emissions than the compacted length, a
payload past its cap)
re-encode exactly on the host: the collect half runs the pass again
eagerly on its kept input, gathers the flagged rows of its words on the
device, copies them back at once and codes them in one threaded batch of
the native runtime (backend/native_backend, held equal to
backend/sequential); ``fallback_lanes`` counts them and
``fallback_seconds`` adds up the time of the gather, copy and batch.

Under ``torch.profiler`` (utils/trace) a pass records the spans
``encode.dispatch`` (upload and dispatch half), ``encode.wait``,
``encode.capture``, ``encode.collect`` and ``encode.host_reencode``, and
the counts ``encode.lanes`` (real lanes coded), ``encode.pad_images``
(the all-zero images that pad a batch's last pass to the size of its
others) and ``encode.host_reencode_lanes``; ``device_pass`` marks its
stages on the card whether or not the profiler records.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import threading
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..backend import graph_cache, native_backend
from ..core import constants as C
from ..core.partition import partition_segments
from ..core.status import IcerError, IcerStatus
from ..core.subbands import dim_low, subband_view
from ..device import Pending, to_device, to_host
from ..utils import trace
from . import entropy_full as EF
from . import entropy_slim as ES
from . import entropy_sorted as SO
from . import wavelet
from .context_model import plane_emissions_words

ENTROPY_BACKENDS = ("auto", "slim", "pallas", "sorted")

# Coder words (int32) of a pass's largest bucket that one device pass of
# ``encode_batch`` codes at most.  A slim pass peaks at about 127 bytes per
# such word with fused-key records and 140 with two-word records (an H100,
# chip_smoke.py phase 20), so a pass of 2^27 words peaks near 17 or 19 GB;
# one pass over 168 canvases of 512x512, 6.0e8 words, ran an 80 GB card
# out of memory.  The two-word tail's side buffer, eviction_rows(L) rows,
# adds under 1% to its L + 17 sort rows.
PASS_WORDS = 1 << 27
# Coder words of one coder call at most: a pass's bucket past it (one
# image's, where that alone passes PASS_WORDS) is coded in runs of rows.
# Lanes are independent, so the payloads do not change.  One 5120x3840
# image's stage-1 bucket (2.66e8 words) runs as two calls.  Kernel 4's
# path peaks at 113 bytes per coder word (chip_smoke.py phase 25), below
# slim's.
CALL_WORDS = PASS_WORDS
# Each coder's passes and calls take PASS_WORDS and CALL_WORDS divided by
# its divisor here, so that its peak stays at or under slim two-word's at
# a full pass.  Peak device bytes per coder word, flat from passes of
# 2^25 to 2^27 words (an NVIDIA H100 80GB HBM3 at 700 W, chip_smoke.py
# phase 27): slim 127 with fused-key records and 141 with two-word ones,
# pallas 113, sorted 378, whose full pass at slim's size peaked at
# 48 GB.  A third of slim's words keeps sorted near 126 B per slim word.
# Since each pass drops its emissions once they are coder words
# (``device_pass``), the four peak 3-4% lower: 123, 136, 109 and 373.
# These slim figures are from before its sort and pack became a kernel
# (csrc/slim_pack.cu): since then a slim pass peaks near 18 B per word
# with fused-key records and 21 with two-word ones (chip_smoke.py
# phase 20), and the sizes here are kept.
CODER_DIVISORS = {"slim": 1, "pallas": 1, "sorted": 3}
# Device bytes of one full pass, the pass budget: PASS_WORDS at the
# largest peak per coder word that sized them, slim's with two-word
# records and its sort-based tail.  backend/graph_cache holds the pools
# of a device's captured passes to it beyond their static tensors.
PASS_PEAK_BYTES = PASS_WORDS * 141


@dataclass(frozen=True)
class Lane:
    stage: int
    subband: int
    seg: int
    row: int       # absolute position of the segment in the image
    col: int
    h: int
    w: int
    dummy: bool = False   # a padding lane of a lane share: no pixels


def _plan_groups(image_w, image_h, stages, segments, share=(1, 0)):
    """One group per stage: its subbands' segment lanes, padded to the
    group's largest segment.  ``share`` (n, k): the group's lanes, padded
    with dummy lanes to a multiple of n, are cut into n equal runs and the
    group keeps run k (a rank's share on the ``seg`` axis of
    parallel/sharded); the padded size stays the whole group's."""
    nshare, k = share
    groups = []
    for stage in range(1, stages + 1):
        subs = [C.SUBBAND_HL, C.SUBBAND_LH, C.SUBBAND_HH]
        if stage == stages:
            subs = [C.SUBBAND_LL] + subs
        lanes: list[Lane] = []
        for sb in subs:
            view = subband_view(image_w, image_h, stage, sb)
            for rect in partition_segments(view.w, view.h, segments):
                lanes.append(Lane(stage, sb, rect.index,
                                  view.row + rect.row, view.col + rect.col,
                                  rect.h, rect.w))
        mh = max(l.h for l in lanes)
        mw = max(l.w for l in lanes)
        while len(lanes) % nshare:
            lanes.append(Lane(stage, C.SUBBAND_HH, -1, 0, 0, 1, 1,
                              dummy=True))
        per = len(lanes) // nshare
        lanes = lanes[k * per:(k + 1) * per]
        pix_valid = np.zeros((len(lanes), mh, mw), dtype=np.int32)
        for i, l in enumerate(lanes):
            pix_valid[i, :l.h, :l.w] = not l.dummy
        groups.append({
            "lanes": lanes, "mh": mh, "mw": mw, "L": 2 * mh * mw,
            "sub_codes": np.array([l.subband for l in lanes], np.int32),
            "pix_valid": pix_valid,
        })
    return groups


def _plan_buckets(groups):
    """Partition stage groups into emission-length buckets (ratio <= 2)."""
    order = sorted(range(len(groups)), key=lambda i: -groups[i]["L"])
    buckets = []
    cur = []
    cur_max = None
    for gi in order:
        L = groups[gi]["L"]
        if cur_max is None or L * 2 >= cur_max:
            cur.append(gi)
            cur_max = cur_max or L
        else:
            buckets.append({"groups": cur, "L": cur_max})
            cur, cur_max = [gi], L
    if cur:
        buckets.append({"groups": cur, "L": cur_max})
    return buckets


def _cap_bits(Lc: int) -> int:
    """Payload cap: ~1 bit per compacted emission slot plus flush slack."""
    return ((Lc + 17 * 10 + 255) // 256) * 256


def bucket_sizes(Lb: int):
    """(kernel length Lk, compacted length Lc, payload cap bits) of a
    bucket whose interleaved emission streams are Lb words long (the
    ``slim`` and ``pallas`` backends)."""
    Lk = -(-Lb // ES.CHUNK) * ES.CHUNK
    Lc = min(Lk, (-(-(3 * Lb) // 4) + 255) // 256 * 256)
    return Lk, Lc, _cap_bits(Lc)


def compact_words(words: torch.Tensor, Lc: int):
    """Valid-first compaction of interleaved (rows, n) emission words: a
    stable partition of each row into its valid words, then its invalid
    ones, cut to Lc.  The coder's output depends only on the valid
    subsequence.  Returns (words (rows, Lc), over): ``over`` flags rows
    with more than Lc valid words (they re-encode on the host)."""
    valid = (words & 1) != 0
    pos = torch.arange(words.shape[-1], device=words.device)
    key = torch.where(valid, pos, words.shape[-1] + pos)
    order = torch.sort(key, dim=-1).indices[:, :Lc]
    return torch.gather(words, -1, order), valid.sum(dim=-1) > Lc


def _split_words(words: torch.Tensor):
    """Packed words valid | ctx << 1 | bit << 6 -> (valid, ctx, bit)."""
    return words & 1, (words >> 1) & 31, (words >> 6) & 1


class _Batch:
    """One ``encode_batch`` call while its passes are collected: how many
    are left, the results so far, ``each``, and the error that stopped its
    collection (its collector raises it)."""

    def __init__(self, each):
        self.left, self.out, self.each, self.error = 0, [], each, None


@dataclass
class _Pass:
    """A device pass of ``encode_batch``, queued: its real image count,
    its input (kept for a re-encode of flagged lanes), the host copies of
    its checks and of each coded bucket's payload, total and flag, the
    capture its collector makes (or None), the end of its copies, and its
    batch."""
    real: int
    x: torch.Tensor
    checks: tuple
    fetched: list
    capture: object
    done: Pending
    batch: _Batch


class TorchGrayscaleEncoder:
    """Encoder for one image geometry (one channel) on one device.

    ``entropy`` picks the coder backend (``auto``, ``slim``, ``pallas`` or
    ``sorted``); ``bucket_coders`` holds the one each bucket runs
    (``auto``: ``slim`` on every bucket, planned here and never swapped
    at run time).
    ``plane_cuts`` bounds the bitplanes encoded per stage group, as in the
    JAX encoder: one entry per stage, an int ``lo`` (the planes lo .. all)
    or a ``(lo, hi)`` window; ``encode_batch`` then returns only those
    lanes.  ``lane_share`` (n, k) keeps share k of n of every group's
    lanes (``_plan_groups``); ``encode_batch`` then returns only those
    lanes.  ``graph``: run each device pass as a captured CUDA graph
    (``device_pass`` through backend/graph_cache); None means on for a
    CUDA device, True on another raises ``ValueError``, False runs every
    pass eagerly (the eager comparison and the by-layer trace)."""

    def __init__(self, image_w: int, image_h: int, stages: int, filt: int,
                 segments: int, mag_bits: int, device: torch.device,
                 entropy: str = "auto", plane_cuts: tuple | None = None,
                 lane_share: tuple = (1, 0), graph: bool | None = None):
        if entropy not in ENTROPY_BACKENDS:
            raise ValueError(
                f"unknown entropy backend {entropy!r}: expected 'auto', "
                "'slim', 'pallas' or 'sorted'")
        wavelet.check_stages(image_w, image_h, stages)
        self.w, self.h = image_w, image_h
        self.stages, self.filt, self.segments = stages, filt, segments
        self.mag_bits = mag_bits
        self.entropy = entropy
        self.device = torch.device(device)
        if graph and self.device.type != "cuda":
            raise ValueError(f"graph=True needs a CUDA device, not "
                             f"{self.device}")
        self.graph = self.device.type == "cuda" if graph is None \
            else bool(graph)
        self.lane_share = tuple(lane_share)
        self.bitplanes = C.BITPLANES_8 if mag_bits == 7 else C.BITPLANES_16
        self.groups = _plan_groups(image_w, image_h, stages, segments,
                                   lane_share)
        self.buckets = _plan_buckets(self.groups)
        if plane_cuts is None:
            plane_cuts = (0,) * len(self.groups)
        if len(plane_cuts) != len(self.groups):
            raise ValueError("plane_cuts must have one entry per stage")
        self.plane_cuts = tuple(
            (int(c[0]), int(c[1])) if isinstance(c, tuple)
            else (int(c), self.bitplanes) for c in plane_cuts)
        for b in self.buckets:
            Lk = bucket_sizes(b["L"])[0]
            b["coder"] = "slim" if entropy == "auto" else entropy
            b["rows"] = sum(max(0, hi - lo) * len(self.groups[gi]["lanes"])
                            for gi in b["groups"]
                            for lo, hi in [self.plane_cuts[gi]])
            b["words"] = Lk * b["rows"]
            b["call_rows"] = max(1, CALL_WORDS
                                 // CODER_DIVISORS[b["coder"]] // Lk)
        self.bucket_coders = tuple(b["coder"] for b in self.buckets)
        # the buckets a pass codes, each with its groups of non-empty
        # plane windows
        coded = [(bi, [gi for gi in b["groups"]
                       if self.plane_cuts[gi][0] < self.plane_cuts[gi][1]])
                 for bi, b in enumerate(self.buckets)]
        self._coded = [(bi, gis) for bi, gis in coded if gis]
        # real (not dummy) lanes an image codes: lanes times window planes
        self.lanes_per_image = sum(
            sum(not l.dummy for l in self.groups[gi]["lanes"])
            * (self.plane_cuts[gi][1] - self.plane_cuts[gi][0])
            for _bi, gis in self._coded for gi in gis)
        self.fallback_lanes = 0
        self.fallback_seconds = 0.0
        # passes dispatched and not yet collected, in dispatch order
        self._queued: collections.deque = collections.deque()
        self._queue_lock = threading.RLock()
        # images per device pass: each bucket's coder words of one image,
        # against its coder's share of PASS_WORDS
        self.words_per_image = max(b["words"] for b in self.buckets)
        self.pass_images = max(1, min(
            PASS_WORDS // CODER_DIVISORS[b["coder"]] // max(1, b["words"])
            for b in self.buckets))
        # per group: gather index of every lane rectangle into the padded
        # flattened image (out-of-rect reads are masked by pix_valid)
        self._wp = image_w + max(g["mw"] for g in self.groups)
        hp = image_h + max(g["mh"] for g in self.groups)
        self._npad = (hp, self._wp)
        for g, cut in zip(self.groups, self.plane_cuts):
            mh, mw = g["mh"], g["mw"]
            idx = np.array([[(l.row + j) * self._wp + l.col + np.arange(mw)
                             for j in range(mh)] for l in g["lanes"]],
                           np.int64)
            g["cut"] = cut
            g["idx_t"] = torch.as_tensor(idx, device=self.device)
            g["pv_t"] = torch.as_tensor(g["pix_valid"], device=self.device)
            g["sub_t"] = torch.as_tensor(g["sub_codes"], device=self.device)

    # ---- device stages --------------------------------------------------
    def transform(self, images: torch.Tensor):
        """(B, h, w) -> (sign-magnitude coefficients, ll_means (B,))."""
        img, overflow = wavelet.forward_stages(images, self.stages,
                                               self.filt, self.mag_bits)
        ll_w = dim_low(self.w, self.stages)
        ll_h = dim_low(self.h, self.stages)
        mask = (1 << (self.mag_bits + 1)) - 1
        ll = img[:, :ll_h, :ll_w]
        ll_mean = torch.div((ll & mask).sum(dim=(1, 2)), ll_w * ll_h,
                            rounding_mode="floor")
        img[:, :ll_h, :ll_w] = wavelet._wrap(
            ll - ll_mean.to(torch.int32)[:, None, None], self.mag_bits)
        return wavelet.to_sign_magnitude(img, self.mag_bits), ll_mean, \
            overflow

    def emit(self, g, img: torch.Tensor):
        """Group g's packed emission words for the planes of its window,
        rows ordered (image, plane, lane): returns (w0, w1), each
        (B * planes * N, mh * mw), or None for an empty window."""
        lo, hi = g["cut"]
        if lo >= hi:
            return None
        B = img.shape[0]
        hp, wp = self._npad
        padded = torch.zeros((B, hp, wp), dtype=torch.int32,
                             device=img.device)
        padded[:, :self.h, :self.w] = img
        batch = padded.reshape(B, -1)[:, g["idx_t"]] * g["pv_t"]
        N, mh, mw = g["pv_t"].shape
        batch = batch.reshape(B * N, mh, mw)
        sub = g["sub_t"].repeat(B)
        pv = g["pv_t"].repeat(B, 1, 1)
        w0s, w1s = [], []
        for lsb in range(lo, hi):
            w0, w1 = plane_emissions_words(batch, sub, pv, lsb,
                                           self.mag_bits)
            w0s.append(w0.reshape(B, N, mh * mw))
            w1s.append(w1.reshape(B, N, mh * mw))
        w0 = torch.stack(w0s, dim=1).reshape(-1, mh * mw)
        w1 = torch.stack(w1s, dim=1).reshape(-1, mh * mw)
        return w0, w1

    def bucket_words(self, b, emitted):
        """Interleaved (rows, Lk) coder input of one bucket: each row is
        [w0[0], w1[0], w0[1], w1[1], ...] padded with invalid words."""
        Lk = bucket_sizes(b["L"])[0]
        parts = []
        for gi in b["groups"]:
            if emitted[gi] is None:
                continue
            w0, w1 = emitted[gi]
            row = torch.stack([w0, w1], dim=-1).reshape(w0.shape[0], -1)
            parts.append(torch.nn.functional.pad(row, (0, Lk - row.shape[1])))
        return torch.cat(parts)

    # ---- coder backends: words -> (payload, total bits, host flag) -------
    def _code(self, b, words):
        """Bucket ``b``'s planned coder over its (rows, Lk) words, in
        calls of at most ``b["call_rows"]`` rows."""
        code = {"slim": self._code_slim, "pallas": self._code_pallas,
                "sorted": self._code_sorted}[b["coder"]]
        n = b["call_rows"]
        if words.shape[0] <= n:
            return code(b, words)
        parts = []
        for i in range(0, len(words), n):
            trace.mark(trace.CODER_INPUT, words)     # each call's own input
            parts.append(code(b, words[i:i + n]))
        return tuple(torch.cat(p) for p in zip(*parts))

    def _code_slim(self, b, words):
        _Lk, Lc, cap_bits = bucket_sizes(b["L"])
        return ES.code_lanes_slim(words.t().contiguous(), cap_bits, Lc)

    def _code_pallas(self, b, words):
        _Lk, Lc, cap_bits = bucket_sizes(b["L"])
        cw, over = compact_words(words, Lc)
        split = [t.t().contiguous() for t in _split_words(cw)]
        trace.mark(trace.CODER_KERNEL, words)
        code, nbits, opn = EF.encode_lanes_full(*split)
        trace.mark(trace.SORT_PACK, words)
        payload, total, flag = EF.order_and_pack_lanes(code, nbits, opn,
                                                       cap_bits)
        return payload, total, flag | over

    def _code_sorted(self, b, words):
        Lb = b["L"]
        Lc = min(Lb, (-(-(3 * Lb) // 4) + 255) // 256 * 256)
        cw, over = compact_words(words, Lc)
        trace.mark(trace.SORT_PACK, words)
        payload, total, flag = SO.encode_emissions_sorted(
            *_split_words(cw), max_bits=_cap_bits(Lc))
        return payload, total, flag | over

    # ---- host orchestration --------------------------------------------
    def _upload(self, images: np.ndarray) -> torch.Tensor:
        """(B, h, w) host images -> int32 tensor on the device.  Batches
        whose values fit 8 bits go up as uint8, uint16 as its int16 bit
        pattern; both widen on the device, so the streams are the same."""
        up = images
        if up.dtype.kind == "u" and up.dtype.itemsize > 1 \
                and up.max() < 256:
            up = up.astype(np.uint8)
        if up.dtype == np.uint8:
            return to_device(up, self.device).to(torch.int32)
        if up.dtype == np.uint16:
            return to_device(up.view(np.int16), self.device).to(
                torch.int32) & 0xFFFF
        return to_device(up.astype(np.int32), self.device)

    def encode_batch(self, images, defer: bool = False, each=None):
        """(B, h, w) same-geometry images (an array, or a sequence of
        (h, w) arrays) -> list of (payload_table, ll_mean); payload_table
        maps (stage, subband, lsb, seg) -> (payload bytes, bit length) for
        the lanes of the plane window.

        The call queues the device passes one after the other, each right
        after the upload of its own images (so the card starts on the
        first pass while the host stages the next), and starts
        non-blocking copies of each pass's results into pinned host
        buffers; nothing on that path waits for the card (but a host
        re-encode of flagged lanes, below).  With ``defer`` it then
        returns a zero-argument collector, which takes the passes in
        order, waiting for each one's copies: it captures the graph of a
        pass marked for it (``graph_cache.GraphCache.capture``) and runs
        the overflow and LL-mean checks, the table loop and the exact host
        re-encodes (so a pipelined caller can overlap this batch's device
        work with other host work); without, it collects at once.
        Between its passes a dispatch half collects the encoder's earlier
        passes (of this batch or of batches still deferred) whose copies
        are done and that need no capture, in dispatch order, so that the
        host half of a pipelined batch runs while the card works through
        the passes queued after it, and a collector finds little left.
        ``each``, if given, is called with each image's result, in order,
        as soon as its pass is collected, so that per-image host work
        follows the card pass by pass too.

        A batch of N > ``pass_images`` = P images runs as n = ceil(N / P)
        device passes, queued one after the other, so that the coder's
        intermediates stay within its share of ``PASS_WORDS`` coder words
        (``CODER_DIVISORS``).  The passes are of one size, s = ceil(N /
        n) images, so the batch is one graph key whose pool fits the
        cache's bound alone (passes of P and a remainder would be two
        keys, whose pools together pass it, so each capture would evict
        the other).  The last pass is padded with n * s - N all-zero
        images on the device (fewer than s), counted as
        ``encode.pad_images``; its collector drops them before the checks,
        the table loop and the host re-encodes.  A batch of N <= P runs
        as one pass of N."""
        batch = _Batch(each)
        with trace.span("encode.dispatch"):
            N = len(images)
            n = -(-N // self.pass_images)
            s = -(-N // n) if n else 1
            trace.count("encode.pad_images", -N % s)
            for i in range(0, N, s):
                self._collect_queued()
                x = self._upload(np.asarray(images[i:i + s]))
                if len(x) < s:
                    x = torch.cat([x, x.new_zeros(
                        (s - len(x),) + tuple(x.shape[1:]))])
                with self._queue_lock:
                    self._queued.append(_Pass(min(s, N - i), x,
                                              *self._dispatch(x),
                                              Pending(self.device), batch))
                    batch.left += 1

        def collect():
            self._collect_queued(batch)
            if batch.error is not None:
                raise batch.error
            return batch.out

        return collect if defer else collect()

    def _collect_queued(self, until: _Batch | None = None) -> None:
        """Collect the encoder's queued passes in dispatch order: with
        ``until``, every pass up to that batch's last, waiting for each;
        without, only those whose copies are done and that need no
        capture (a capture waits for the card).  A pass's error stops its
        batch, whose later passes are dropped uncollected."""
        with self._queue_lock:
            q = self._queued
            while q and (until.left if until is not None else
                         q[0].capture is None and q[0].done.ready()):
                p = q.popleft()
                p.batch.left -= 1
                if p.batch.error is None:
                    try:
                        self._finish(p)
                    except Exception as e:
                        p.batch.error = e

    def _finish(self, p: _Pass) -> None:
        """The host half of the pass ``p``: its results join its batch's
        and go to the batch's ``each``."""
        with trace.span("encode.wait"):
            p.done.wait()
        if p.capture is not None:
            with trace.span("encode.capture"):
                p.capture()
        with trace.span("encode.collect"):
            got = self._collect(p)
        p.batch.out += got
        if p.batch.each is not None:
            for r in got:
                p.batch.each(r)

    def pass_bytes(self, images: int) -> int:
        """The pass budget's estimate of a pass over ``images`` images:
        each bucket's coder words weighted by its coder's divisor, at
        ``PASS_PEAK_BYTES`` per ``PASS_WORDS``, and at most
        ``PASS_PEAK_BYTES`` (a bucket past ``CALL_WORDS`` is coded in
        calls)."""
        words = max(b["words"] * CODER_DIVISORS[b["coder"]]
                    for b in self.buckets)
        return min(PASS_PEAK_BYTES,
                   images * words * PASS_PEAK_BYTES // PASS_WORDS)

    def pass_key(self, x: torch.Tensor) -> tuple:
        """Every field that fixes the shapes of a device pass over ``x``:
        the key of its captured graph."""
        coders = tuple((b["coder"], ES.fused_key_ok(bucket_sizes(b["L"])[0]),
                        b["call_rows"]) for b in self.buckets)
        return (self.w, self.h, self.stages, self.filt, self.segments,
                self.mag_bits, x.shape[0], coders, self.plane_cuts,
                self.lane_share, str(x.device))

    def device_pass(self, x: torch.Tensor) -> tuple:
        """The device half of one pass over the (B, h, w) int32 images
        ``x``: (overflow, ll_mean, then words, payload, total bits and
        flag of each bucket that ``_coded`` lists).  It reads only ``x``
        and the device tables and holds no host copy or sync, so it can
        be captured.  On the card it marks each stage as it queues it,
        and the end of the pass (utils/trace ``mark``)."""
        trace.mark(trace.TRANSFORM, x)
        img, ll_mean, overflow = self.transform(x)
        trace.mark(trace.CONTEXT_MODEL, x)
        emitted = [self.emit(g, img) for g in self.groups]
        del img
        outs = [overflow, ll_mean]
        for bi, _gis in self._coded:
            b = self.buckets[bi]
            trace.mark(trace.CODER_INPUT, x)
            words = self.bucket_words(b, emitted)
            for gi in b["groups"]:      # each group is in one bucket
                emitted[gi] = None
            outs += [words, *self._code(b, words)]
        trace.mark(trace.END, x)
        return tuple(outs)

    def _dispatch(self, x: torch.Tensor):
        """One device pass over the (B, h, w) images ``x`` (a graph replay
        where ``graph`` and the key is captured), then the copies back.
        Returns (checks, fetched, capture): the host copies of the checks
        and of each coded bucket's payload, total and flag, and the
        capture the collector makes for this pass's key once its copies
        are done (or None).  No device output outlives the copies: a
        collector that finds flagged lanes runs the pass again."""
        state, capture = "eager", None
        cache = graph_cache.CACHE
        # another thread's replay of the key must not come between this
        # replay and the copies that read its outputs
        with cache.lock if self.graph else contextlib.nullcontext():
            if self.graph:
                key = self.pass_key(x)
                outs, state = cache.run(key, self.device_pass, x)
            else:
                outs = self.device_pass(x)
            fetched = [tuple(to_host(t) for t in outs[i + 1:i + 4])
                       for i in range(2, len(outs), 4)]
            checks = to_host(outs[0]), to_host(outs[1])
        if state == "capture":
            capture = functools.partial(
                cache.capture, key, self.device_pass, x, outs,
                owner=self, estimate=self.pass_bytes(x.shape[0]))
        return checks, fetched, capture

    def _collect(self, p: _Pass):
        """The host half of the pass ``p`` after its copies are done.  Only
        its first ``p.real`` images are the caller's (the rest pad the
        pass, and their all-zero transform cannot overflow)."""
        B, real = p.x.shape[0], p.real
        overflow, ll_mean = p.checks
        if bool(overflow):
            raise IcerError(IcerStatus.INTEGER_OVERFLOW, "wavelet transform")
        means = ll_mean.numpy()[:real]
        if (means > (1 << self.mag_bits) - 1).any():
            raise IcerError(IcerStatus.INTEGER_OVERFLOW, "ll mean")

        trace.count("encode.lanes", real * self.lanes_per_image)
        tables: list[dict] = [{} for _ in range(real)]
        redo = []      # (image, key, bucket, row) of every flagged lane
        for bi, ((_b, gis), (payload, total, flag)) in enumerate(
                zip(self._coded, p.fetched)):
            payload = payload.numpy()
            total = total.numpy()
            flag = flag.numpy()
            r = 0
            for gi in gis:
                lanes = self.groups[gi]["lanes"]
                lo, hi = self.groups[gi]["cut"]
                for img_i in range(real):
                    for lsb in range(lo, hi):
                        for l in lanes:
                            key = (l.stage, l.subband, lsb, l.seg)
                            if flag[r] and not l.dummy:
                                redo.append((img_i, key, bi, r))
                            elif not l.dummy:
                                nb = int(total[r])
                                tables[img_i][key] = (
                                    payload[r, :(nb + 7) // 8].tobytes(), nb)
                            r += 1
                r += (B - real) * (hi - lo) * len(lanes)   # the padding's
        if redo:
            with trace.span("encode.host_reencode"):
                # the pass again, eagerly: its words are a function of its
                # input and the device tables alone, so they are the words
                # it coded (no pass holds them for this rare case)
                with graph_cache.CACHE.lock if self.graph \
                        else contextlib.nullcontext():
                    words = self.device_pass(p.x)[2::4]
                coded = self._host_encode(words,
                                          [(bi, r) for *_, bi, r in redo])
            for (img_i, key, _bi, _r), res in zip(redo, coded):
                tables[img_i][key] = res
        return [(tables[i], int(means[i])) for i in range(real)]

    def _host_encode(self, words, rows):
        """Exact host re-encode of flagged lanes: ``rows`` lists (bucket,
        row) of the pass's bucket words ``words``, in bucket order.  The
        rows are gathered on the device (one ``index_select`` per bucket),
        copied to the host at once, and coded by one threaded native
        batch; each lane codes its bucket's whole padded length (the
        invalid words are skipped).  Returns (payload bytes, bit length)
        per row."""
        t0 = time.perf_counter()
        picks, lengths = [], []
        for bi, grp in itertools.groupby(rows, key=lambda br: br[0]):
            idx = torch.as_tensor([r for _b, r in grp],
                                  device=words[bi].device)
            picks.append(words[bi].index_select(0, idx).reshape(-1))
            lengths += [words[bi].shape[1]] * len(idx)
        w = torch.cat(picks).cpu().numpy()
        lengths = np.asarray(lengths, np.int64)
        out, bits = native_backend.encode_batch_native(
            w & 1, (w >> 1) & 31, (w >> 6) & 1,
            np.cumsum(lengths) - lengths, lengths)
        res = [(out[k, :(nb + 7) // 8].tobytes(), nb)
               for k, nb in enumerate(map(int, bits))]
        self.fallback_lanes += len(rows)
        trace.count("encode.host_reencode_lanes", len(rows))
        self.fallback_seconds += time.perf_counter() - t0
        return res
