#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``icer_compression_tpu_torch``).

Run from the repository root on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py

It builds every CUDA kernel from ``icer_compression_tpu_torch/csrc`` (one
``nvcc`` per source, in parallel, into ``build/``; each fresh library
passes its first-use check, every kernel it holds against its plain
version, before it takes its final name) and prints each check's seconds
and instances; removes one library and loads it again, which must rerun
the check and pass it; builds the native host runtime
(``backend/native/icer_runtime.cpp``, ``g++``, into ``build/``); then:

  1. holds kernel 1 (slim encode coder) bit-equal to its plain PyTorch
     version on boat 512's stage-1 emission words, on a noisy block that
     overflows the eviction side buffer and on a block whose lanes need
     the reorder-window eviction; its two-word instance on that eviction
     block, on a block of 33,024 steps whose allocation ordinals pass
     2^15, on the first-use check's block of 133,120 steps whose
     ordinals pass 2^17 and whose evictions pass 32, with the side buffer
     the encoder sizes, and on the noisy block with the TPU kernel's 32
     side-buffer rows, which flags the lanes past them as the fused-key
     instance does (those three blocks' plain versions run on the host
     CPU);
  2. holds kernel 2 (multi-round plane decoder) bit-equal to its plain
     version on a crop of boat, lossless and at a truncating quota;
  3. drives the main path: boat 512 lossless (stages 4, filter A, 6
     segments) must hash to tests/data/golden_boat512.sha256 and decode to
     the input; quota 50,000 must match tests/data/golden_boat512_q50000
     .sha256 for the stream and the decoded pixels; kernels 1, 2 and W1
     must have launched, and every bucket of boat must stay on kernel 1;
  4. encodes and decodes a batch of 8 noisy variants of boat, pixel-exact;
  5. times encode, decode and kernels 1-2 (CUDA events) beside their
     bounds; kernel 2 over all four units of the decode at once, against
     the sum of its launches one by one (the units overlap on the card);
  6. holds kernels 4 and 5 (full state-machine coder, tiles of 32 and of
     8 steps) bit-equal to their plain version on boat's shortest bucket,
     on a reorder-window eviction block, on a random block whose length is
     no multiple of either tile (lanes of different valid lengths, an
     all-empty lane, all-empty tiles inside lanes) and on boat's compacted
     stage-1 block cut to 2,000 rows, and kernel 5 equal to kernel 4 on
     every bucket of boat (its path);
  7. drives the ``pallas`` coder backend (kernel 4): boat lossless golden
     sha and the quota-50,000 pins; its host re-encode lanes must be the
     lanes where kernel 1 evicts or a lane overflows its compacted length
     or payload cap, and each lane's payload from the native runtime must
     equal the sequential coder's on the same words;
  8. drives the ``sorted`` coder backend: the same golden sha, pins and
     native payloads;
  9. encodes a 256x256 crop at one stage and one segment (lanes of 32,768
     slots, kernel 1's two-word mode): ``slim``, ``pallas`` and
     ``sorted`` must give one stream, equal to its pin in
     tests/data/golden_long_lanes.sha256, with native payloads equal to
     the sequential coder's, and it must decode pixel-exact;
 10. holds the quota-class encode (quotas 5,000, 20,000, 50,000) equal to
     the full encode then allocation;
 11. continues each unit of boat's decode plan with kernel 3 (seeded
     single-plane decode) after kernel 2's first R-1 rounds: it must equal
     kernel 2's R rounds; kernel 3 bit-equal to its plain version;
 12. times kernels 3-5 beside their bounds, kernels 4 and 5 also per
     valid step of the longest lane and with the share of their tiles
     that hold no valid step (the chain skips those);
 13. forces retirement in the middle of lanes of boat's decode plan (a
     middle round's plane missing, or its frozen length cut to 1-8 bits
     so that stream errors land inside the round with later rounds
     present) and holds kernel 2 bit-equal to its plain version there on
     the stage-4 unit, with the canvas in shared memory and in device
     memory;
 14. holds kernels 2 and 3 with the canvas forced into device memory
     bit-equal to the shared-memory placement on every unit of boat's
     plan;
 15. encodes boat at one stage and one segment (256x256 lanes, through
     the ``pallas`` coder, whose block kernel 5 is held to) and
     decodes it with kernel 2 on a canvas too large for shared memory:
     pixel-exact; kernel 5 equals kernel 4 on that encode's block, whose
     opening emissions pass 2^16.
 16. drives the colour main path: a 512x512 RGB made from boat (R = boat,
     G = boat rolled 7 columns to the right, B = boat transposed),
     converted with the port's ``rgb_to_ycbcr``, through ``compress_yuv``
     and ``decompress_yuv`` at stages 4, filter A, 6 segments; uint16
     unlimited and at 150,000 bytes, and uint8 (the planes // 3)
     unlimited, must match tests/data/golden_color512.sha256 (streams and
     decoded planes, made with the JAX package by
     scripts/pin_color512.py); the unlimited decodes return Y, U and V
     exactly; kernels 1 and 2 must have launched; kernel 1 on the uint8
     path's shortest bucket and kernel 2 on its smallest unit (lsb0 6,
     mag_bits 7) bit-equal to their plain versions; colour walls and
     kernel times;
 17. a batch of 4 colour variants (seeded noise of +-6, seed 1234) through
     ``compress_yuv_batch`` and ``decompress_yuv_batch``, unlimited and at
     150,000 bytes: each stream equals ``compress_yuv`` of its image and
     each decode ``decompress_yuv`` of its stream;
 18. four grayscale batches of 8 (phase 4's recipe) through
     ``encode_batch(defer=True)`` and ``decompress_batch(defer=True)``
     with K collectors open, each dispatch half under
     ``torch.cuda.set_sync_debug_mode("error")``: streams and pixels equal
     the synchronous calls; walls for K = 4 and K = 1 in turns;
 19. runs the CLI (``cli.main``) in a temporary directory on PNGs written
     by the port's ``image_io``: the -G and -c round trips equal the API,
     and batch-compress / batch-decompress of a mixed-geometry folder
     (boat, its 256x256 centre, boat again; --batch-size 2) equal the
     single-image path;
 20. the long-lane geometries at the CLI's defaults (stages 4, filter A,
     6 segments), whose stage-1 lanes run kernel 1's two-word instance:
     boat tiled to 1024x1024 with seeded noise and its 999x601 crop
     through ``compress``/``decompress`` (lossless and quota 200,000) and
     7 variants through ``compress_batch``/``decompress_batch`` (also
     decoded in passes under a lowered blob cap, and one by one), and
     1024x1024 colour through ``compress_yuv``/``decompress_yuv``: every
     stream and decode equals its pin (tests/data/golden_long_lanes
     .sha256, made with the JAX package by scripts/pin_long_lanes.py);
     kernel 2's canvas placement on the 1024x1024 stage-1 unit (held
     equal to device memory), kernel 1's two-word stage-1 launch time
     (beside the earlier instance's 15.484 ms, PERF.md) and its plain
     version there (on the host CPU), and the peak device memory per
     coder word of an encode pass in each record mode;
 21. the CLI's batch-compress and batch-decompress at their defaults
     (``--batch-size 56 --pipeline 4``) on 8 colour 1024x1024 PNGs: the
     outputs equal the API's; peak device memory of each;
 22. faulted streams through kernel 2: boat's golden stream truncated,
     randomly corrupted, with segments dropped and with a header's and a
     payload's bytes flipped (``fault_cases``, the port's
     ``utils/faults.py``), decoded one by one and as one
     ``decompress_batch``, and phase 16's colour stream corrupted through
     ``decompress_yuv``: each equals its pin in
     tests/data/golden_faults.sha256 (made with the JAX package by
     scripts/pin_faults.py); the same faults on a 64x64 crop equal their
     pins, and kernel 2 on their joint plan equals its plain version run
     on the host CPU.
 23. the host codec: boat 512 lossless through ``compress`` with
     ``backend="native"`` (the native runtime and its quota-aware tranche
     allocator) and ``"numpy"`` (per plane) must hash to the golden
     stream, quota 50,000 through ``"native"`` must match its pins, and
     the native decode must return boat; the sequential ``"python"``
     decode runs on boat's 64x64 centre crop; phase 16's colour image
     through ``compress_yuv(backend="native")`` must match the colour
     stream pins and decode through ``"native"`` to Y, U and V; each host
     wall is logged beside the card path's;
 24. multi-GPU on the one card: worlds of ``parallel/`` on
     ``torch.distributed``, each rank a process of this script
     (``--sharded-rank``) on cuda:0: one rank over NCCL, and two ranks
     over gloo (NCCL refuses two ranks on one device) as meshes 2 x 1
     (the data axis) and 1 x 2 (the seg axis).  Every rank's
     ``ShardedGrayscaleEncoder`` streams of phase 4's batch and boat must
     equal ``compress_batch``'s and boat's the golden stream, its
     ``ShardedGrayscaleDecoder`` pixels the inputs, its
     ``ShardedColorEncoder`` streams of phase 17's colour batch
     ``compress_yuv_batch``'s, and it must launch kernels 1 and 2.  Each
     world of two then runs 40 sharded fuzz trials (``utils/fuzz.py``:
     meshes 1 x 2 and 2 x 1, grayscale and colour batches of 1-4 images
     at every quota class) on both ranks, held to the native host codec
     (streams, decodes, refusals) and to each other.
 25. frames whose lanes pass 2^17 slots, at the CLI's defaults, through
     the default ``auto`` coder (kernel 1 on every bucket: the two-word
     instance on the long ones, with its side buffer sized so that no
     lane overflows it): boat tiled to 1600x1200 and to 2048x2048
     (lossless and quota 200,000), a batch of 3 at 2048x2048 in device
     passes, colour 1600x1200 through ``compress_yuv``/``decompress_yuv``,
     one 5120x3840 image lossless, and the CLI's batch-compress /
     batch-decompress -c at their defaults on 4 colour 1600x1200 PNGs:
     every stream and decode equals its pin
     (tests/data/golden_big_images.sha256, made with the JAX package by
     scripts/pin_big_images.py), lossless decodes return the input, and
     kernel 1 launches on every image and kernel 4 on none; each kernel-1
     launch's time beside its bound, the host lanes with their causes (no
     lane may be there for an eviction), the walls and the peak device
     memory; each lossless frame also through ``entropy="pallas"``
     (kernel 4 and the host re-encode of its flush lanes), the
     ``sorted`` backend's wall on 1600x1200; kernel 1's two-word instance
     bit-equal to its plain version (on the host CPU) on 1600x1200's
     stage-1 bucket and kernel 4 on its compacted block.
 26. every filter (A-F, Q), stage count (1-6), segment count (1-32) and
     sample type (uint8, uint16) that the JAX package encodes: kernel W1
     (one axis of one inverse DWT stage, csrc/wavelet.cu) bit-equal to
     its plain version, overflow word included, at every filter,
     mag_bits 7 and 15, lines of 2-9 samples on both axes, on boat 512's
     stage-1 passes at fA, fB and fC, 2048x2048's at fF and a 5120x3840
     stage-1 row pass, each timed beside its bound; the lifting path's
     integer steps (floor_div, >> on negative int32, _wrap) and
     forward_1d / inverse_1d on the card equal to the host's; boat's s4
     inverse DWT at fA and fB through W1 (8 W1 launches, at most 16
     kernels on the card) and through the plain chain, and boat's fA and
     fB decode walls both ways, in turns; a ``torch.profiler`` trace of
     the main path's encode and decode, each launch put in its layer
     (device ms, launches, host ms, idle share); the 32 configurations of
     ``config_sweep`` through ``compress`` / ``decompress`` and
     ``compress_yuv`` / ``decompress_yuv`` equal to
     tests/data/golden_configs.sha256 (made with the JAX package by
     scripts/pin_configs.py), lossless decodes returning the input
     (filter C's excepted, as in the reference), W1 launched on every
     decode, and the ``error_sweep`` cases refused with the pinned
     IcerStatus; a filter-B batch of 3 equal to the single calls (and its
     deferred decode with no host sync); the CLI's ``-f D -s 3 -g 7``
     equal to the API; a fixed-seed differential fuzz
     (``utils/fuzz.py``) against the native host codec with no mismatch.
 27. each coder's peak device memory per coder word in one encode pass of
     about 2^25 coder words and of a full pass (``PLAN_CASES``): kernel 1
     with fused-key records (boat's noisy variants) and two-word records
     (1024x1024), ``pallas`` and ``sorted``, the last also at a full pass
     sized as slim's, the plan before each coder had its own
     (``ops.encode.CODER_DIVISORS``).
 28. the ``sorted`` coder at full passes under its own plan: 9 1024x1024
     images (a slim pass, three of sorted's) and the 5120x3840 frame; each
     stream equals its pin or the ``auto`` stream of its image, and each
     peak stays within the pass budget that sizes every coder's passes
     and calls (``ops.encode.PASS_PEAK_BYTES``); walls and host re-encode
     lanes.
 29. the port's counterparts of the repository's top-level programs, each
     run as ``python -m`` in a process of its own once the host workers
     are done: ``icer_compression_tpu_torch.bench`` at its defaults
     (native, single image, 112/56 batched, 4 batches in flight, device
     time by layer) with every mode verified and boat's stream the golden
     one, its figures, memory peaks and layers logged; the four
     ``examples`` (gray on boat, colour on phase 16's RGB as a PNG) equal
     to tests/data/golden_examples.sha256 (made with the JAX package by
     scripts/pin_examples.py); ``bench_scaling --devices 1,2`` with both
     worlds' streams equal to the single-card encoder's.
 30. each encode pass and each decode pass as one captured CUDA graph per
     key (backend/graph_cache, the default on the card, so phases 1-29 run
     through them too; the graphs are dropped before phase 29) against the
     same pass run eagerly, byte for byte: boat, the bench's 112 in four
     passes of 28, one key (every dispatch half, the key's first four
     passes among them, under ``no_host_sync``), phase 4's batch of 8,
     phase 16's colour image, 1024x1024, 5120x3840 (two coder calls a
     pass), quota 50,000, and boat and a variant through ``pallas`` and
     ``sorted``
     deferred with two batches in flight; each capture's seconds and
     first-replay check; a replay's K1 / K4 runs, as the kernels count them
     on the card, equal to the eager passes', and the encode kernels'
     records by name in the profiler's trace of a replayed boat encode
     equal to an eager one's; the bytes the graph pools hold (after the
     bench's batch, after phase 21's CLI defaults and at the end) within
     their bound, one pass budget beyond their static tensors; the 37-image
     pass's pool with and without expandable segments beside its eager
     peaks; boat's encode and decode walls graph against eager in turns,
     and the API launches of one boat encode each way.  The decodes: boat's
     golden stream, the bench's 56 streams, the 11 fault pins one by one
     and as one batch, phase 16's colour stream and the 5120x3840 frame,
     each three times through the graphs against ``graph=False``, a
     replay's K2 / W1 runs counted on the card equal to the eager decode's,
     the graph pools within their bound after each; 200 round-robin decodes
     on two threads of one card (``decode_batch_sharded`` given ``[cuda,
     cuda]``) against one thread's; boat's decode walls and API launches
     graph against eager; a warm boat decode after a replayed encode, an
     eager one and ``CACHE.clear()`` (``scripts/decode_after_encode.py``).
     Phases 20, 27 and 28 measure eager encode passes (``graph=False``),
     whose peak a graph's pool holds.  Each phase's captures and their
     seconds are logged at the end.
 31. sort and pack (``csrc/slim_pack.cu``) against its plain version, the
     sort-based tail, on the card: kernel 1's outputs for every coder call
     of 1024x1024's stages 1 (two-word) and 2 (fused-key), 1600x1200's
     stages 1-2 and 5120x3840's stage 1 (two calls), payload, total and
     flag byte for byte (with the slice and the payload cap cut on the
     1024x1024 blocks, so lanes are flagged by each), each timed beside
     its bound and the plain tail; a replayed 1024x1024 encode runs sort
     and pack once per kernel 1 run in each record mode, as the kernels
     count their runs on the card.

The wrappers' ``launches`` count the launches the host issues (phase 3,
the main path, reads them on its keys' first, eager passes); a replayed
graph issues none from Python, so every other phase counts the kernels'
runs as the kernels count them on the card (``kernels.device_runs``: K1,
sort and pack, K2, K3, K4, K5 and W1 each add one to a slot of their own
as they start).

After the build it reads each kernel's registers and spills from the
compiler's ``-Xptxas -v`` log and counts the local-memory loads and stores
(LDL/STL) in its SASS (``cuobjdump -sass``): kernels 4 and 5 and kernel
1's two-word instance (``slim_encode_wide_kernel``) must have none.

Any failure raises and exits non-zero.  The line before the last is a
JSON object {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.  Without a CUDA device it exits non-zero
and prints no result.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import pickle
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

from benchmark.roofline import (  # noqa: E402
    HBM_BYTES_PER_S, INT32_OPS_PER_S)
from icer_compression_tpu_torch.utils.trace import (  # noqa: E402
    layer_breakdown)


@contextlib.contextmanager
def swapped(owner, name, value):
    """``owner.name`` replaced by ``value`` inside the block."""
    old = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, old)


# integer operations of one step, counted from the kernels' source:
# kernel 1: 16 cutoff compares + ~32 for counters, bin state, completion
# and the record per valid emission, + a 17-row scan per allocation;
# kernel 2: ~60 per decoded pixel (neighbour contexts, bin, stack).
K1_OPS_PER_VALID = 48
# an allocation checks a lower bound of the oldest open ordinal and opens
# the codeword; the 17-row scan runs only near the reorder window's edge
K1_OPS_PER_ALLOC = 6
K2_OPS_PER_PIXEL = 60
# kernels 4/5: 16 cutoff compares + ~48 for counters, bin state, codeword
# construction (golomb remainder or custom tables) and the three outputs
# per valid emission; kernel 3 decodes like kernel 2, one round
K4_OPS_PER_VALID = 64
# the tiles of kernels 4 and 5 (csrc/full_encode.cu: full_encode_launch and
# full_encode_tiled_launch), for the share of tiles their chain skips
K4_TILE, K5_TILE = 32, 8


def log(msg: str) -> None:
    print(msg, flush=True)


def color_boat(boat: np.ndarray) -> np.ndarray:
    """Phase 16's 512x512 RGB image, made from boat alone: R = boat, G =
    boat rolled 7 columns to the right, B = boat transposed."""
    return np.stack([boat, np.roll(boat, 7, axis=1), boat.T],
                    axis=-1).astype(np.uint8)


def color_planes(rgb: np.ndarray, dtype) -> tuple:
    """(y, u, v) of ``rgb`` through the port's ``rgb_to_ycbcr``: uint16
    planes, or for uint8 the planes // 3 (the JAX package's tests' recipe
    against int8 overflow on the uint8 colour path)."""
    from icer_compression_tpu_torch.utils.colorspace import rgb_to_ycbcr
    planes = rgb_to_ycbcr(rgb)
    if np.dtype(dtype) == np.uint8:
        return tuple((c // 3).astype(np.uint8) for c in planes)
    return tuple(c.astype(np.uint16) for c in planes)


def planes_sha(planes) -> str:
    """sha256 of decoded planes stacked and written as little-endian
    uint16."""
    return hashlib.sha256(np.ascontiguousarray(
        np.stack(planes), "<u2").tobytes()).hexdigest()


# (label, dtype, byte quota) of the colour pins in
# tests/data/golden_color512.sha256, stages 4, filter A, 6 segments
COLOR_PINS = (("u16 unlimited", np.uint16, None),
              ("u16 quota 150000", np.uint16, 150000),
              ("u8 unlimited", np.uint8, None))


# phase 20: stages 4, filter A, 6 segments (the CLI's defaults) at these
# byte quotas, pinned in tests/data/golden_long_lanes.sha256
LONG_LANE_QUOTAS = (None, 200000)
LONG_LANE_BATCH = 7


def long_lane_images(boat: np.ndarray) -> dict:
    """Phase 20's images: ``LONG_LANE_BATCH`` variants of boat tiled 2x2
    to 1024x1024 with noise of +-6 from ``default_rng(0)`` (the JAX
    package's geometry sweep, scripts/bench_geometry.py:42-50), their
    999x601 top-left crops, and ``color_boat`` of the tiled boat."""
    big = np.tile(boat, (2, 2)).astype(np.int32)
    rng = np.random.default_rng(0)
    gray = np.stack([np.clip(big + rng.integers(-6, 7, big.shape), 0, 255)
                     for _ in range(LONG_LANE_BATCH)]).astype(np.uint16)
    return {"gray1024": gray,
            "gray999x601": np.ascontiguousarray(gray[:, :601, :999]),
            "color1024": color_boat(big.astype(np.uint8))}


# phase 25: frames whose stage-1 lanes (and at 5120x3840 stage 2's) pass
# 2^17 slots, at the CLI's defaults and these quotas,
# pinned in tests/data/golden_big_images.sha256; a batch of BIG_BATCH at
# 2048x2048, and the CLI's batch operations on BIG_CLI colour PNGs
BIG_QUOTAS = (None, 200000)
BIG_BATCH = 3
BIG_CLI = 4
# the CLI's colour batch at its defaults (B frames, K batches in flight)
# at 2 bits per frame pixel, the benchmark's mastcamz1600 cell
COLOR_BATCH, COLOR_INFLIGHT, COLOR_QUOTA = 56, 4, 480000


def _tiled(boat: np.ndarray, h: int, w: int, n: int = 1) -> np.ndarray:
    """``n`` variants of boat tiled to (h, w) with noise of +-6 from
    ``default_rng(0)``, as ``long_lane_images`` makes its images."""
    big = np.tile(boat, (-(-h // boat.shape[0]), -(-w // boat.shape[1])))[
        :h, :w].astype(np.int32)
    rng = np.random.default_rng(0)
    return np.stack([np.clip(big + rng.integers(-6, 7, big.shape), 0, 255)
                     for _ in range(n)]).astype(np.uint16)


def big_images(boat: np.ndarray) -> dict:
    """Phase 25's images: boat tiled to 1600x1200 (Mastcam-Z's frame), to
    2048x2048 (``BIG_BATCH`` variants) and to 5120x3840 (the Mars 2020
    engineering cameras' frame), with noise as in ``_tiled``;
    ``color_boat`` of boat tiled to 1600x1600, cut to 1600x1200; and
    ``BIG_CLI`` variants of that colour image with noise of +-6 from
    ``default_rng(1234)`` (phase 21's recipe) for the CLI."""
    rgb = color_boat(np.tile(boat, (4, 4))[:1600, :1600].astype(np.uint8))[
        :1200]
    rng = np.random.default_rng(1234)
    return {"gray1600x1200": _tiled(boat, 1200, 1600),
            "gray2048": _tiled(boat, 2048, 2048, BIG_BATCH),
            "gray5120x3840": _tiled(boat, 3840, 5120),
            "color1600x1200": rgb,
            "cli1600x1200": [np.clip(rgb.astype(np.int32) + rng.integers(
                -6, 7, rgb.shape), 0, 255).astype(np.uint8)
                for _ in range(BIG_CLI)]}


def color_batch(rgb: np.ndarray, n: int = COLOR_BATCH) -> list:
    """``n`` variants of an RGB frame with noise of +-6 from
    ``default_rng(4321)``, clipped to 8 bits."""
    rng = np.random.default_rng(4321)
    return [np.clip(rgb.astype(np.int32) + rng.integers(-6, 7, rgb.shape),
                    0, 255).astype(np.uint8) for _ in range(n)]


# phase 26: the configuration sweep, pinned in
# tests/data/golden_configs.sha256: every filter, stage count, segment
# count and sample type beside the CLI's defaults (filters A-F and Q are
# CodecConfig's filt 0-6)
FILTERS = "ABCDEFQ"


def config_sweep(boat: np.ndarray) -> list:
    """Phase 26's configurations: [(label, image, dtype, (stages, filt,
    segments, quota))], ``image`` a 2-D array or, for colour, the (y, u,
    v) planes of ``color_planes``; quota None is lossless.  Boat 512 at
    s4 g6 under filters B-F and Q (lossless and 50,000 bytes) and under
    filter A at 30,000 (examples/compress_gray.py's settings); boat // 2
    as uint8 (the signed 8-bit range the uint8 DWT holds); stages 1-6 at
    filter D and segments 1-32 at filter Q; phase 20's 999x601 crop and
    a 333x257 crop of it (its smallest subband at s6 holds 20 pixels);
    phase 25's 1600x1200 and 2048x2048; phase 16's colour image."""
    def f(c):
        return FILTERS.index(c)

    def tag(q):
        return "lossless" if q is None else f"q{q}"

    u8 = (boat // 2).astype(np.uint8)
    odd = long_lane_images(boat)["gray999x601"][0]
    big = big_images(boat)
    rgb = color_boat(boat.astype(np.uint8))
    cases = [(f"boat512 u16 f{c} s4 g6 {tag(q)}", boat, np.uint16,
              (4, f(c), 6, q)) for c in "BCDEFQ" for q in (None, 50000)]
    cases += [("boat512 u16 fA s4 g6 q30000", boat, np.uint16,
               (4, 0, 6, 30000)),
              ("boat512//2 u8 fA s4 g6 lossless", u8, np.uint8,
               (4, 0, 6, None)),
              ("boat512//2 u8 fE s4 g6 q30000", u8, np.uint8,
               (4, f("E"), 6, 30000))]
    cases += [(f"boat512 u16 fD s{s} g6 lossless", boat, np.uint16,
               (s, f("D"), 6, None)) for s in (1, 2, 3, 5, 6)]
    cases += [(f"boat512 u16 fQ s4 g{g} lossless", boat, np.uint16,
               (4, f("Q"), g, None)) for g in (1, 2, 7, 16, 32)]
    cases += [(f"999x601 u16 fF s5 g13 {tag(q)}", odd, np.uint16,
               (5, f("F"), 13, q)) for q in (None, 100000)]
    cases += [("333x257 u16 fC s6 g16 lossless",
               np.ascontiguousarray(odd[:257, :333]), np.uint16,
               (6, f("C"), 16, None)),
              ("1600x1200 u16 fB s4 g6 lossless", big["gray1600x1200"][0],
               np.uint16, (4, f("B"), 6, None)),
              ("2048x2048 u16 fF s6 g32 lossless", big["gray2048"][0],
               np.uint16, (6, f("F"), 32, None)),
              ("color512 u16 fC s5 g10 lossless",
               color_planes(rgb, np.uint16), np.uint16,
               (5, f("C"), 10, None)),
              ("color512 u8 fE s4 g6 q150000", color_planes(rgb, np.uint8),
               np.uint8, (4, f("E"), 6, 150000))]
    return cases


def error_sweep(boat: np.ndarray) -> list:
    """Phase 26's error-parity cases: [(label, image, (stages, filt,
    segments, quota))], ``image`` a 2-D array or colour (y, u, v) planes,
    each refused with the IcerStatus that tests/data/golden_configs.sha256
    pins: stages past the 3-pixel LL rule, 33 segments, more segments than
    LL pixels, boat's raw uint8 samples and a 0/65535 checkerboard at
    every filter (DWT overflow); uint8 colour at 5 stages, whose packet
    list passes the reference's 300 entries, as phase 16's planes // 3
    (the packet count) and as its raw uint8 planes (the DWT overflows,
    which the reference finds first)."""
    crop = boat[:64, :64]
    board = ((np.add.outer(np.arange(64), np.arange(64)) & 1)
             * 65535).astype(np.uint16)
    cases = [("64x64 s7 g6", crop, (7, 0, 6, None)),
             ("64x64 s2 g33", crop, (2, 0, 33, None)),
             ("128x128 s5 g20", boat[:128, :128], (5, 0, 20, None)),
             ("boat512 u8 fA s4 g6", boat.astype(np.uint8), (4, 0, 6, None))]
    cases += [(f"checkerboard 64x64 f{c} s4 g6", board, (4, i, 6, None))
              for i, c in enumerate(FILTERS)]
    rgb = color_boat(boat.astype(np.uint8))[208:304, 208:304]
    raw = tuple(p.astype(np.uint8)
                for p in color_planes(rgb, np.uint16))
    cases += [("color 96x96 u8 fA s5 g6", color_planes(rgb, np.uint8),
               (5, 0, 6, None)),
              ("color 96x96 raw u8 fA s5 g6", raw, (5, 0, 6, None))]
    return cases


def read_config_pins(path) -> tuple:
    """({label: (stream sha, pixels sha)}, {label: IcerStatus name}) of a
    pin file written by scripts/pin_configs.py."""
    good, bad = {}, {}
    for ln in Path(path).read_text().splitlines():
        head, label = ln.split("  ", 1)
        fields = head.split()
        if len(fields) == 2:
            good[label] = tuple(fields)
        else:
            bad[label] = fields[0]
    return good, bad


# phase 22: boat's 64x64 centre crop, whose faulted streams kernel 2 also
# decodes against its plain version (on the host CPU), and the colour
# fault (corrupt_random's n and seed) on phase 16's unlimited uint16 stream
FAULT_CROP = (slice(224, 288), slice(224, 288))
COLOR_FAULT = 16


def fault_cases(stream: bytes, faults) -> list:
    """Phase 22's faulted copies of ``stream``: [(label, bytes)], made with
    ``faults`` (the port's ``utils.faults``, or the JAX package's in
    scripts/pin_faults.py): progressive prefixes, random byte flips, a
    dropped segment, every stage-1 packet at lsb 0 dropped, one header's
    bytes and one payload byte flipped."""
    census = faults.segment_census(stream)
    sizes = np.array([28 + c[5] for c in census])   # header + payload bytes
    starts = np.cumsum(sizes) - sizes
    hk = len(census) // 3
    pk = next(k for k in range(len(census) // 2, len(census))
              if census[k][5] > 0)
    return ([(f"truncate {f}", faults.truncate(stream, f))
             for f in (0.2, 0.5, 0.9)]
            + [(f"corrupt_random {n}", faults.corrupt_random(stream, n,
                                                              seed=n))
               for n in (1, 4, 16, 64)]
            + [("drop finest HH segment 0", faults.drop_segments(
                stream, lambda h: h.decomp_level == 1
                and h.subband_type == 3 and h.segment_number == 0)),
               ("drop stage 1 lsb 0", faults.drop_segments(
                   stream, lambda h: h.decomp_level == 1 and h.lsb == 0)),
               (f"flip header {hk}", faults.flip_bytes(
                   stream, range(starts[hk], starts[hk] + 28))),
               (f"flip payload {pk}", faults.flip_bytes(
                   stream, [starts[pk] + 28 + census[pk][5] // 2]))])


def pixels_sha(px: np.ndarray) -> str:
    """sha256 of decoded pixels written as little-endian uint16."""
    return hashlib.sha256(np.ascontiguousarray(px, "<u2").tobytes()) \
        .hexdigest()


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def sync_time(fn):
    """(result, seconds) of fn(), synchronised on both ends."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def event_ms(fn, reps: int = 5, warm: int = 1) -> float:
    """Median device time of fn() in ms (CUDA events, after warm-up)."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def assert_equal(name, a, b) -> int:
    """Bit-equality of two int tensors; returns the max abs difference."""
    err = int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) \
        if a.numel() else 0
    if a.shape != b.shape or err != 0:
        raise AssertionError(f"{name}: kernel and plain version differ "
                             f"(shapes {tuple(a.shape)} {tuple(b.shape)}, "
                             f"max abs diff {err})")
    return err


def _plain_job(kind, ins, nev):
    """One plain version on the host CPU, in a worker of ``HostPlain``:
    kernel 1's two-word instance (``"k1w"``, with ``nev`` side-buffer
    rows) or kernel 4 (``"k4"``) on CPU tensors.  Returns (outputs,
    seconds)."""
    from icer_compression_tpu_torch.ops import entropy_full as EF
    from icer_compression_tpu_torch.ops import entropy_slim as ES
    torch.set_num_threads(1)
    t0 = time.perf_counter()
    if kind == "k1w":
        out = ES.encode_lanes_slim_plain(*ins, two_word=True, nev=nev)
    else:
        out = EF.encode_lanes_full_plain(*ins)
    return out, time.perf_counter() - t0


class HostPlain:
    """The plain versions that run on the host CPU (a loop of small
    per-step ops costs less there than as launches on the card), each in
    a worker process started as soon as its inputs exist, so that they run
    beside the card phases.  ``check`` waits for one and holds a kernel's
    outputs to it at tolerance 0.  The workers are spawned (they never
    touch the card) and stopped on exit."""

    def __init__(self, workers: int = 4):
        import concurrent.futures
        import multiprocessing
        self.pool = concurrent.futures.ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn"))
        self.jobs = {}

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.pool.shutdown(wait=True, cancel_futures=True)

    def submit(self, name, kind, ins, nev=None):
        self.jobs[name] = self.pool.submit(_plain_job, kind,
                                           tuple(t.cpu() for t in ins), nev)

    def check(self, name, outs, names):
        """(max abs error, plain seconds) of the kernel's ``outs`` against
        job ``name``, output by output."""
        ref, secs = self.jobs.pop(name).result()
        return max(assert_equal(f"{name} {nm}", a.cpu(), b)
                   for nm, a, b in zip(names, outs, ref)), secs


def noisy_eviction_words(rng, L=16384, lanes=32, warm=3072, feed=144):
    """Skewed contexts warmed up into many bins, then uncoded emissions
    with one zero fed to each context in turn every 16 * ``feed`` steps:
    each feed opens a codeword that the reorder window evicts later, so
    lanes collect more than the 32-row side buffer holds."""
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
    return torch.from_numpy((1 | (ctx << 1) | (bit << 6)).astype(np.int32))


def bound(nbytes: int, ops: int):
    """(least time in ms, "bytes" or "operations") for work that must move
    ``nbytes`` through HBM and do ``ops`` int32 operations."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / INT32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def k1_bound(words, misc, nev=None, nvalid=None):
    """Kernel 1: words in, records out (one word per step, two in the
    two-word mode), state rows out (the two-word mode with ``nev`` rows of
    each side-buffer output and the open ordinals); ops from this run's
    valid emissions (``nvalid``, else counted in ``words``; with
    ``nvalid``, ``words`` may be its shape) and allocations."""
    L, lanes = getattr(words, "shape", words)
    rows = 17 + 8 + 32 if nev is None else 17 + 8 + 2 * nev + 17
    nbytes = 4 * ((2 if nev is None else 3) * L * lanes + rows * lanes)
    if nvalid is None:
        nvalid = int((words & 1).sum())
    ops = (K1_OPS_PER_VALID * nvalid
           + K1_OPS_PER_ALLOC * int(misc[1].sum()))
    return bound(nbytes, ops)


def k2_bound(unit, pos):
    """Kernel 2: the payload bytes the lanes consumed, the plan rows in,
    the canvas and flags out; ops from the pixels of the rounds run."""
    R, n = unit["offs"].shape
    p = pos.cpu().numpy().astype(np.int64)
    nbytes = (int(((p + 7) // 8).sum()) + 4 * (2 * R * n + 4 * n)
              + 4 * (unit["hmax"] * unit["wmax"] * n + n + R * n))
    area = unit["geom"][0].astype(np.int64) * unit["geom"][1]
    ops = K2_OPS_PER_PIXEL * int(((p > 0) * area).sum())
    return bound(nbytes, ops)


def k4_bound(valid, nvalid=None):
    """Kernels 4/5: three words in per step, three out per row (incl. the
    17 flush rows); ops from this run's valid emissions (``nvalid``, else
    counted in ``valid``; with ``nvalid``, ``valid`` may be its shape)."""
    L, lanes = getattr(valid, "shape", valid)
    nbytes = 4 * (3 * L * lanes + 3 * (L + 17) * lanes)
    if nvalid is None:
        nvalid = int(valid.sum())
    return bound(nbytes, K4_OPS_PER_VALID * nvalid)


def k3_bound(unit, pos, active):
    """Kernel 3: the payload bytes the active lanes consumed, the plan
    rows, the seed canvas in and the canvas, err and pos out; ops from the
    pixels of the active lanes."""
    n = unit["offs"].shape[1]
    p = pos.cpu().numpy().astype(np.int64)
    px = unit["hmax"] * unit["wmax"] * n
    nbytes = int(((p + 7) // 8).sum()) + 4 * (7 * n) + 4 * (2 * px + 2 * n)
    area = unit["geom"][0].astype(np.int64) * unit["geom"][1]
    ops = K2_OPS_PER_PIXEL * int((active.cpu().numpy() * area).sum())
    return bound(nbytes, ops)


def long_ordinal_words(rng, L=33024):
    """Kernel 1's emission words for three lanes whose allocation ordinals
    pass 2^15: uncoded emissions (each one allocates a codeword); lanes 1
    and 2 also feed a zero every 150 (400) steps to one (one of two)
    contexts, which skew into golomb bins whose runs stay open until the
    reorder window evicts them."""
    t = np.arange(L)[:, None]
    feed = np.array([[L + 1, 150, 400]])
    fed = t % feed == 0
    ctx = np.where(fed, (t // feed) % np.array([[1, 1, 2]]), 17)
    bit = np.where(fed, 0, rng.integers(0, 2, (L, 3)))
    return torch.from_numpy((1 | (ctx << 1) | (bit << 6)).astype(np.int32))


TWO_WORD_OUTS = ("rec1", "rec2", "fstate", "misc", "ev1", "ev2", "fopen")


def top_ordinal(out) -> int:
    """Largest allocation ordinal that kernel 1's two-word outputs write:
    over the completed records and the evictions."""
    rec1, rec2, _fs, _misc, ev1, ev2, _fopen = out
    return max(int(torch.where(rec1 != 0, rec2, 0).max()),
               int(torch.where(ev1 != 0, ev2, 0).max()))


def eviction_lanes(rng, L=2432, lanes=128):
    """A golomb run held open while uncoded codewords allocate behind it:
    lanes past ~2048 allocations need the reorder-window eviction."""
    warm = 64
    n_unc = np.arange(lanes) * 17 + 90
    valid = np.ones((L, lanes), np.int32)
    ctx = np.full((L, lanes), 17, np.int32)
    bit = rng.integers(0, 2, (L, lanes)).astype(np.int32)
    ctx[:warm] = 0
    bit[:warm] = 0
    valid[warm:] = np.arange(L - warm)[:, None] < n_unc[None, :]
    return [torch.from_numpy(a) for a in (valid, ctx, bit)]


def edge_lanes(rng, L=2500, lanes=40):
    """Random emissions (skewed contexts, some uncoded) at a length that is
    no multiple of 64, 32 or 8: lane j holds its valid steps in its first
    ~j/lanes of the rows, lane 0 none, odd lanes lose 10% of them at
    random and every third lane has a 300-row hole of empty steps inside
    (whole empty tiles in the middle of a lane)."""
    ctx = rng.integers(0, 20, (L, lanes))
    p = rng.random((20, lanes))
    bit = rng.random((L, lanes)) < p[ctx, np.arange(lanes)]
    n = (np.arange(lanes) * L) // (lanes - 1)
    valid = np.arange(L)[:, None] < n[None, :]
    valid[:, 1::2] &= rng.random((L, lanes // 2)) < 0.9
    for j in range(3, lanes, 3):
        a = int(rng.integers(100, max(101, n[j] - 400)))
        valid[a:a + 300, j] = False
    return [torch.from_numpy(a.astype(np.int32)) for a in (valid, ctx, bit)]


def tile_busy(valid, tile):
    """(tiles, lanes) bool: the tiles of ``tile`` rows that hold a valid
    step (the last tile masked)."""
    L, lanes = valid.shape
    v = torch.cat([valid != 0, torch.zeros((-L % tile, lanes),
                                           dtype=torch.bool,
                                           device=valid.device)])
    return v.reshape(-1, tile, lanes).any(dim=1)


def tile_stats(valid, tile):
    """(share of a block's tiles of ``tile`` rows with no valid step, valid
    steps of its longest lane)."""
    busy = tile_busy(valid, tile)
    return 1.0 - float(busy.float().mean()), int((valid != 0).sum(0).max())


def kernel_resources(kernels):
    """Per kernel function of every library: registers, stack frame and
    spill bytes from this build's ``-Xptxas -v`` log (when this process
    built it) and the count of local-memory loads and stores (LDL/STL) in
    its SASS (``cuobjdump -sass``)."""
    res = {}

    def short(mangled):
        # a mangled name spells each identifier after its length
        m = re.search(r"\d([a-z_]+_kernel)(I\w*?E)?E", mangled)
        if not m:
            return mangled
        targs = m.group(2) or ""
        ints = re.findall(r"L[ib](\d+)E", targs)
        return m.group(1) + (f"<{','.join(ints)}>" if ints else targs)

    for name in kernels.KERNELS:
        fn = None
        for ln in kernels.BUILD_LOGS.get(name, "").splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", ln)
            if m:
                fn = short(m.group(1))
                res.setdefault(fn, {})
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", ln)
            if m and fn:
                res[fn].update(stack=int(m.group(1)), spill_st=int(m.group(2)),
                               spill_ld=int(m.group(3)))
            m = re.search(r"Used (\d+) registers", ln)
            if m and fn:
                res[fn]["regs"] = int(m.group(1))
        cuobjdump = Path(kernels._nvcc()).parent / "cuobjdump"
        sass = subprocess.run([str(cuobjdump), "-sass",
                               str(kernels.lib_path(name))],
                              capture_output=True, text=True,
                              check=True).stdout
        fn = None
        for ln in sass.splitlines():
            m = re.search(r"Function : (\S+)", ln)
            if m:
                fn = short(m.group(1))
                res.setdefault(fn, {})["ldl_stl"] = 0
            elif fn and re.search(r"\b(LDL|STL)(\.\w+)*\b", ln):
                res[fn]["ldl_stl"] += 1
    return res


def eviction_words(rng):
    """``eviction_lanes`` as kernel 1's emission words, padded with empty
    steps to a multiple of the coder's chunk."""
    from icer_compression_tpu_torch.ops.entropy_slim import CHUNK
    valid, ctx, bit = eviction_lanes(rng)
    words = valid | (ctx << 1) | (bit << 6)
    pad = -words.shape[0] % CHUNK
    return torch.cat([words, torch.zeros((pad, words.shape[1]),
                                         dtype=torch.int32)])


def watch_host_lanes(enc) -> list:
    """Record every batch of ``enc``'s exact host re-encodes: (the pass's
    bucket words, the (bucket, row) list, the native results).  Only
    references are kept, so the encode's wall is not perturbed."""
    seen = []
    real = enc._host_encode

    def host_encode(words, rows):
        res = real(words, rows)
        seen.append((words, rows, res))
        return res

    enc._host_encode = host_encode
    return seen


def check_host_lanes(name, seen, lanes=None) -> int:
    """Each native payload recorded by ``watch_host_lanes`` equals the
    sequential coder's (``backend/sequential.encode_emissions``, the
    encoder's host path before the native runtime) on the same words;
    returns (lanes checked, seconds of the sequential coder).  ``lanes``,
    a list, gets (bucket, row, bits, evictions) of each lane."""
    from icer_compression_tpu_torch.backend import sequential
    n, secs = 0, 0.0
    for words, rows, res in seen:
        for (bi, r), got in zip(rows, res):
            w = words[bi][r].cpu().numpy()
            t0 = time.perf_counter()
            pl, nb, nflush = sequential.encode_emissions(
                w & 1, (w >> 1) & 31, (w >> 6) & 1)
            secs += time.perf_counter() - t0
            if got != (pl, nb):
                raise AssertionError(
                    f"{name}: native host re-encode of bucket {bi} row {r} "
                    f"differs from the sequential coder ({got[1]} against "
                    f"{nb} bits)")
            if lanes is not None:
                lanes.append((bi, r, nb, nflush))
            n += 1
    return n, secs


def long_lane_phase(dev, card, crop, pins):
    """Phase 9: one stage, one segment: lanes of 2 * (side / 2)^2 slots,
    32,768 for a 256x256 crop, past the slim coder's fused-key limit (its
    two-word mode).  ``slim``, ``pallas`` and ``sorted`` must give one
    stream, equal to its pin; the decode is pixel-exact."""
    from icer_compression_tpu_torch.models import grayscale as T
    from icer_compression_tpu_torch.ops import entropy_slim as ES
    h, w = crop.shape
    lcfg = T.CodecConfig(1, 0, 1, None)
    lenc = {e: T.make_encoder(w, h, lcfg, np.uint16, dev, entropy=e)
            for e in ("slim", "pallas", "sorted")}
    seen = {e: watch_host_lanes(enc) for e, enc in lenc.items()}
    ES.encode_lanes_slim_two_word.launches = 0
    reset_runs()
    streams, walls = {}, {}
    for e, enc in lenc.items():
        streams[e], walls[e] = sync_time(
            lambda enc=enc: T.compress_batch(crop[None], lcfg,
                                             encoder=enc)[0])
    launches = encode_runs()["slim_encode_two_word"]
    if len(set(streams.values())) != 1:
        raise AssertionError("long lanes: slim, pallas and sorted streams "
                             "differ")
    s = streams["slim"]
    if hashlib.sha256(s).hexdigest() != \
            pins["crop256 s1 g1 unlimited stream"]:
        raise AssertionError("long lanes: stream differs from its pin")
    if launches <= 0:
        raise AssertionError("long lanes: the two-word instance of kernel 1 "
                             "did not launch")
    d = T.decompress(s, lcfg, np.uint16, dev)
    if not np.array_equal(d, crop) or \
            pixels_sha(d) != pins["crop256 s1 g1 unlimited decoded"]:
        raise AssertionError("long lanes: decode differs from the crop")
    checked = {e: check_host_lanes(f"long lanes {e}", seen[e]) for e in seen}
    log(f"long lanes ({w}x{h}, 1 stage, 1 segment: "
        f"{lenc['slim'].buckets[0]['L']} slots): slim (two-word K1, "
        f"{launches} launch(es)) == pallas == sorted == pin ({len(s)} B), "
        "decode pixel-exact; "
        + "; ".join(f"{e}: encode wall (run once) {walls[e]:.3f} s, host "
                    f"re-encode lanes {enc.fallback_lanes} in "
                    f"{enc.fallback_seconds:.4f} s ({checked[e][0]} native "
                    "payloads == sequential, which took "
                    f"{checked[e][1]:.3f} s)"
                    for e, enc in lenc.items()) + f" | {card}")
    return {"launches": launches,
            "walls": {e: (walls[e], lenc[e].fallback_lanes,
                          lenc[e].fallback_seconds, checked[e][1])
                      for e in lenc}}


def later_phases(dev, card, boat, img, slim_words, stream, golden, pins,
                 cfg, cfg50, long_pins):
    """Phases 6-12; returns phase 9's launches of kernel 1's two-word
    instance and the kernels-line entries of kernels 3, 4 and 5."""
    from icer_compression_tpu_torch.models import decode as D
    from icer_compression_tpu_torch.models import grayscale as T
    from icer_compression_tpu_torch.ops import encode as E
    from icer_compression_tpu_torch.ops import entropy_full as EF
    from icer_compression_tpu_torch.ops import entropy_slim as ES
    from icer_compression_tpu_torch.ops import plane_decode as PDc

    h, w = boat.shape

    def sha(b):
        return hashlib.sha256(b).hexdigest()

    def pixel_sha(px):
        return sha(np.ascontiguousarray(px, "<u2").tobytes())

    # ---- phase 6: kernels 4 and 5 vs their plain version ---------------
    penc = T.make_encoder(w, h, cfg, np.uint16, dev, entropy="pallas")
    emitted = [penc.emit(g, img) for g in penc.groups]
    k4_in = []
    for b in penc.buckets:
        Lc = E.bucket_sizes(b["L"])[1]
        cw, _over = E.compact_words(penc.bucket_words(b, emitted), Lc)
        k4_in.append([t.t().contiguous() for t in E._split_words(cw)])
    short = k4_in[-1]
    evict = [t.to(dev) for t in eviction_lanes(np.random.default_rng(5))]
    edge = [t.to(dev) for t in edge_lanes(np.random.default_rng(11))]
    head = [t[:2000].contiguous() for t in k4_in[0]]
    k45_err, k4_plain_s = 0, None
    for nm, ins in (("boat shortest bucket", short), ("eviction", evict),
                    ("random edges", edge), ("boat stage 1, 2000 rows", head)):
        ref, plain_s = sync_time(lambda: EF.encode_lanes_full_plain(*ins))
        k4_plain_s = k4_plain_s or plain_s
        for kn, fn in (("K4", EF.encode_lanes_full),
                       ("K5", EF.encode_lanes_full_tiled)):
            for on, a, b in zip(("code", "nbits", "open"), fn(*ins), ref):
                k45_err = max(k45_err, assert_equal(f"{kn} {nm} {on}", a, b))
        sk4 = tile_stats(ins[0], K4_TILE)[0]
        sk5 = tile_stats(ins[0], K5_TILE)[0]
        log(f"K4 and K5 {nm} (L={ins[0].shape[0]}, {ins[0].shape[1]} "
            f"lanes, {int(ins[0].sum())} valid steps, empty tiles "
            f"{100 * sk4:.1f}% of K4's / {100 * sk5:.1f}% of K5's): "
            f"code/nbits/open bit-equal to plain (tolerance 0), plain "
            f"{plain_s:.1f} s")
    ev = edge[0].sum(dim=0)
    busy = tile_busy(edge[0], K4_TILE).int()
    inner = (busy == 0) & (busy.flip(0).cumsum(0).flip(0) > 0)
    if not (int(ev[0]) == 0 and len(set(ev.tolist())) > 20
            and int(inner.sum()) > 0 and edge[0].shape[0] % 8):
        raise AssertionError("random edge block lacks its edge cases")
    flag = EF.order_and_pack_lanes(*EF.encode_lanes_full(*evict), 4096)[2]
    if not bool(flag.any()):
        raise AssertionError("eviction block flagged no lane")
    EF.encode_lanes_full_tiled.launches = 0
    k5_out = [EF.encode_lanes_full_tiled(*ins) for ins in k4_in]
    k5_launches = EF.encode_lanes_full_tiled.launches
    for i, (ins, o5) in enumerate(zip(k4_in, k5_out)):
        for on, a, b in zip(("code", "nbits", "open"), o5,
                            EF.encode_lanes_full(*ins)):
            assert_equal(f"K5 vs K4 boat bucket {i} {on}", a, b)
    log(f"K5 equals K4 on every bucket of boat ({k5_launches} launches; "
        f"stage 1: L={k4_in[0][0].shape[0]}, {k4_in[0][0].shape[1]} lanes)")

    # ---- phase 7: the pallas backend -----------------------------------
    pseen = watch_host_lanes(penc)
    EF.encode_lanes_full.launches = 0
    reset_runs()
    sp, pallas_s = sync_time(
        lambda: T.compress_batch(boat[None], cfg, encoder=penc)[0])
    k4_launches = encode_runs()["full_encode"]
    if sha(sp) != golden:
        raise AssertionError("pallas backend: boat lossless sha differs")
    if k4_launches <= 0:
        raise AssertionError("pallas backend: kernel 4 did not launch")
    host = penc.fallback_lanes
    expect = 0
    for b, bw in zip(penc.buckets, slim_words):
        _Lk, Lc, cap = E.bucket_sizes(b["L"])
        rec, fstate, misc, ev = ES.encode_lanes_slim(bw)
        total = ES.order_and_pack_lanes(
            ES.slim_sort_operand_packed(rec, fstate, ev), cap, Lc)[1]
        nvalid = (bw & 1).sum(dim=0)
        expect += int(((misc[2] > 0) | (nvalid > Lc) | (total > cap)).sum())
    if host != expect:
        raise AssertionError(f"pallas backend: {host} host re-encode lanes, "
                             f"{expect} lanes evict or overflow")
    pchecked, pseq_s = check_host_lanes("pallas backend", pseen)
    pallas_host_s = penc.fallback_seconds
    log(f"pallas backend boat 512 lossless: sha == golden; kernel 4 "
        f"launches {k4_launches}; host re-encode lanes {host} == lanes "
        f"where K1 evicts or Lc/cap overflows, in {len(pseen)} native "
        f"batch(es), {pallas_host_s:.4f} s on the host; {pchecked} "
        f"payloads == sequential, which took {pseq_s:.3f} s; encode wall "
        f"(run once) {pallas_s:.3f} s | {card}")
    s50 = T.compress_batch(boat[None], cfg50, encoder=penc)[0]
    d50 = T.decompress(s50, cfg50, dtype=np.uint16, device=dev)
    if [sha(s50), pixel_sha(d50)] != pins:
        raise AssertionError("pallas backend: quota 50000 misses the pins")
    log("pallas backend quota 50000: stream and decoded pixels match pins")

    # ---- phase 8: the sorted backend -----------------------------------
    senc = T.make_encoder(w, h, cfg, np.uint16, dev, entropy="sorted")
    sseen = watch_host_lanes(senc)
    ss, sorted_s = sync_time(
        lambda: T.compress_batch(boat[None], cfg, encoder=senc)[0])
    if sha(ss) != golden:
        raise AssertionError("sorted backend: boat lossless sha differs")
    schecked, sseq_s = check_host_lanes("sorted backend", sseen)
    sorted_host = senc.fallback_lanes, senc.fallback_seconds
    s50 = T.compress_batch(boat[None], cfg50, encoder=senc)[0]
    d50 = T.decompress(s50, cfg50, dtype=np.uint16, device=dev)
    if [sha(s50), pixel_sha(d50)] != pins:
        raise AssertionError("sorted backend: quota 50000 misses the pins")
    log(f"sorted backend boat 512: lossless sha == golden, quota 50000 "
        f"matches the pins; host re-encode lanes {sorted_host[0]} in "
        f"{len(sseen)} native batch(es), {sorted_host[1]:.4f} s on the "
        f"host; {schecked} payloads == sequential, which took "
        f"{sseq_s:.3f} s; encode wall (run once) {sorted_s:.3f} s | {card}")

    # ---- phase 9: a long-lane geometry ---------------------------------
    crop_res = long_lane_phase(dev, card, np.ascontiguousarray(
        boat[128:384, 128:384]), long_pins)

    # ---- phase 10: quota classes ---------------------------------------
    full = T.make_encoder(w, h, cfg, np.uint16, dev)
    results = full.encode_batch(boat[None])
    for q in (5000, 20000, 50000):
        qcfg = T.CodecConfig(4, 0, 6, q)
        stats = {}
        sq = T.compress_batch(boat[None], qcfg, device=dev, stats=stats)[0]
        if sq != T.allocate_streams(results, qcfg, full)[0]:
            raise AssertionError(f"quota {q}: class stream differs from the "
                                 "full encode")
        log(f"quota {q}: {len(sq)} B == full encode then allocate; class "
            f"{stats['first_class']} of {stats['classes']}, escalations "
            f"{stats['escalations']}")

    # ---- phase 11: kernel 3 continues kernel 2 -------------------------
    _cw, _ch, _ll, blob, units = D.plan_batch([stream], cfg, np.uint16)
    st = torch.as_tensor(blob, device=dev)
    k3_args = []
    PDc.decode_plane_seeded.launches = 0
    for i, u in enumerate(units):
        offs, ebits, lane_end, geom = [torch.as_tensor(u[k], device=dev)
                                       for k in ("offs", "ebits",
                                                 "lane_end", "geom")]
        R = offs.shape[0]
        hm, wm = u["hmax"], u["wmax"]
        fo, fe, fp = PDc.decode_planes(st, offs, ebits, lane_end, geom, hm,
                                       wm, 8, 15)
        ho, he, _hp = PDc.decode_planes(st, offs[:-1], ebits[:-1], lane_end,
                                        geom, hm, wm, 8, 15)
        last = torch.where(he != 0, -1, offs[-1])
        a = (st, last, ebits[-1], lane_end, geom, ho, hm, wm, 8 - (R - 1),
             15)
        k3_args.append(a)
        ko, ke, kp = PDc.decode_plane_seeded(*a)
        assert_equal(f"K3 unit {i} out", ko, fo)
        assert_equal(f"K3 unit {i} err", (he != 0) | (ke != 0), fe != 0)
        assert_equal(f"K3 unit {i} pos", kp, fp[-1])
    k3_launches = PDc.decode_plane_seeded.launches
    log(f"K3 seeded with K2's first R-1 rounds equals K2's R rounds on all "
        f"{len(units)} units of boat's decode plan ({k3_launches} launches)")
    small = min(range(len(units)),
                key=lambda i: units[i]["hmax"] * units[i]["wmax"])
    big = max(range(len(units)),
              key=lambda i: units[i]["hmax"] * units[i]["wmax"])
    po, k3_plain_s = sync_time(
        lambda: PDc.decode_plane_seeded_plain(*k3_args[small]))
    k3_err = 0
    for nm, a, b in zip(("out", "err", "pos"),
                        PDc.decode_plane_seeded(*k3_args[small]), po):
        k3_err = max(k3_err, assert_equal(f"K3 smallest unit {nm}", a, b))
    log(f"K3 smallest unit: out/err/pos bit-equal to plain (tolerance 0), "
        f"plain {k3_plain_s:.1f} s")

    # ---- phase 12: timings ---------------------------------------------
    k4_short_ms = event_ms(lambda: EF.encode_lanes_full(*short))
    k5_short_ms = event_ms(lambda: EF.encode_lanes_full_tiled(*short))
    k4_ms = event_ms(lambda: EF.encode_lanes_full(*k4_in[0]))
    k5_ms = event_ms(lambda: EF.encode_lanes_full_tiled(*k4_in[0]))
    k4_img = sum(event_ms(lambda i=i: EF.encode_lanes_full(*i))
                 for i in k4_in)
    k5_path = sum(event_ms(lambda i=i: EF.encode_lanes_full_tiled(*i))
                  for i in k4_in)
    short_b = k4_bound(short[0])
    s1_b = k4_bound(k4_in[0][0])
    img_b = sum(k4_bound(i[0])[0] for i in k4_in)
    skip4, chain = tile_stats(k4_in[0][0], K4_TILE)
    skip5 = tile_stats(k4_in[0][0], K5_TILE)[0]
    L1 = k4_in[0][0].shape[0]
    log(f"K4 stage-1 block {tuple(k4_in[0][0].shape)}: {k4_ms:.3f} ms, K5 "
        f"{k5_ms:.3f} ms (bound {s1_b[0]:.4f} ms, {s1_b[1]}); per slot K4 "
        f"{1e6 * k4_ms / L1:.1f} ns, K5 {1e6 * k5_ms / L1:.1f} ns; per valid "
        f"step of the longest lane ({chain} steps) K4 "
        f"{1e6 * k4_ms / chain:.1f} ns, K5 {1e6 * k5_ms / chain:.1f} ns; "
        f"tiles with no valid step, skipped by the chain: "
        f"{100 * skip4:.1f}% of K4's {K4_TILE}-row tiles, "
        f"{100 * skip5:.1f}% of K5's {K5_TILE}-row tiles; shortest bucket "
        f"{tuple(short[0].shape)}: K4 {k4_short_ms:.3f} ms, K5 "
        f"{k5_short_ms:.3f} ms (bound "
        f"{short_b[0]:.4f} ms); per image (4 launches) K4 {k4_img:.3f} ms, "
        f"K5 {k5_path:.3f} ms (bound {img_b:.4f} ms) | {card}")
    k3_ms = [event_ms(lambda a=a: PDc.decode_plane_seeded(*a))
             for a in k3_args]
    k3_b = []
    for u, a in zip(units, k3_args):
        _o, _e, kp = PDc.decode_plane_seeded(*a)
        k3_b.append(k3_bound(u, kp, a[1] >= 0))
    for i, u in enumerate(units):
        log(f"K3 unit {i}: {u['offs'].shape[1]} lanes, canvas {u['hmax']}x"
            f"{u['wmax']}, round lsb {k3_args[i][8]}: {k3_ms[i]:.3f} ms "
            f"(bound {k3_b[i][0]:.5f} ms, {k3_b[i][1]})")
    log(f"K3 stage-1 LSB round: {k3_ms[big]:.3f} ms | {card}")

    src = "icer_compression_tpu_torch/csrc/"
    host_lanes = {"pallas": (pallas_s, host, pallas_host_s, pseq_s),
                  "sorted": (sorted_s,) + sorted_host + (sseq_s,)}
    host_lanes.update({f"crop256 {e}": v
                       for e, v in crop_res["walls"].items()})
    return {"crop_launches": crop_res["launches"], "host": host_lanes}, [
        {"name": "full_encode", "route": "cuda", "source": src + "full_encode.cu",
         "replaces": "icer_compression_tpu/ops/pallas_entropy.py:188",
         "launches": k4_launches, "max_abs_err": k45_err,
         "equal_to_plain": True,
         "shape": f"L={short[0].shape[0]} lanes={short[0].shape[1]} "
                  "(boat shortest bucket)",
         "ms": k4_short_ms, "plain_ms": 1e3 * k4_plain_s,
         "bound_ms": short_b[0], "bound_by": short_b[1], "library_ms": None,
         "stage1_ms": k4_ms, "stage1_bound_ms": s1_b[0],
         "ns_per_step": 1e6 * k4_ms / L1,
         "step": "one emission slot of a stage-1 lane",
         "ns_per_valid_step": 1e6 * k4_ms / chain,
         "valid_step": "one valid emission of the longest stage-1 lane",
         "stage1_tiles_skipped": skip4,
         "ms_per_image": k4_img, "bound_ms_per_image": img_b,
         "path": "compress_batch with entropy='pallas', boat 512 lossless"},
        {"name": "full_encode_tiled", "route": "cuda",
         "source": src + "full_encode.cu",
         "replaces": "icer_compression_tpu/ops/pallas_entropy.py:284",
         "launches": k5_launches, "max_abs_err": k45_err,
         "equal_to_plain": True,
         "shape": f"L={short[0].shape[0]} lanes={short[0].shape[1]} "
                  "(boat shortest bucket)",
         "ms": k5_short_ms, "plain_ms": 1e3 * k4_plain_s,
         "bound_ms": short_b[0], "bound_by": short_b[1], "library_ms": None,
         "stage1_ms": k5_ms, "stage1_bound_ms": s1_b[0],
         "ns_per_step": 1e6 * k5_ms / L1,
         "step": "one emission slot of a stage-1 lane",
         "ns_per_valid_step": 1e6 * k5_ms / chain,
         "valid_step": "one valid emission of the longest stage-1 lane",
         "stage1_tiles_skipped": skip5,
         "ms_per_path": k5_path, "bound_ms_per_path": img_b,
         "path": "every pallas-backend bucket of boat 512 through K5"},
        {"name": "plane_decode_seeded", "route": "cuda",
         "source": src + "plane_decode.cu",
         "replaces": "icer_compression_tpu/ops/pallas_decode.py:1230",
         "launches": k3_launches, "max_abs_err": k3_err,
         "equal_to_plain": True,
         "shape": f"lanes={units[small]['offs'].shape[1]} canvas="
                  f"{units[small]['hmax']}x{units[small]['wmax']} 1 round "
                  "(boat stage-4 LSB)",
         "ms": k3_ms[small], "plain_ms": 1e3 * k3_plain_s,
         "bound_ms": k3_b[small][0], "bound_by": k3_b[small][1],
         "library_ms": None, "stage1_ms": k3_ms[big],
         "stage1_bound_ms": k3_b[big][0],
         "ns_per_step": 1e6 * k3_ms[big] / (units[big]["hmax"]
                                            * units[big]["wmax"]),
         "step": "one pixel of a stage-1 lane's round",
         "path": "last round of each unit of boat's lossless decode plan"},
    ]


def retirement_plan(unit):
    """Boat's decode plan for one unit with retirement forced in the middle
    of lanes: lane j % 4 == 1 loses a middle plane, j % 4 == 2 has a
    middle round's frozen length cut to 1-8 bits (a stream error lands
    where a refill first needs more bits), j % 4 == 3 both, the cut round
    before the missing one.  Returns (offs, ebits, the cut round per
    lane or -1)."""
    offs, ebits = unit["offs"].copy(), unit["ebits"].copy()
    R, n = offs.shape
    cut = np.full(n, -1)
    for j in range(n):
        mid = 2 + j % (R - 3)
        if j % 4 in (2, 3):
            ebits[mid, j] = 1 + j % 8
            cut[j] = mid
        if j % 4 == 1:
            offs[mid, j] = -1
        elif j % 4 == 3:
            offs[mid + 1, j] = -1
    return offs, ebits, cut


def decode_phases(dev, card, boat, st, units, small):
    """Phases 13-15: kernel 2 under forced mid-lane retirement, in both
    canvas placements, and on a canvas larger than shared memory; kernel 5
    against kernel 4 on lanes whose opening emissions pass 2^16."""
    from icer_compression_tpu_torch.models import decode as D
    from icer_compression_tpu_torch.models import grayscale as T
    from icer_compression_tpu_torch.ops import encode as E
    from icer_compression_tpu_torch.ops import entropy_full as EF
    from icer_compression_tpu_torch.ops import plane_decode as PDc

    # ---- phase 13: retirement in the middle of lanes -------------------
    u = units[small]
    offs, ebits, cut = retirement_plan(u)
    args = [torch.as_tensor(a, device=dev)
            for a in (offs, ebits, u["lane_end"], u["geom"])]
    hm, wm = u["hmax"], u["wmax"]
    want, plain_s = sync_time(
        lambda: PDc.decode_planes_plain(st, *args, hm, wm, 8, 15))
    retire_err = 0
    for placement, where in (("auto", "shared"), ("device", "device")):
        got = PDc.decode_planes(st, *args, hm, wm, 8, 15,
                                _placement=placement)
        if PDc.decode_planes.placement != where:
            raise AssertionError(f"K2 placement {placement!r} ran "
                                 f"{PDc.decode_planes.placement!r}")
        for nm, a, b in zip(("out", "err", "pos"), got, want):
            retire_err = max(retire_err, assert_equal(
                f"K2 forced retirement ({where}) {nm}", a, b))
    err = want[1].cpu().numpy()
    pos = want[2].cpu().numpy()
    mid = [j for j in range(len(cut)) if cut[j] >= 0 and err[j]
           and pos[cut[j], j] > 0 and not pos[cut[j] + 1:, j].any()]
    if len({(cut[j], pos[cut[j], j]) for j in mid}) < 2:
        raise AssertionError("forced stream errors did not land inside "
                             "rounds at different points")
    log(f"K2 forced retirement on the stage-4 unit ({len(cut)} lanes, "
        f"{int(err.sum())} retired; {len(mid)} by stream errors inside a "
        f"middle round, at bits "
        f"{sorted(int(pos[cut[j], j]) for j in mid)}): out/err/pos "
        f"bit-equal to plain with the canvas in shared and in device "
        f"memory, plain {plain_s:.1f} s")

    # ---- phase 14: device-memory placement on every unit ---------------
    place_err = retire_err
    inputs = D.unit_inputs(units, dev)
    for i, a in enumerate(inputs):
        sh = PDc.decode_planes(st, *a, 8, 15)
        if PDc.decode_planes.placement != "shared":
            raise AssertionError(f"unit {i} did not run in shared memory")
        dv = PDc.decode_planes(st, *a, 8, 15, _placement="device")
        for nm, x, y in zip(("out", "err", "pos"), dv, sh):
            place_err = max(place_err, assert_equal(
                f"K2 unit {i} device vs shared placement {nm}", x, y))
        # kernel 3 on the unit's last round, seeded with the rounds before
        o, e, le, g, hm, wm = a
        head = PDc.decode_planes(st, o[:-1], e[:-1], le, g, hm, wm, 8, 15)
        k3a = (st, torch.where(head[1] != 0, -1, o[-1]), e[-1], le, g,
               head[0], hm, wm, 8 - (o.shape[0] - 1), 15)
        sh3 = PDc.decode_plane_seeded(*k3a)
        dv3 = PDc.decode_plane_seeded(*k3a, _placement="device")
        if PDc.decode_plane_seeded.placement != "device":
            raise AssertionError("K3 did not run in device memory")
        for nm, x, y in zip(("out", "err", "pos"), dv3, sh3):
            place_err = max(place_err, assert_equal(
                f"K3 unit {i} device vs shared placement {nm}", x, y))
    big = max(range(len(units)),
              key=lambda i: units[i]["hmax"] * units[i]["wmax"])
    dev_ms = event_ms(lambda: PDc.decode_planes(
        st, *inputs[big], 8, 15, _placement="device"))
    log(f"K2 and K3 with the canvas in device memory bit-equal to shared "
        f"memory on all {len(units)} units; K2 stage-1 launch {dev_ms:.3f} "
        f"ms in device memory | {card}")

    # ---- phase 15: one stage, one segment: 256x256 lanes ---------------
    h, w = boat.shape
    cfg1 = T.CodecConfig(1, 0, 1, None)
    enc = T.make_encoder(w, h, cfg1, np.uint16, dev, entropy="pallas")
    s1, enc_s = sync_time(
        lambda: T.compress_batch(boat[None], cfg1, encoder=enc)[0])
    PDc.decode_planes.launches = 0
    reset_runs()
    d1, dec_s = sync_time(lambda: T.decompress(s1, cfg1, np.uint16, dev))
    dec_launches = encode_runs()["plane_decode"]
    if not np.array_equal(d1, boat):
        raise AssertionError("1 stage, 1 segment: decode differs from boat")
    if PDc.decode_planes.placement != "device":
        raise AssertionError("256x256 lanes did not use device memory")
    _w, _h, _ll, blob1, units1 = D.plan_batch([s1], cfg1, np.uint16)
    st1 = torch.as_tensor(blob1, device=dev)
    in1 = D.unit_inputs(units1, dev)
    k2_ms1 = event_ms(lambda: D.decode_units(st1, in1, 8, 15), reps=3)
    log(f"boat 512, 1 stage, 1 segment ({len(s1)} B, {len(units1)} "
        f"unit(s) of {units1[0]['hmax']}x{units1[0]['wmax']}): decode "
        f"pixel-exact with the canvas in device memory ({dec_launches} "
        f"launch(es)); encode {enc_s:.3f} s ({enc.fallback_lanes} host "
        f"re-encode lanes), decode {dec_s:.3f} s, K2 {k2_ms1:.3f} ms | "
        f"{card}")
    img1 = enc.transform(torch.as_tensor(boat.astype(np.int32)[None],
                                         device=dev))[0]
    em1 = [enc.emit(g, img1) for g in enc.groups]
    for i, b in enumerate(enc.buckets):
        cw, _over = E.compact_words(enc.bucket_words(b, em1),
                                    E.bucket_sizes(b["L"])[1])
        ins = [t.t().contiguous() for t in E._split_words(cw)]
        o4 = EF.encode_lanes_full(*ins)
        for on, a, b5 in zip(("code", "nbits", "open"), o4,
                             EF.encode_lanes_full_tiled(*ins)):
            assert_equal(f"K5 vs K4 1 stage 1 segment bucket {i} {on}", a,
                         b5)
        top = int(torch.where(o4[1] > 0, o4[2], 0).max())
        if i == 0 and top < 1 << 16:
            raise AssertionError(f"opening emissions reach only {top}")
        k4_1 = event_ms(lambda: EF.encode_lanes_full(*ins), reps=3)
        k5_1 = event_ms(lambda: EF.encode_lanes_full_tiled(*ins), reps=3)
        log(f"K5 equals K4 on the 1 stage, 1 segment bucket {i} "
            f"{tuple(ins[0].shape)} (opening emissions up to {top}); K4 "
            f"{k4_1:.3f} ms, K5 {k5_1:.3f} ms | {card}")
    return {"retire_err": retire_err, "place_err": place_err}


def encode_runs(device="cuda") -> dict:
    """Runs of each kernel (``kernels.RUN_SLOTS``: the encode kernels, K2,
    K3 and W1) on ``device`` since ``reset_runs``, counted by the kernels
    on the card: a replayed graph's runs count, as the wrappers'
    ``launches`` (the host's launches) cannot."""
    from icer_compression_tpu_torch import kernels
    return kernels.device_runs(device)


def reset_runs(device="cuda") -> None:
    from icer_compression_tpu_torch import kernels
    kernels.reset_runs(device)


# (label, captures so far, their seconds so far), one per phase boundary
CAPTURE_MARKS: list = []


def mark_captures(label: str) -> None:
    """Note how many graphs this process has captured by the end of the
    phases ``label`` names, and their seconds."""
    from icer_compression_tpu_torch.backend import graph_cache as GC
    caps = GC.CACHE.captures
    CAPTURE_MARKS.append((label, len(caps),
                          sum(c["seconds"] for c in caps)))


def capture_counts() -> list:
    """(label, captures, seconds) of each stretch between marks."""
    out, n0, s0 = [], 0, 0.0
    for label, n, secs in CAPTURE_MARKS:
        out.append((label, n - n0, secs - s0))
        n0, s0 = n, secs
    return out


@contextlib.contextmanager
def no_host_sync():
    """Inside the block, any host synchronisation that PyTorch makes (an
    ``.item()``, a ``bool`` of a tensor, a blocking copy) raises."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


def color_phases(dev, card, boat, pins):
    """Phases 16-17: the colour main path against its pins from the JAX
    package (uint16 at two quotas, uint8), kernels 1 and 2 against their
    plain versions on the uint8 colour path's smallest launches, the
    colour walls and kernel times, and a colour batch."""
    from icer_compression_tpu_torch.models import color as TC
    from icer_compression_tpu_torch.models import decode as D
    from icer_compression_tpu_torch.models import grayscale as T
    from icer_compression_tpu_torch.ops import entropy_slim as ES
    from icer_compression_tpu_torch.ops import plane_decode as PDc

    rgb = color_boat(boat)
    h, w = boat.shape
    cfg = T.CodecConfig(4, 0, 6, None)
    res = {}

    def equal_planes(a, b):
        return all(np.array_equal(x, y) for x, y in zip(a, b))

    # ---- phase 16: the colour main path ---------------------------------
    streams = {}
    for i, (label, dtype, quota) in enumerate(COLOR_PINS):
        planes = color_planes(rgb, dtype)
        qcfg = T.CodecConfig(4, 0, 6, quota)
        if i == 0:
            ES.encode_lanes_slim.launches = 0
            PDc.decode_planes.launches = 0
            reset_runs()
        s = TC.compress_yuv(*planes, qcfg, device=dev)
        d = TC.decompress_yuv(s, qcfg, dtype, device=dev)
        if i == 0:
            res["launches"] = {"slim_encode": encode_runs()["slim_encode"],
                               "plane_decode": encode_runs()["plane_decode"]}
            if min(res["launches"].values()) <= 0:
                raise AssertionError(f"colour path: a kernel did not "
                                     f"launch: {res['launches']}")
        got = [hashlib.sha256(s).hexdigest(), planes_sha(d)]
        if got != pins[2 * i:2 * i + 2]:
            raise AssertionError(f"colour {label}: {got} != pins "
                                 f"{pins[2 * i:2 * i + 2]}")
        if quota is None and not equal_planes(d, planes):
            raise AssertionError(f"colour {label}: decode differs from the "
                                 "Y, U and V planes")
        streams[label] = s
        log(f"colour boat 512 {label}: {len(s)} B stream and decoded planes "
            f"match the pins from the JAX package"
            + (", decode returns Y, U and V exactly" if quota is None
               else ""))
    log(f"colour main path launches {res['launches']}")

    # kernels 1 and 2 against their plain versions on the uint8 path
    y8 = color_planes(rgb, np.uint8)
    enc8 = T.make_encoder(w, h, cfg, np.uint8, dev)
    x8 = torch.as_tensor(np.stack(y8).astype(np.int32), device=dev)
    img8 = enc8.transform(x8)[0]
    em8 = [enc8.emit(g, img8) for g in enc8.groups]
    wshort = enc8.bucket_words(enc8.buckets[-1], em8).t().contiguous()
    p1, k1_plain_s = sync_time(lambda: ES.encode_lanes_slim_plain(wshort))
    res["k1_err"] = 0
    for nm, a, b in zip(("rec", "fstate", "misc", "ev"),
                        ES.encode_lanes_slim(wshort), p1):
        res["k1_err"] = max(res["k1_err"], assert_equal(
            f"K1 uint8 colour shortest bucket {nm}", a, b))
    res["k1_plain_ms"] = 1e3 * k1_plain_s
    res["k1_shape"] = tuple(wshort.shape)
    _w, _h, _ll, blob8, units8 = D.plan_batch([streams["u8 unlimited"]], cfg,
                                              np.uint8, nchan=3)
    st8 = torch.as_tensor(blob8, device=dev)
    small = min(range(len(units8)),
                key=lambda i: units8[i]["hmax"] * units8[i]["wmax"])
    u8 = units8[small]
    a8 = D.unit_inputs([u8], dev)[0]
    p2, k2_plain_s = sync_time(lambda: PDc.decode_planes_plain(
        st8, *a8, 6, 7))
    res["k2_err"] = 0
    for nm, a, b in zip(("out", "err", "pos"),
                        PDc.decode_planes(st8, *a8, 6, 7), p2):
        res["k2_err"] = max(res["k2_err"], assert_equal(
            f"K2 uint8 colour smallest unit {nm}", a, b))
    res["k2_plain_ms"] = 1e3 * k2_plain_s
    res["k2_shape"] = (u8["offs"].shape[1], u8["hmax"], u8["wmax"],
                       u8["offs"].shape[0])
    log(f"uint8 colour: K1 shortest bucket {res['k1_shape']} and K2 smallest "
        f"unit ({res['k2_shape'][0]} lanes, canvas {u8['hmax']}x"
        f"{u8['wmax']}, {res['k2_shape'][3]} rounds, lsb0 6, mag_bits 7) "
        f"bit-equal to plain (tolerance 0); plain {k1_plain_s:.1f} s / "
        f"{k2_plain_s:.1f} s")

    # walls and kernel times on the uint16 colour main path
    yuv = color_planes(rgb, np.uint16)
    s16 = streams["u16 unlimited"]
    enc_t, dec_t = [], []
    for _ in range(3):
        enc_t.append(sync_time(lambda: TC.compress_yuv(*yuv, cfg,
                                                       device=dev))[1])
        dec_t.append(sync_time(lambda: TC.decompress_yuv(
            s16, cfg, np.uint16, device=dev))[1])
    res["enc_ms"] = 1e3 * statistics.median(enc_t)
    res["dec_ms"] = 1e3 * statistics.median(dec_t)
    enc16 = T.make_encoder(w, h, cfg, np.uint16, dev)
    x16 = torch.as_tensor(np.stack(yuv).astype(np.int32), device=dev)
    img16 = enc16.transform(x16)[0]
    em16 = [enc16.emit(g, img16) for g in enc16.groups]
    k1_ms, k1_b = 0.0, 0.0
    for b in enc16.buckets:
        bw = enc16.bucket_words(b, em16).t().contiguous()
        k1_ms += event_ms(lambda bw=bw: ES.encode_lanes_slim(bw))
        k1_b += k1_bound(bw, ES.encode_lanes_slim(bw)[2])[0]
    _w, _h, _ll, blob, units = D.plan_batch([s16], cfg, np.uint16, nchan=3)
    st = torch.as_tensor(blob, device=dev)
    inputs = D.unit_inputs(units, dev)
    k2_ms = event_ms(lambda: D.decode_units(st, inputs, 8, 15))
    k2_b = sum(k2_bound(u, PDc.decode_planes(st, *a, 8, 15)[2])[0]
               for u, a in zip(units, inputs))
    res.update(k1_ms=k1_ms, k1_bound_ms=k1_b, k2_ms=k2_ms, k2_bound_ms=k2_b,
               k1_launches=len(enc16.buckets), k2_launches=len(units))
    log(f"colour boat 512 lossless wall (median of 3): encode "
        f"{res['enc_ms']:.1f} ms, decode {res['dec_ms']:.1f} ms, "
        f"{h * w / (res['enc_ms'] + res['dec_ms']) * 1e-3:.4f} MP/s; per "
        f"image K1 {k1_ms:.3f} ms over {len(enc16.buckets)} launches (bound "
        f"{k1_b:.4f} ms), K2 {k2_ms:.3f} ms over {len(units)} units "
        f"overlapped (bound {k2_b:.4f} ms; stage 1: "
        f"{units[0]['offs'].shape[1]} lanes) | {card}")

    # ---- phase 17: a colour batch ---------------------------------------
    rng = np.random.default_rng(1234)
    variants = [np.clip(rgb.astype(np.int32)
                        + rng.integers(-6, 7, rgb.shape), 0, 255)
                .astype(np.uint8) for _ in range(4)]
    planes = [color_planes(c, np.uint16) for c in variants]
    ys, us, vs = (list(c) for c in zip(*planes))
    for quota in (None, 150000):
        qcfg = T.CodecConfig(4, 0, 6, quota)
        if quota is None:
            ES.encode_lanes_slim.launches = 0
            PDc.decode_planes.launches = 0
            reset_runs()
        bs, enc_s = sync_time(lambda: TC.compress_yuv_batch(
            ys, us, vs, qcfg, device=dev))
        bd, dec_s = sync_time(lambda: D.decompress_yuv_batch(
            bs, qcfg, np.uint16, device=dev))
        if quota is None:
            res["batch_streams"] = bs
            res["batch_launches"] = {
                "slim_encode": encode_runs()["slim_encode"],
                "plane_decode": encode_runs()["plane_decode"]}
            res["batch_enc_ms"], res["batch_dec_ms"] = 1e3 * enc_s, \
                1e3 * dec_s
        for i in range(len(variants)):
            if bs[i] != TC.compress_yuv(*planes[i], qcfg, device=dev):
                raise AssertionError(f"colour batch quota {quota} image {i}: "
                                     "stream differs from compress_yuv")
            if not equal_planes(bd[i], TC.decompress_yuv(
                    bs[i], qcfg, np.uint16, device=dev)):
                raise AssertionError(f"colour batch quota {quota} image {i}: "
                                     "decode differs from decompress_yuv")
            if quota is None and not equal_planes(bd[i], planes[i]):
                raise AssertionError(f"colour batch image {i}: lossless "
                                     "decode differs from its planes")
        log(f"colour batch of 4 (seed 1234, +-6) quota {quota}: streams == "
            f"compress_yuv, decodes == decompress_yuv"
            + (" == the planes" if quota is None else "")
            + f"; {sum(map(len, bs))} B; encode {enc_s:.3f} s, decode "
            f"{dec_s:.3f} s ({4 * h * w / (enc_s + dec_s) / 1e6:.3f} MP/s) "
            f"| {card}")
    log(f"colour batch launches {res['batch_launches']}")
    return res


def deferred_phase(dev, card, boat):
    """Phase 18: four grayscale batches of 8 through ``encode_batch`` and
    ``decompress_batch`` with ``defer``, K collectors open, each dispatch
    half under ``no_host_sync``; streams and pixels equal to the
    synchronous calls; walls for K = 4 and K = 1 in turns (4, 1, 1, 4,
    4, 1, 1, 4)."""
    from icer_compression_tpu_torch.models import decode as D
    from icer_compression_tpu_torch.models import grayscale as T
    from icer_compression_tpu_torch.ops import entropy_slim as ES
    from icer_compression_tpu_torch.ops import plane_decode as PDc
    from icer_compression_tpu_torch.ops import wavelet as WV

    h, w = boat.shape
    rng = np.random.default_rng(1234)
    batches = [np.clip(boat[None].astype(np.int32)
                       + rng.integers(-6, 7, (8, h, w)), 0, 255)
               .astype(np.uint16) for _ in range(4)]
    cfg = T.CodecConfig(4, 0, 6, None)
    enc = T.make_encoder(w, h, cfg, np.uint16, dev)

    def streams_of(results):
        return T.allocate_streams(results, cfg, enc)

    want_s = [streams_of(enc.encode_batch(b)) for b in batches]
    want_px = [D.decompress_batch(s, cfg, np.uint16, device=dev)
               for s in want_s]

    def run(K):
        """(streams, pixels, encode s, decode s) with K collectors open."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        streams, pending = [], []
        for b in batches:
            with no_host_sync():
                pending.append(enc.encode_batch(b, defer=True))
            if len(pending) >= K:
                streams.append(streams_of(pending.pop(0)()))
        streams += [streams_of(p()) for p in pending]
        t1 = time.perf_counter()
        pixels, pending = [], []
        for s in streams:
            with no_host_sync():
                pending.append(D.decompress_batch(s, cfg, np.uint16,
                                                  device=dev, defer=True))
            if len(pending) >= K:
                pixels.append(pending.pop(0)())
        pixels += [p() for p in pending]
        return streams, pixels, t1 - t0, time.perf_counter() - t1

    ES.encode_lanes_slim.launches = 0
    PDc.decode_planes.launches = 0
    WV.inverse_pass.launches = 0
    reset_runs()
    outs = [(4, run(4))]
    launches = {"slim_encode": encode_runs()["slim_encode"],
                "plane_decode": encode_runs()["plane_decode"],
                "wavelet_inverse": encode_runs()["wavelet_inverse"]}
    order = (4, 1, 1, 4, 4, 1, 1, 4)
    outs += [(K, run(K)) for K in order[1:]]
    for K, (streams, pixels, _e, _d) in outs:
        if streams != want_s:
            raise AssertionError(f"deferred encode (K={K}) streams differ "
                                 "from the synchronous calls")
        for i, (got, want, imgs) in enumerate(zip(pixels, want_px, batches)):
            if not all(np.array_equal(a, b) and np.array_equal(a, c)
                       for a, b, c in zip(got, want, imgs)):
                raise AssertionError(f"deferred decode (K={K}) batch {i} "
                                     "differs")
    mp = 32 * h * w / 1e6
    walls = {K: [(o[2], o[3]) for k, o in outs if k == K] for K in (4, 1)}
    rates = {K: [mp / (e + d) for e, d in v] for K, v in walls.items()}
    log(f"deferred batches (4 x 8 boat variants): streams and pixels equal "
        f"the synchronous calls and the images, no host sync in any "
        f"dispatch half; launches {launches}; runs in turns "
        f"{', '.join(f'K={K}' for K in order)}: " + "; ".join(
            f"K={K} encode {[round(1e3 * e, 1) for e, _d in walls[K]]} ms, "
            f"decode {[round(1e3 * d, 1) for _e, d in walls[K]]} ms, "
            f"{[round(r, 3) for r in rates[K]]} MP/s" for K in (4, 1))
        + f" | {card}")
    return {"launches": launches, "mps_k4": rates[4], "mps_k1": rates[1]}


def cli_phase(dev, card, boat):
    """Phase 19: the port's CLI on PNG files written by the port's
    ``image_io``; its outputs must equal the API's."""
    from icer_compression_tpu_torch import cli
    from icer_compression_tpu_torch.models import color as TC
    from icer_compression_tpu_torch.models import grayscale as T
    from icer_compression_tpu_torch.ops import entropy_slim as ES
    from icer_compression_tpu_torch.ops import plane_decode as PDc
    from icer_compression_tpu_torch.utils.colorspace import ycbcr_to_rgb
    from icer_compression_tpu_torch.utils.image_io import read_png, write_png

    def run(*args):
        if cli.main([str(a) for a in args] + ["--device", dev.type]) != 0:
            raise AssertionError(f"cli {args[0]} failed")

    def gray_want(img):
        qcfg = T.CodecConfig(4, 0, 6, img.shape[0] * img.shape[1])
        s = T.compress(img, qcfg, device=dev)
        px = T.decompress(s, qcfg, np.uint16, device=dev)
        return s, np.clip(px, 0, 255).astype(np.uint8)

    h, w = boat.shape
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        write_png(tmp / "boat.png", boat.astype(np.uint8))
        write_png(tmp / "rgb.png", color_boat(boat))
        ES.encode_lanes_slim.launches = 0
        PDc.decode_planes.launches = 0
        reset_runs()
        run("compress", tmp / "boat.png", tmp / "g.icer", "-G")
        run("decompress", tmp / "g.icer", tmp / "g.png", "-G")
        launches = {"slim_encode": encode_runs()["slim_encode"],
                    "plane_decode": encode_runs()["plane_decode"]}
        s, px = gray_want(boat)
        if (tmp / "g.icer").read_bytes() != s:
            raise AssertionError("cli -G stream differs from compress")
        if not np.array_equal(read_png(tmp / "g.png"), px):
            raise AssertionError("cli -G decode differs from decompress")

        run("compress", tmp / "rgb.png", tmp / "c.icer", "-c")
        run("decompress", tmp / "c.icer", tmp / "c.png", "-c")
        planes = color_planes(read_png(tmp / "rgb.png"), np.uint16)
        ccfg = T.CodecConfig(4, 0, 6, 3 * h * w)
        s = TC.compress_yuv(*planes, ccfg, device=dev)
        if (tmp / "c.icer").read_bytes() != s:
            raise AssertionError("cli -c stream differs from compress_yuv")
        rgb = ycbcr_to_rgb(*TC.decompress_yuv(s, ccfg, np.uint16,
                                              device=dev))
        if not np.array_equal(read_png(tmp / "c.png"), rgb):
            raise AssertionError("cli -c decode differs from decompress_yuv")

        imgs = {"boat": boat, "crop": boat[h // 4:3 * h // 4, w // 4:3 * w // 4],
                "boat2": boat}
        (tmp / "in").mkdir()
        for name, img in imgs.items():
            write_png(tmp / "in" / f"{name}.png", img.astype(np.uint8))
        run("batch-compress", tmp / "in", tmp / "enc", "--batch-size", 2)
        run("batch-decompress", tmp / "enc", tmp / "dec", "--batch-size", 2)
        for name, img in imgs.items():
            s, px = gray_want(np.ascontiguousarray(img))
            if (tmp / "enc" / f"{name}.icer").read_bytes() != s:
                raise AssertionError(f"cli batch stream {name} differs")
            if not np.array_equal(read_png(tmp / "dec" / f"{name}.png"), px):
                raise AssertionError(f"cli batch decode {name} differs")
    log(f"cli: -G and -c round trips and batch-compress/-decompress of a "
        f"mixed-geometry folder ({w}x{h} twice, {w // 2}x{h // 2}; "
        f"--batch-size 2) "
        f"equal the API's streams and decodes; launches of the -G round "
        f"trip {launches} | {card}")
    return {"launches": launches}


def peak(fn):
    """(fn(), seconds, peak device bytes above the baseline)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out, secs = sync_time(fn)
    return out, secs, torch.cuda.max_memory_allocated() - base


def coder_bytes_per_word(enc, imgs):
    """(peak device bytes of ``enc.encode_batch(imgs)`` above what was
    allocated before it, coder words of the pass's largest bucket): the
    quantity behind ``ops.encode.PASS_WORDS``."""
    _out, _secs, pk = peak(lambda: enc.encode_batch(imgs))
    return pk, len(imgs) * enc.words_per_image


def long_lane_block(dev, boat):
    """Kernel 1's two-word input in phase 20: the stage-1 bucket words
    (L, lanes) of the first 1024x1024 variant at the CLI's defaults."""
    from icer_compression_tpu_torch.models import grayscale as T
    from icer_compression_tpu_torch.ops import entropy_slim as ES
    img = long_lane_images(boat)["gray1024"][:1]
    enc = T.make_encoder(img.shape[2], img.shape[1], T.CodecConfig(
        4, 0, 6, None), np.uint16, dev)
    x = torch.as_tensor(img.astype(np.int32), device=dev)
    em = [enc.emit(g, enc.transform(x)[0]) for g in enc.groups]
    bw = enc.bucket_words(enc.buckets[0], em).t().contiguous()
    if ES.fused_key_ok(bw.shape[0]):
        raise AssertionError("1024x1024 stage 1 fits fused keys")
    return bw


def long_lane_phases(dev, card, boat, pins, batch8, host, bw):
    """Phase 20: the long-lane geometries at the CLI's defaults (stages 4,
    filter A, 6 segments), whose stage-1 lanes run kernel 1's two-word
    instance: 1024x1024 and its 999x601 crop through ``compress`` and
    ``decompress`` (lossless and quota 200,000) and the 7 variants through
    ``compress_batch`` and ``decompress_batch`` (once more with the blob
    cap lowered so that the batch decodes in passes), 1024x1024 colour
    through ``compress_yuv`` and ``decompress_yuv``; every stream and
    decode against its pin from the JAX package.  Also kernel 2's canvas
    placement on the 1024x1024 stage-1 unit (both held equal), kernel 1's
    two-word stage-1 launch time (its plain version on the host CPU), and
    peak device memory per coder word of one encode pass in each record
    mode."""
    from icer_compression_tpu_torch.models import color as TC
    from icer_compression_tpu_torch.models import decode as D
    from icer_compression_tpu_torch.models import grayscale as T
    from icer_compression_tpu_torch.ops import entropy_slim as ES
    from icer_compression_tpu_torch.ops import plane_decode as PDc

    images = long_lane_images(boat)
    res = {"launches": {}, "walls": {}}

    def reset():
        ES.encode_lanes_slim.launches = 0
        ES.encode_lanes_slim_two_word.launches = 0
        PDc.decode_planes.launches = 0
        reset_runs()

    def counts():
        runs = encode_runs()
        return {"slim_encode": runs["slim_encode"],
                "slim_encode_two_word": runs["slim_encode_two_word"],
                "slim_pack": runs["slim_pack"],
                "slim_pack_two_word": runs["slim_pack_two_word"],
                "plane_decode": encode_runs()["plane_decode"]}

    def tag(q):
        return "unlimited" if q is None else f"quota {q}"

    def check_pin(label, digest):
        if digest != pins[label]:
            raise AssertionError(f"{label}: {digest} != pin {pins[label]}")

    def timed(fn, reps=3):
        """(result of the first call, median wall of ``reps`` calls)."""
        runs = [sync_time(fn) for _ in range(reps)]
        return runs[0][0], statistics.median(t for _o, t in runs)

    for key in ("gray1024", "gray999x601"):
        imgs = images[key]
        h, w = imgs.shape[1:]
        for q in LONG_LANE_QUOTAS:
            cfg = T.CodecConfig(4, 0, 6, q)
            reset()
            s = T.compress(imgs[0], cfg, device=dev)
            d = T.decompress(s, cfg, np.uint16, device=dev)
            c = counts()
            check_pin(f"{key} v0 {tag(q)} stream",
                      hashlib.sha256(s).hexdigest())
            check_pin(f"{key} v0 {tag(q)} decoded", pixels_sha(d))
            if q is None and not np.array_equal(d, imgs[0]):
                raise AssertionError(f"{key}: lossless decode differs")
            if min(c.values()) <= 0:
                raise AssertionError(f"{key} {tag(q)}: a kernel did not "
                                     f"launch: {c}")
            res["launches"][f"{key} {tag(q)}"] = c
            walls = ""
            if q is None:
                _s, enc_s = timed(lambda: T.compress(imgs[0], cfg,
                                                     device=dev))
                _d, dec_s = timed(lambda: T.decompress(s, cfg, np.uint16,
                                                       device=dev))
                res["walls"][key] = (1e3 * enc_s, 1e3 * dec_s)
                walls = (f"; wall (median of 3) encode {1e3 * enc_s:.1f} ms,"
                         f" decode {1e3 * dec_s:.1f} ms, "
                         f"{h * w / (enc_s + dec_s) / 1e6:.4f} MP/s")
            log(f"{key} ({w}x{h}) {tag(q)}: {len(s)} B stream and decoded "
                f"pixels match the pins"
                + (", decode returns the image" if q is None else "")
                + f"; launches {c}{walls} | {card}")

        cfg = T.CodecConfig(4, 0, 6, None)
        reset()
        bs, benc_s = sync_time(lambda: T.compress_batch(imgs, cfg,
                                                        device=dev))
        bd, bdec_s = sync_time(lambda: D.decompress_batch(
            bs, cfg, np.uint16, device=dev))
        c = counts()
        for i, st_i in enumerate(bs):
            check_pin(f"{key} v{i} unlimited stream",
                      hashlib.sha256(st_i).hexdigest())
            one = T.decompress(st_i, cfg, np.uint16, device=dev)
            if not (np.array_equal(bd[i], one)
                    and np.array_equal(one, imgs[i])):
                raise AssertionError(f"{key} batch image {i}: decode "
                                     "differs from the single call")
        res["launches"][f"{key} batch"] = c
        split = ""
        if key == "gray1024":
            cap, low = D.PASS_BYTES, max(sum(map(len, bs)) // 3,
                                         max(map(len, bs)) + 1)
            D.PASS_BYTES = low
            try:
                npass = len(D._passes(bs))
                sd = D.decompress_batch(bs, cfg, np.uint16, device=dev)
            finally:
                D.PASS_BYTES = cap
            if npass < 2 or not all(np.array_equal(a, b)
                                    for a, b in zip(sd, bd)):
                raise AssertionError(f"decode in {npass} passes differs "
                                     "from the unsplit batch")
            res["split_passes"] = npass
            split = (f"; with the blob cap lowered to {low} B the batch "
                     f"decodes in {npass} passes, equal")
        mps = len(imgs) * h * w / (benc_s + bdec_s) / 1e6
        log(f"{key} batch of {len(imgs)}: streams match the pins, "
            f"decompress_batch == single decompress == the images; "
            f"{sum(map(len, bs))} B; encode {benc_s:.3f} s, decode "
            f"{bdec_s:.3f} s ({mps:.3f} MP/s); launches {c}{split} | "
            f"{card}")

    # colour
    planes = color_planes(images["color1024"], np.uint16)
    for q in LONG_LANE_QUOTAS:
        cfg = T.CodecConfig(4, 0, 6, q)
        reset()
        s = TC.compress_yuv(*planes, cfg, device=dev)
        d = TC.decompress_yuv(s, cfg, np.uint16, device=dev)
        c = counts()
        check_pin(f"color1024 {tag(q)} stream", hashlib.sha256(s).hexdigest())
        check_pin(f"color1024 {tag(q)} decoded", planes_sha(d))
        if q is None and not all(np.array_equal(a, b)
                                 for a, b in zip(d, planes)):
            raise AssertionError("color1024: lossless decode differs")
        if min(c.values()) <= 0:
            raise AssertionError(f"color1024 {tag(q)}: a kernel did not "
                                 f"launch: {c}")
        res["launches"][f"color1024 {tag(q)}"] = c
        walls = ""
        if q is None:
            _s, enc_s = timed(lambda: TC.compress_yuv(*planes, cfg,
                                                      device=dev))
            _d, dec_s = timed(lambda: TC.decompress_yuv(s, cfg, np.uint16,
                                                        device=dev))
            res["walls"]["color1024"] = (1e3 * enc_s, 1e3 * dec_s)
            walls = (f"; wall (median of 3) encode {1e3 * enc_s:.1f} ms, "
                     f"decode {1e3 * dec_s:.1f} ms")
        log(f"color1024 {tag(q)}: {len(s)} B stream and decoded planes "
            f"match the pins"
            + (", decode returns Y, U and V" if q is None else "")
            + f"; launches {c}{walls} | {card}")

    # kernel 2's placement on the 1024x1024 stage-1 unit
    cfg = T.CodecConfig(4, 0, 6, None)
    s0 = T.compress(images["gray1024"][0], cfg, device=dev)
    _w, _h, _ll, blob, units = D.plan_batch([s0], cfg, np.uint16)
    st = torch.as_tensor(blob, device=dev)
    big = max(range(len(units)),
              key=lambda i: units[i]["hmax"] * units[i]["wmax"])
    a = D.unit_inputs(units, dev)[big]
    auto = PDc.decode_planes(st, *a, 8, 15)
    res["placement"] = PDc.decode_planes.placement
    forced = PDc.decode_planes(st, *a, 8, 15, _placement="device")
    for nm, x, y in zip(("out", "err", "pos"), auto, forced):
        assert_equal(f"K2 1024x1024 stage-1 {res['placement']} vs device "
                     f"placement {nm}", x, y)
    ub = units[big]
    log(f"K2 1024x1024 stage-1 unit ({ub['offs'].shape[1]} lanes, canvas "
        f"{ub['hmax']}x{ub['wmax']} = {4 * ub['hmax'] * ub['wmax']} B of "
        f"int32): auto placement ran {res['placement']!r}, bit-equal to the "
        f"device-memory placement")

    # kernel 1's two-word instance on the 1024x1024 stage-1 bucket
    # (``long_lane_block``) with the side buffer the encoder sizes, against
    # its plain version at that shape, run on the host CPU since the
    # script's start
    h, w = images["gray1024"].shape[1:]
    nev = ES.eviction_rows(bw.shape[0])
    kw = ES.encode_lanes_slim_two_word(bw, nev)
    res["k1w_err"], plain_s = host.check("K1 two-word 1024x1024 stage-1",
                                         kw, TWO_WORD_OUTS)
    res["k1w_plain_ms"] = 1e3 * plain_s
    res["k1w_top"] = top_ordinal(kw)
    res["k1w_ms"] = event_ms(lambda: ES.encode_lanes_slim_two_word(bw, nev))
    res["k1w_bound"] = k1_bound(bw, kw[3], nev)
    res["k1w_shape"] = tuple(bw.shape)
    log(f"K1 two-word instance, 1024x1024 stage-1 launch {tuple(bw.shape)}, "
        f"{nev} side-buffer rows: outputs bit-equal to plain (tolerance 0); "
        f"largest ordinal written {res['k1w_top']}, most allocations in a "
        f"lane {int(kw[3][1].max())}, evictions max {int(kw[3][2].max())}, "
        f"lanes flagged {int((kw[3][0] != 0).sum())}; kernel "
        f"{res['k1w_ms']:.3f} ms (the earlier instance's 15.484 ms, "
        f"PERF.md; bound {res['k1w_bound'][0]:.4f} ms, "
        f"{res['k1w_bound'][1]}; {1e6 * res['k1w_ms'] / bw.shape[0]:.1f} ns "
        f"per step), plain on the host CPU {plain_s:.1f} s | {card}")
    del kw
    enc = T.make_encoder(w, h, cfg, np.uint16, dev, graph=False)

    # device memory of one eager encode pass per coder word, in each mode
    # (a captured pass holds the same in its graph's pool)
    per_word = {}
    for mode, e, imgs in (("two-word", enc, images["gray1024"][:4]),
                          ("fused", T.make_encoder(
                              batch8.shape[2], batch8.shape[1], cfg,
                              np.uint16, dev, graph=False),
                           np.concatenate([batch8] * 4))):
        pk, words = coder_bytes_per_word(e, imgs)
        per_word[mode] = pk / words
        log(f"encode pass, {mode} records ({len(imgs)} images of "
            f"{imgs.shape[2]}x{imgs.shape[1]}, largest bucket {words} coder "
            f"words): peak {pk / 1e9:.2f} GB above the baseline, "
            f"{pk / words:.1f} B per coder word | {card}")
    res["bytes_per_word"] = per_word
    return res


def cli_defaults_phase(dev, card, boat):
    """Phase 21: the CLI's batch operations at their defaults
    (``--batch-size 56 --pipeline 4``) on a folder of 8 colour 1024x1024
    PNGs (variants of ``color_boat`` of boat tiled 2x2, noise of +-6 from
    seed 1234), ``-c``: every stream equals ``compress_yuv`` at the CLI's
    default quota and every decode ``decompress_yuv``; peak device
    memory of each operation.  Also returns the bytes the graph pool holds
    after it and batch-compress's peak with every pass eager."""
    from icer_compression_tpu_torch import cli
    from icer_compression_tpu_torch.models import color as TC
    from icer_compression_tpu_torch.models import grayscale as T
    from icer_compression_tpu_torch.ops import entropy_slim as ES
    from icer_compression_tpu_torch.ops import plane_decode as PDc
    from icer_compression_tpu_torch.utils.colorspace import ycbcr_to_rgb
    from icer_compression_tpu_torch.utils.image_io import read_png, write_png

    rgb = color_boat(np.tile(boat, (2, 2)).astype(np.uint8))
    rng = np.random.default_rng(1234)
    h, w = rgb.shape[:2]
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        (tmp / "in").mkdir()
        for i in range(8):
            write_png(tmp / "in" / f"c{i}.png", np.clip(
                rgb.astype(np.int32) + rng.integers(-6, 7, rgb.shape), 0,
                255).astype(np.uint8))
        for op, src, dst in (("batch-compress", "in", "enc"),
                             ("batch-decompress", "enc", "dec")):
            ES.encode_lanes_slim.launches = 0
            ES.encode_lanes_slim_two_word.launches = 0
            PDc.decode_planes.launches = 0
            reset_runs()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            if cli.main([op, str(tmp / src), str(tmp / dst), "-c",
                         "--batch-size", "56", "--pipeline", "4", "--device",
                         dev.type]) != 0:
                raise AssertionError(f"cli {op} failed")
            torch.cuda.synchronize()
            res[op] = {
                "wall_s": time.perf_counter() - t0,
                "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
                "peak_reserved_gb": torch.cuda.max_memory_reserved() / 1e9,
                "launches": {
                    "slim_encode": encode_runs()["slim_encode"],
                    "slim_encode_two_word":
                        encode_runs()["slim_encode_two_word"],
                    "plane_decode": encode_runs()["plane_decode"]}}
        ccfg = T.CodecConfig(4, 0, 6, 3 * h * w)
        for i in range(8):
            planes = color_planes(read_png(tmp / "in" / f"c{i}.png"),
                                  np.uint16)
            s = TC.compress_yuv(*planes, ccfg, device=dev)
            if (tmp / "enc" / f"c{i}.icer").read_bytes() != s:
                raise AssertionError(f"cli defaults stream c{i} differs "
                                     "from compress_yuv")
            back = ycbcr_to_rgb(*TC.decompress_yuv(s, ccfg, np.uint16,
                                                   device=dev))
            if not np.array_equal(read_png(tmp / "dec" / f"c{i}.png"), back):
                raise AssertionError(f"cli defaults decode c{i} differs "
                                     "from decompress_yuv")
        # the same batch-compress with every pass eager, for its peak
        from icer_compression_tpu_torch.backend import graph_cache as GC
        graph = {"reserved": GC.reserved_bytes(dev)
                 + GC.CACHE.table_bytes(dev),
                 "bound": GC.CACHE.bound(dev),
                 "peak": res["batch-compress"]["peak_allocated_gb"] * 1e9}
        if graph["reserved"] > graph["bound"]:
            raise AssertionError(f"cli defaults: the graphs' pools and "
                                 f"tables hold {graph['reserved']} B, "
                                 f"past their bound "
                                 f"{graph['bound']} B")
        with eager_passes():
            _r, graph["eager_s"], graph["eager_peak"] = peak(
                lambda: cli.main(["batch-compress", str(tmp / "in"),
                                  str(tmp / "eager"), "-c", "--batch-size",
                                  "56", "--pipeline", "4", "--device",
                                  dev.type]))
        for i in range(8):
            if (tmp / "eager" / f"c{i}.icer").read_bytes() != \
                    (tmp / "enc" / f"c{i}.icer").read_bytes():
                raise AssertionError(f"cli defaults c{i}: eager passes give "
                                     "another stream")
    log(f"cli defaults batch-compress: graph pools reserve "
        f"{graph['reserved'] / 1e9:.2f} GB after it against their bound "
        f"{graph['bound'] / 1e9:.2f} GB; its peak allocated "
        f"{graph['peak'] / 1e9:.2f} GB, with every pass eager "
        f"{graph['eager_peak'] / 1e9:.2f} GB above the baseline "
        f"({graph['eager_s']:.3f} s), the same streams | {card}")
    if res["batch-compress"]["launches"]["slim_encode_two_word"] <= 0:
        raise AssertionError("cli defaults: the two-word instance of kernel "
                             "1 did not launch")
    for op, r in res.items():
        log(f"cli {op} -c at its defaults (--batch-size 56 --pipeline 4), 8 "
            f"colour {w}x{h} PNGs: wall {r['wall_s']:.3f} s "
            f"({8 * h * w / r['wall_s'] / 1e6:.3f} MP/s), device peak "
            f"allocated {r['peak_allocated_gb']:.2f} GB, reserved "
            f"{r['peak_reserved_gb']:.2f} GB; launches {r['launches']} | "
            f"{card}")
    log("cli defaults: streams equal compress_yuv and decodes equal "
        "decompress_yuv for all 8 images")
    return res, graph


def big_blocks(dev, boat):
    """Phase 25's kernel inputs from the 1600x1200 image at the CLI's
    defaults, on the host: kernel 1's stage-1 bucket words (L, lanes) and
    kernel 4's compacted block of the same bucket, (valid, ctx, bit), each
    (Lc, lanes)."""
    from icer_compression_tpu_torch.models import grayscale as T
    from icer_compression_tpu_torch.ops import encode as E
    img = _tiled(boat, 1200, 1600)
    enc = T.make_encoder(1600, 1200, T.CodecConfig(4, 0, 6, None),
                         np.uint16, dev)
    x = torch.as_tensor(img.astype(np.int32), device=dev)
    em = [enc.emit(g, enc.transform(x)[0]) for g in enc.groups]
    b0 = enc.buckets[0]
    words = enc.bucket_words(b0, em)
    cw, _over = E.compact_words(words, E.bucket_sizes(b0["L"])[1])
    return words.t().contiguous().cpu(), [
        t.t().contiguous().cpu() for t in E._split_words(cw)]


def big_image_phase(dev, card, boat, pins, host, k1_block, k4_ins):
    """Phase 25: frames whose lanes pass 2^17 slots, at the CLI's defaults
    (stages 4, filter A, 6 segments), through the default ``auto`` coder:
    kernel 1 on every bucket, its two-word instance (side buffer sized by
    ``eviction_rows``) on the long ones.  1600x1200 and the first
    2048x2048 variant through ``compress_batch`` with ``make_encoder``'s
    encoder (lossless) and ``compress`` (quota 200,000), then
    ``decompress``; the 2048x2048 batch through ``compress_batch`` /
    ``decompress_batch`` (device passes under ``PASS_WORDS``); colour
    1600x1200 through ``compress_yuv`` / ``decompress_yuv``, and
    ``COLOR_INFLIGHT`` batches of ``COLOR_BATCH`` colour variants through
    ``compress_yuv_batch`` (defer), all dispatched before the first is
    collected, each stream equal to ``compress_yuv``'s; 5120x3840
    lossless once; the CLI's ``batch-compress -c`` / ``batch-decompress
    -c`` at their defaults on ``BIG_CLI`` colour PNGs.  Every stream and
    decode equals its pin from the JAX package, lossless decodes return
    the input, kernel 1 launches on every image and kernel 4 on none.
    Logs each bucket's coder and instance, each kernel-1 launch's
    CUDA-event time beside its bound, the host lanes with their causes
    (none may be an eviction), the walls and the peak device memory; each
    lossless frame again through ``entropy="pallas"`` (kernel 4 and the
    host re-encode of its flush lanes) in the same run; the ``sorted``
    backend's wall on 1600x1200; kernel 1's two-word instance against its
    plain version (on the host CPU) on 1600x1200's stage-1 bucket, kernel
    4 on its compacted block; device bytes per coder word of the largest
    two-word pass."""
    from icer_compression_tpu_torch import cli
    from icer_compression_tpu_torch.models import color as TC
    from icer_compression_tpu_torch.models import decode as D
    from icer_compression_tpu_torch.models import grayscale as T
    from icer_compression_tpu_torch.ops import encode as E
    from icer_compression_tpu_torch.ops import entropy_full as EF
    from icer_compression_tpu_torch.ops import entropy_slim as ES
    from icer_compression_tpu_torch.ops import plane_decode as PDc
    from icer_compression_tpu_torch.utils.image_io import read_png, write_png

    images = big_images(boat)
    k4, launch = EF.encode_lanes_full, ES._launch
    seen = []   # (shape, nev, valid steps, misc, start, end) per K1 launch
    res = {"launches": {}, "images": {}, "pallas": {}}

    def timed_launch(words, nev):
        """Kernel 1's launches on the path, bracketed by CUDA events (not
        while a pass is being captured: a replay runs no Python)."""
        if torch.cuda.is_current_stream_capturing():
            return launch(words, nev)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = launch(words, nev)
        b.record()
        seen.append((tuple(words.shape), nev, (words & 1).sum(),
                     out[2 if nev is None else 3], a, b))
        return out

    def reset():
        ES.encode_lanes_slim.launches = 0
        ES.encode_lanes_slim_two_word.launches = 0
        k4.launches = 0
        PDc.decode_planes.launches = 0
        reset_runs()
        seen.clear()

    def counts():
        runs = encode_runs()
        return {"slim_encode": runs["slim_encode"],
                "slim_encode_two_word": runs["slim_encode_two_word"],
                "slim_pack": runs["slim_pack"],
                "slim_pack_two_word": runs["slim_pack_two_word"],
                "full_encode": runs["full_encode"],
                "plane_decode": encode_runs()["plane_decode"]}

    def check_pin(label, digest):
        if digest != pins[label]:
            raise AssertionError(f"{label}: {digest} != pin {pins[label]}")

    def check_launches(label, c):
        if c["full_encode"] or c["plane_decode"] <= 0 or \
                c["slim_encode"] + c["slim_encode_two_word"] <= 0:
            raise AssertionError(f"{label}: kernel 1 and 2 must launch and "
                                 f"kernel 4 not: {c}")
        res["launches"][label] = c

    def k1_launches():
        """[(shape, nev, ms, bound)] of the K1 launches since ``reset``."""
        torch.cuda.synchronize()
        return [(shape, nev, a.elapsed_time(b),
                 k1_bound(shape, misc, nev, int(nv)))
                for shape, nev, nv, misc, a, b in seen]

    def plan(enc):
        """Each bucket's (Lk, instance); the auto rule holds on every one:
        kernel 1, fused-key where ``fused_key_ok``, else two-word."""
        out = []
        for b in enc.buckets:
            Lk = E.bucket_sizes(b["L"])[0]
            if b["coder"] != "slim":
                raise AssertionError(f"bucket of {Lk} slots planned on "
                                     f"{b['coder']}, not slim")
            out.append((Lk, "fused" if ES.fused_key_ok(Lk) else "two-word"))
        return out

    def causes(enc, lanes):
        """{cause: lanes} of the host lanes (bucket, row, bits, evictions):
        a payload past its bucket's cap, more evictions than the side
        buffer holds, else more records than the compacted length."""
        out = {}
        for bi, _r, nb, nflush in lanes:
            Lk, _Lc, cap = E.bucket_sizes(enc.buckets[bi]["L"])
            nev = ES.NEV if ES.fused_key_ok(Lk) else ES.eviction_rows(Lk)
            cause = ("cap" if nb > cap else "eviction" if nflush > nev
                     else "slice")
            out[cause] = out.get(cause, 0) + 1
        return out

    def pallas(key, img, cfg, want):
        """The same lossless frame through ``entropy="pallas"``: wall,
        kernel-4 launches, host lanes and their seconds (the stream must
        equal the default path's; the sequential coder, seconds a lane
        at these lengths, is not run on its hundreds of host lanes:
        phases 7-9 hold the native runtime to it)."""
        h, w = img.shape
        penc = T.make_encoder(w, h, cfg, np.uint16, dev, entropy="pallas")
        reset()
        s, secs, pk = peak(lambda: T.compress_batch(img[None], cfg,
                                                    encoder=penc)[0])
        if s != want:
            raise AssertionError(f"{key}: pallas stream differs from auto")
        r = {"enc_s": secs, "k4_launches": k4.launches,
             "host": penc.fallback_lanes, "host_s": penc.fallback_seconds,
             "enc_peak": pk}
        res["pallas"][key] = r
        log(f"{key} lossless through entropy=pallas (K4 and the host): "
            f"stream equal; encode wall (run once) {secs:.3f} s, K4 "
            f"launches {k4.launches}, host re-encode lanes {r['host']} in "
            f"{r['host_s']:.3f} s, peak {pk / 1e9:.2f} GB | {card}")

    def gray(key, img, q):
        h, w = img.shape
        cfg = T.CodecConfig(4, 0, 6, q)
        tag = "unlimited" if q is None else f"quota {q}"
        enc = T.make_encoder(w, h, cfg, np.uint16, dev)
        hseen = watch_host_lanes(enc)
        reset()
        if q is None:
            s, enc_s, enc_pk = peak(lambda: T.compress_batch(
                img[None], cfg, encoder=enc)[0])
        else:
            s, enc_s, enc_pk = peak(lambda: T.compress(img, cfg, device=dev))
        launches = k1_launches()
        d, dec_s, dec_pk = peak(lambda: T.decompress(s, cfg, np.uint16,
                                                     device=dev))
        c = counts()
        check_pin(f"{key} v0 {tag} stream", hashlib.sha256(s).hexdigest())
        check_pin(f"{key} v0 {tag} decoded", pixels_sha(d))
        if q is None and not np.array_equal(d, img):
            raise AssertionError(f"{key}: lossless decode differs")
        check_launches(f"{key} {tag}", c)
        coders = plan(enc)
        r = {"enc_s": enc_s, "dec_s": dec_s, "enc_peak": enc_pk,
             "k1": launches}
        if q is None:
            calls = sum(-(-b["rows"] // b["call_rows"]) for b in enc.buckets
                        if not ES.fused_key_ok(E.bucket_sizes(b["L"])[0]))
            if c["slim_encode_two_word"] != calls:
                raise AssertionError(f"{key}: {c['slim_encode_two_word']} "
                                     f"two-word launches, {calls} planned")
            lanes = []
            check_host_lanes(f"{key} auto", hseen, lanes)
            why = causes(enc, lanes)
            if "eviction" in why:
                raise AssertionError(f"{key}: host lanes for an eviction: "
                                     f"{why}")
            r.update(host=enc.fallback_lanes, host_s=enc.fallback_seconds,
                     causes=why, rows=sum(b["rows"] for b in enc.buckets))
        res["images"][f"{key} {tag}"] = r
        log(f"{key} ({w}x{h}) {tag}: {len(s)} B stream and decoded pixels "
            f"match the pins" + (", decode returns the image"
                                 if q is None else "")
            + f"; buckets (Lk, instance) {coders}; K1 launches "
            + ", ".join(f"{sh} nev {nev}: {ms:.3f} ms (bound {bd[0]:.4f} "
                        f"ms, {bd[1]}; {1e6 * ms / sh[0]:.1f} ns per step)"
                        for sh, nev, ms, bd in launches)
            + (f"; host re-encode lanes {r['host']} of {r['rows']} in "
               f"{r['host_s']:.3f} s, causes {r['causes']}"
               if q is None else "")
            + f"; wall (run once) encode {enc_s:.3f} s, decode {dec_s:.3f} "
            f"s; peak device memory above the baseline encode "
            f"{enc_pk / 1e9:.2f} GB, decode {dec_pk / 1e9:.2f} GB; "
            f"launches {c} | {card}")
        if q is None:
            pallas(key, img, cfg, s)

    ES._launch = timed_launch
    try:
        for q in BIG_QUOTAS:
            gray("gray1600x1200", images["gray1600x1200"][0], q)
            gray("gray2048", images["gray2048"][0], q)

        # the 2048x2048 batch, in device passes under PASS_WORDS
        imgs = images["gray2048"]
        cfg = T.CodecConfig(4, 0, 6, None)
        reset()
        bs, benc_s, benc_pk = peak(lambda: T.compress_batch(imgs, cfg,
                                                            device=dev))
        bd, bdec_s, bdec_pk = peak(lambda: D.decompress_batch(
            bs, cfg, np.uint16, device=dev))
        c = counts()
        for i, (st_i, d_i) in enumerate(zip(bs, bd)):
            check_pin(f"gray2048 v{i} unlimited stream",
                      hashlib.sha256(st_i).hexdigest())
            if not np.array_equal(d_i, imgs[i]):
                raise AssertionError(f"gray2048 batch image {i}: lossless "
                                     "decode differs")
        check_launches("gray2048 batch", c)
        bh, bw = imgs.shape[1:]
        per_pass = T.make_encoder(bw, bh, cfg, np.uint16, dev).pass_images
        npass = -(-len(imgs) // per_pass)
        if npass < 2:
            raise AssertionError(f"gray2048 batch ran in {npass} pass")
        log(f"gray2048 batch of {len(imgs)}: streams match the pins, "
            f"decodes return the images; {npass} device passes of at most "
            f"{per_pass} image(s); encode {benc_s:.3f} s, decode "
            f"{bdec_s:.3f} s ({imgs.size / (benc_s + bdec_s) / 1e6:.3f} "
            f"MP/s); peak device memory encode {benc_pk / 1e9:.2f} GB, "
            f"decode {bdec_pk / 1e9:.2f} GB; launches {c} | {card}")

        # colour
        planes = color_planes(images["color1600x1200"], np.uint16)
        for q in BIG_QUOTAS:
            cfg = T.CodecConfig(4, 0, 6, q)
            tag = "unlimited" if q is None else f"quota {q}"
            reset()
            s, enc_s, enc_pk = peak(lambda: TC.compress_yuv(*planes, cfg,
                                                            device=dev))
            d, dec_s, _pk = peak(lambda: TC.decompress_yuv(
                s, cfg, np.uint16, device=dev))
            c = counts()
            check_pin(f"color1600x1200 {tag} stream",
                      hashlib.sha256(s).hexdigest())
            check_pin(f"color1600x1200 {tag} decoded", planes_sha(d))
            if q is None and not all(np.array_equal(a, b)
                                     for a, b in zip(d, planes)):
                raise AssertionError("color1600x1200: lossless decode "
                                     "differs")
            check_launches(f"color1600x1200 {tag}", c)
            res["images"][f"color1600x1200 {tag}"] = {
                "enc_s": enc_s, "dec_s": dec_s, "enc_peak": enc_pk}
            log(f"color1600x1200 {tag}: {len(s)} B stream and decoded "
                f"planes match the pins"
                + (", decode returns Y, U and V" if q is None else "")
                + f"; wall (run once) encode {enc_s:.3f} s, decode "
                f"{dec_s:.3f} s; peak device memory encode "
                f"{enc_pk / 1e9:.2f} GB; launches {c} | {card}")

        # the CLI's colour batch at its defaults: COLOR_INFLIGHT batches
        # of COLOR_BATCH frames dispatched before the first is collected,
        # every batch's 3B canvases holding their coder words until then
        planes = [color_planes(f, np.uint16)
                  for f in color_batch(images["color1600x1200"])]
        cfg = T.CodecConfig(4, 0, 6, COLOR_QUOTA)
        want = [TC.compress_yuv(*p, cfg, device=dev) for p in planes]
        chans = [[p[c] for p in planes] for c in range(3)]
        reset()
        got, secs, pk = peak(lambda: [h() for h in [
            TC.compress_yuv_batch(*chans, cfg, device=dev, defer=True)
            for _ in range(COLOR_INFLIGHT)]])
        if any(g != want for g in got):
            raise AssertionError(f"color1600x1200 batch of {len(want)}: a "
                                 "stream differs from compress_yuv's")
        res["images"]["color1600x1200 batch"] = {"enc_s": secs,
                                                 "enc_peak": pk}
        log(f"color1600x1200 batch of {len(want)} at quota {COLOR_QUOTA}, "
            f"{COLOR_INFLIGHT} batches in flight: every stream equals "
            f"compress_yuv's; wall {secs:.3f} s (first use of the key "
            f"included), peak device memory {pk / 1e9:.2f} GB; launches "
            f"{counts()} | {card}")

        gray("gray5120x3840", images["gray5120x3840"][0], None)

        # the CLI's batch operations at their defaults
        with tempfile.TemporaryDirectory() as tmp:
            tmp = Path(tmp)
            (tmp / "in").mkdir()
            for i, rgb in enumerate(images["cli1600x1200"]):
                write_png(tmp / "in" / f"c{i}.png", rgb)
            for op, src, dst in (("batch-compress", "in", "enc"),
                                 ("batch-decompress", "enc", "dec")):
                reset()
                _r, secs, pk = peak(lambda: cli.main(
                    [op, str(tmp / src), str(tmp / dst), "-c", "--device",
                     dev.type]))
                if _r != 0:
                    raise AssertionError(f"cli {op} failed")
                res["cli " + op] = (secs, pk, counts())
            for i in range(BIG_CLI):
                check_pin(f"cli1600x1200 c{i} stream", hashlib.sha256(
                    (tmp / "enc" / f"c{i}.icer").read_bytes()).hexdigest())
                check_pin(f"cli1600x1200 c{i} decoded rgb",
                          pixels_sha(read_png(tmp / "dec" / f"c{i}.png")))
        cc = res["cli batch-compress"][2]
        if cc["slim_encode_two_word"] <= 0 or cc["full_encode"] or \
                res["cli batch-decompress"][2]["plane_decode"] <= 0:
            raise AssertionError(f"cli: a kernel did not launch: {res}")
        for op in ("batch-compress", "batch-decompress"):
            secs, pk, c = res["cli " + op]
            res["launches"]["cli " + op] = c
            log(f"cli {op} -c at its defaults, {BIG_CLI} colour 1600x1200 "
                f"PNGs: outputs match the pins; wall {secs:.3f} s, peak "
                f"device memory {pk / 1e9:.2f} GB; launches {c} | {card}")
    finally:
        ES._launch = launch

    # the sorted backend (the JAX package's default coder) on 1600x1200
    img = images["gray1600x1200"][0]
    h, w = img.shape
    cfg = T.CodecConfig(4, 0, 6, None)
    senc = T.make_encoder(w, h, cfg, np.uint16, dev, entropy="sorted")
    s, sorted_s, sorted_pk = peak(lambda: T.compress_batch(
        img[None], cfg, encoder=senc)[0])
    check_pin("gray1600x1200 v0 unlimited stream",
              hashlib.sha256(s).hexdigest())
    res["sorted"] = (sorted_s, senc.fallback_lanes, senc.fallback_seconds,
                     sorted_pk / senc.words_per_image)
    log(f"sorted backend, gray1600x1200 lossless: stream matches the pin; "
        f"encode wall (run once) {sorted_s:.3f} s, host re-encode lanes "
        f"{senc.fallback_lanes} in {senc.fallback_seconds:.3f} s, peak "
        f"device memory {sorted_pk / 1e9:.2f} GB, "
        f"{sorted_pk / senc.words_per_image:.1f} B per coder word (auto: "
        f"{res['images']['gray1600x1200 unlimited']['enc_s']:.3f} s) | "
        f"{card}")

    # kernel 1's two-word instance on 1600x1200's stage-1 bucket and kernel
    # 4 on its compacted block (``big_blocks``), against their plain
    # versions, run on the host CPU since the script's start
    words = k1_block.to(dev)
    nev = ES.eviction_rows(words.shape[0])
    kout = ES.encode_lanes_slim_two_word(words, nev)
    err, plain_s = host.check("K1 two-word 1600x1200 stage-1", kout,
                              TWO_WORD_OUTS)
    ms = event_ms(lambda: ES.encode_lanes_slim_two_word(words, nev), reps=3)
    bd = k1_bound(words, kout[3], nev)
    res["k1w"] = {"shape": tuple(words.shape), "ms": ms, "bound": bd,
                  "plain_ms": 1e3 * plain_s, "err": err, "nev": nev,
                  "top": top_ordinal(kout),
                  "evictions": int(kout[3][2].max())}
    log(f"K1 two-word 1600x1200 stage-1 bucket {tuple(words.shape)}, {nev} "
        f"side-buffer rows: outputs bit-equal to plain on the host CPU "
        f"(tolerance 0), plain {plain_s:.1f} s; largest ordinal "
        f"{res['k1w']['top']}, evictions max {res['k1w']['evictions']}, "
        f"lanes flagged {int((kout[3][0] != 0).sum())}; kernel {ms:.3f} ms "
        f"(median of 3; bound {bd[0]:.4f} ms, {bd[1]}; "
        f"{1e6 * ms / words.shape[0]:.1f} ns per step) | {card}")
    del words, kout
    ins = [t.to(dev) for t in k4_ins]
    kout = k4(*ins)
    err, plain_s = host.check("K4 1600x1200 stage-1", kout,
                              ("code", "nbits", "open"))
    ms = event_ms(lambda: k4(*ins), reps=3)
    bd = k4_bound(ins[0])
    chain = int(ins[0].sum(dim=0).max())
    res["k4"] = {"shape": tuple(ins[0].shape), "ms": ms, "bound": bd,
                 "plain_ms": 1e3 * plain_s, "err": err, "chain": chain}
    log(f"K4 1600x1200 stage-1 block {tuple(ins[0].shape)}: code/nbits/open "
        f"bit-equal to plain on the host CPU (tolerance 0), plain "
        f"{plain_s:.1f} s; kernel {ms:.3f} ms (median of 3; bound "
        f"{bd[0]:.4f} ms, {bd[1]}; {1e6 * ms / ins[0].shape[0]:.1f} ns per "
        f"slot, {1e6 * ms / chain:.1f} ns per valid step of the longest "
        f"lane, {chain} steps) | {card}")
    del ins, kout
    pk, words = coder_bytes_per_word(T.make_encoder(
        bw, bh, cfg, np.uint16, dev, graph=False), images["gray2048"][:1])
    res["bytes_per_word"] = pk / words
    log(f"encode pass, kernel 1's two-word instance on the largest bucket "
        f"(one 2048x2048 image, {words} coder words): peak "
        f"{pk / 1e9:.2f} GB above the baseline, {pk / words:.1f} B per "
        f"coder word | {card}")
    return res


# phase 27: each coder's peak device bytes per coder word in one encode
# pass of about 2^25 coder words and of a full pass (label, entropy, image
# set, pass sizes in images; "old" passes and calls sized as slim's):
# boat's noisy variants code fused-key records, 1024x1024's stage-1
# bucket two-word ones
PLAN_CASES = (("slim fused-key", "slim", "boat", (10, 37)),
              ("slim two-word", "slim", "gray1024", (3, 9)),
              ("pallas", "pallas", "gray1024", (3, 9)),
              ("sorted", "sorted", "gray1024", (3,)),
              ("sorted", "sorted", "gray1024", (9,), "old"))


def plan_images(boat: np.ndarray, n_boat: int, n_1024: int) -> dict:
    """Phase 27's images: ``n_boat`` noisy variants of boat (phase 4's
    recipe, whose first 8 they are) and ``n_1024`` of boat tiled to
    1024x1024 (``_tiled``, whose first 7 are phase 20's pinned batch)."""
    rng = np.random.default_rng(1234)
    return {"boat": np.clip(boat[None].astype(np.int32) + rng.integers(
                -6, 7, (n_boat,) + boat.shape), 0, 255).astype(np.uint16),
            "gray1024": _tiled(boat, 1024, 1024, n_1024)}


def pass_peak(enc, imgs, old: bool = False) -> dict:
    """One encode pass of ``imgs`` (``enc.pass_images`` set to their
    count; ``old``: every bucket's calls sized as slim's, the plan before
    each coder had its own): peak device bytes above the baseline, the
    pass's coder words (its largest bucket's), B per word, seconds and
    host re-encode lanes."""
    from icer_compression_tpu_torch.ops import encode as E
    enc.pass_images = len(imgs)
    if old:
        for b in enc.buckets:
            b["call_rows"] = max(1, E.CALL_WORDS
                                 // E.bucket_sizes(b["L"])[0])
    torch.cuda.empty_cache()
    _out, secs, pk = peak(lambda: enc.encode_batch(imgs))
    words = len(imgs) * enc.words_per_image
    return {"images": len(imgs), "words": words, "peak": pk,
            "bpw": pk / words, "s": secs, "host": enc.fallback_lanes}


def coder_plan_phase(dev, card, boat) -> dict:
    """Phase 27: each coder's peak device bytes per coder word at each pass
    size of ``PLAN_CASES``, one eager pass each (lossless s4 fA g6; a
    captured pass holds its peak in the graph pool instead)."""
    from icer_compression_tpu_torch.models import grayscale as T
    imgs = plan_images(boat, *(max(max(c[3]) for c in PLAN_CASES
                                   if c[2] == key)
                               for key in ("boat", "gray1024")))
    cfg = T.CodecConfig(4, 0, 6, None)
    res = {}
    for label, entropy, key, sizes, *old in PLAN_CASES:
        for n in sizes:
            batch = imgs[key][:n]
            enc = T.make_encoder(batch.shape[2], batch.shape[1], cfg,
                                 np.uint16, dev, entropy=entropy, graph=False)
            r = pass_peak(enc, batch, bool(old))
            res[f"{label} {key} x{n}" + (" old plan" if old else "")] = r
            log(f"coder {label}{' (old plan)' if old else ''}, one pass of "
                f"{n} {key} images ({r['words']} coder words, 2^"
                f"{np.log2(r['words']):.2f}): peak {r['peak'] / 1e9:.2f} GB "
                f"above the baseline, {r['bpw']:.1f} B per coder word; "
                f"{r['s']:.3f} s, host lanes {r['host']} | {card}")
            del enc
    return res


# phase 28: 1024x1024 images through ``sorted``, as many as a slim pass
# takes, and the 7 pinned in phase 20 among them
SORTED_BATCH = 9


def sorted_pass_phase(dev, card, boat, long_pins, big_pins) -> dict:
    """Phase 28: the ``sorted`` coder (the JAX encoders' default) at full
    passes under its own plan, lossless s4 fA g6: ``SORTED_BATCH``
    1024x1024 images, a slim pass's worth, so at least two of its passes,
    and phase 25's 5120x3840 frame (its buckets in calls of a third of
    slim's).  Each stream equals its pin (phase 20's, phase 25's) or the
    ``auto`` stream of the same image; each peak stays within the pass
    budget, ``ops.encode.PASS_PEAK_BYTES``: a full pass at slim
    two-word's peak per coder word while its tail was a sort, which
    sorted's ``CODER_DIVISORS`` entry was sized against (slim's own full
    pass now peaks far lower, phase 27).  Its passes run eagerly, as phase 27's,
    so that the peaks are theirs."""
    from icer_compression_tpu_torch.models import grayscale as T
    from icer_compression_tpu_torch.ops import encode as E
    cfg = T.CodecConfig(4, 0, 6, None)
    res = {}
    imgs = _tiled(boat, 1024, 1024, SORTED_BATCH)
    frame = _tiled(boat, 3840, 5120)
    budget = E.PASS_PEAK_BYTES
    for key, batch in (("gray1024", imgs), ("gray5120x3840", frame)):
        h, w = batch.shape[1:]
        enc = T.make_encoder(w, h, cfg, np.uint16, dev, entropy="sorted",
                             graph=False)
        auto = T.make_encoder(w, h, cfg, np.uint16, dev, graph=False)
        passes = -(-len(batch) // enc.pass_images)
        per = min(len(batch), enc.pass_images)
        calls = [-(-per * b["rows"] // b["call_rows"]) for b in enc.buckets]
        # the batch fills a slim pass and takes two of sorted's or more;
        # the frame's stage-1 bucket takes two of sorted's calls or more
        if (len(batch) < auto.pass_images or passes < 2) if len(batch) > 1 \
                else calls[0] < 2:
            raise AssertionError(f"sorted {key}: {len(batch)} images, "
                                 f"{passes} passes of {enc.pass_images}, "
                                 f"{calls[0]} stage-1 calls a pass")
        torch.cuda.empty_cache()
        streams, secs, pk = peak(lambda: T.compress_batch(
            batch, cfg, encoder=enc))
        pinned = [f"{key} v{i} unlimited stream" for i in range(len(batch))]
        rest = [i for i, p in enumerate(pinned) if p not in (
            long_pins if key == "gray1024" else big_pins)]
        want = dict(zip(rest, T.compress_batch(batch[rest], cfg,
                                               encoder=auto))) \
            if rest else {}
        for i, s in enumerate(streams):
            if i in want:
                if s != want[i]:
                    raise AssertionError(f"sorted {key} v{i}: stream differs "
                                         "from auto's")
            elif hashlib.sha256(s).hexdigest() != {
                    **long_pins, **big_pins}[pinned[i]]:
                raise AssertionError(f"sorted {key} v{i}: stream differs "
                                     "from its pin")
        if pk > budget:
            raise AssertionError(f"sorted {key}: peak {pk} B above the "
                                 f"budget {budget} B")
        res[key] = {"images": len(batch), "passes": passes, "calls": calls,
                    "s": secs, "peak": pk, "budget": budget,
                    "host": enc.fallback_lanes,
                    "host_s": enc.fallback_seconds,
                    "pinned": len(batch) - len(rest)}
        log(f"sorted {key} x{len(batch)} lossless: {len(batch) - len(rest)} "
            f"streams match their pins, {len(rest)} auto's; {passes} passes "
            f"of {enc.pass_images} (auto: {auto.pass_images}), coder calls "
            f"a pass per bucket {calls}; wall (run once) {secs:.3f} s, host re-encode "
            f"lanes {enc.fallback_lanes} in {enc.fallback_seconds:.3f} s; "
            f"peak {pk / 1e9:.2f} GB above the baseline, budget "
            f"{budget / 1e9:.2f} GB | {card}")
        del enc, auto, streams
    return res


# phase 26: kernel W1's integer work per restored pair (the difference
# r[n+1]; the prediction's three multiply-adds, its d[n+1] term and shift;
# the high-pass add; the even sample's add, shift and add and the odd
# sample's subtract; three range checks of two compares; three wraps of
# three ops), for its bound
W1_OPS_PER_STEP = 27
# phase 26: at most this many kernels reach the card per boat s4 inverse
# DWT through W1 (8 passes, the canvas copy, the overflow word's zeroing
# and its test, with room to spare)
W1_INVERSE_KERNELS = 16
# phase 26's fuzz: a fixed count of trials from a fixed seed against the
# native host codec (400 took 53-58 s on an H100, which keeps the phase
# near two minutes)
FUZZ_TRIALS = 400
FUZZ_SEED = 26


def w1_bound(nc: int, lines: int, n: int):
    """Kernel W1, one pass: the block of ``nc`` canvases, ``lines`` lines
    of ``n`` samples, read once and written once (int32), and the
    overflow word; ops per restored pair of every line."""
    return bound(8 * nc * lines * n + 4,
                 W1_OPS_PER_STEP * nc * lines * (n // 2))


def lifting_semantics(dev) -> int:
    """The integer steps of the lifting path on the card against the host:
    floored division by 2, 4, 8 and 16 and ``>>`` on negative int32,
    ``_wrap`` at mag_bits 7 and 15, and ``forward_1d`` / ``inverse_1d``
    (the plain chain) of every filter at both sample widths on odd and
    even lines.  Returns the number of values held."""
    from icer_compression_tpu_torch.ops import wavelet as WV
    from icer_compression_tpu_torch.ops.bitutils import floor_div
    v = torch.arange(-(1 << 18), 1 << 18, 37, dtype=torch.int32)
    v = torch.cat([v, torch.tensor([-(1 << 31), (1 << 31) - 1, -1, 0, 1],
                                   dtype=torch.int32)])
    n = 0
    for name, fn in [(f"floor_div {d}", lambda t, d=d: floor_div(t, d))
                     for d in (2, 4, 8, 16)] \
            + [(f">> {s}", lambda t, s=s: t >> s) for s in (1, 2, 3, 4)] \
            + [(f"_wrap {m}", lambda t, m=m: WV._wrap(t, m)) for m in (7, 15)]:
        assert_equal(f"lifting {name} on the card", fn(v.to(dev)).cpu(),
                     fn(v))
        n += v.numel()
    rng = np.random.default_rng(26)
    for filt in range(7):
        for mag_bits in (7, 15):
            for size in (5, 6, 9, 64, 255):
                x = torch.from_numpy(rng.integers(
                    -(1 << mag_bits), 1 << mag_bits, (9, size))
                    .astype(np.int32))
                for fn in (WV.forward_1d, WV.inverse_1d):
                    got, gov = fn(x.to(dev), filt, mag_bits)
                    want, wov = fn(x, filt, mag_bits)
                    assert_equal(f"{fn.__name__} f{FILTERS[filt]} "
                                 f"mag_bits {mag_bits} N {size}", got.cpu(),
                                 want)
                    if bool(gov) != bool(wov):
                        raise AssertionError(
                            f"{fn.__name__} f{FILTERS[filt]} overflow flag "
                            f"{bool(gov)} on the card, {bool(wov)} on the "
                            "host")
                    n += x.numel()
    return n


def w1_against_plain(name, src, low_h, low_w, axis, filt, mag_bits):
    """W1's pass against its plain version on the same card, both into
    copies of ``src``: the canvases and the overflow word bit-equal.
    Returns (max abs difference, the plain version's seconds, the
    overflow word)."""
    from icer_compression_tpu_torch.ops import wavelet as WV
    got, gov = WV.inverse_pass(src, low_h, low_w, axis, filt, mag_bits)
    want = src.clone()
    wov = torch.zeros(1, dtype=torch.int32, device=src.device)
    _n, plain_s = sync_time(lambda: WV.inverse_pass_plain(
        src, low_h, low_w, axis, filt, mag_bits, want, wov))
    err = assert_equal(f"W1 {name}", got, want)
    if int(gov) != int(wov):
        raise AssertionError(f"W1 {name}: overflow word {int(gov)}, the "
                             f"plain version's {int(wov)}")
    return err, plain_s, int(gov)


def stage1_passes(dev, image, filt, axes=(0, 1)):
    """[(label, axis, canvases)] of the inverse DWT's last stage on
    ``image`` transformed at one stage by ``filt`` (mag_bits 15): the
    column pass reads the transformed canvas, the row pass that pass's
    output, as ``inverse_stages`` runs them."""
    from icer_compression_tpu_torch.ops import wavelet as WV
    x, _ov = WV.forward_stages(torch.as_tensor(
        image.astype(np.int32), device=dev)[None], 1, filt, 15)
    x = x.contiguous()
    cols, _ov = WV.inverse_pass(x, *x.shape[1:], 0, filt, 15,
                                torch.empty_like(x))
    return [(label, axis, src) for label, axis, src in
            (("column", 0, x), ("row", 1, cols)) if axis in axes]


def kernel_ms(fn, name: str, reps: int = 5) -> float:
    """Median device time in ms of the kernel ``name`` over ``reps`` calls
    of fn(), from the profiler's records of the card (the call's other
    launches and its host time left out).  The profiler has been seen to
    drop a record of a long launch, in three windows in a row once (the
    5120x3840 row pass): a window that does not hold ``reps`` records of
    ``name`` is profiled again, four times at most."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        times = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
                 if name in e.name
                 and e.device_type == torch.autograd.DeviceType.CUDA]
        if len(times) == reps:
            return statistics.median(times)
    raise AssertionError(f"the profiler saw {len(times)} launches of "
                         f"{name}, not {reps}, in five windows")


def count_launches(fn):
    """(kernels the profiler saw on the card, or None if it saw none; ops
    dispatched on the card's tensors; fn()'s result)."""
    from torch.profiler import ProfilerActivity, profile
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.ops += 1
            return func(*args, **(kwargs or {}))

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with Count():
            out = fn()
        torch.cuda.synchronize()
    kern = sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith(("Memcpy", "Memset")))
    return kern or None, Count.ops, out


def w1_phase(dev, card, boat):
    """Phase 26, first half: kernel W1 bit-equal to its plain version on
    the card, overflow word included (every filter, both sample widths,
    lines of 2-9 samples on both axes of stage blocks inside larger
    canvases; boat 512's stage-1 passes at fA, fB and fC, 2048x2048's at
    fF and a 5120x3840 stage-1 row pass at fB, each timed beside its
    bound), the lifting path's integer steps on the card against the
    host, and the inverse DWT's kernels, W1 launches and walls through W1
    and through the plain chain, alone and inside boat's fA and fB
    decodes."""
    from icer_compression_tpu_torch.models import grayscale as T
    from icer_compression_tpu_torch.ops import wavelet as WV
    res = {"err": 0}
    held = lifting_semantics(dev)
    log(f"lifting on the card: floor_div, >>, _wrap and forward_1d / "
        f"inverse_1d of every filter at mag_bits 7 and 15 equal the host's "
        f"({held} values)")
    rng = np.random.default_rng(2026)
    cases = overflowed = 0
    for filt in range(7):
        for mag_bits in (7, 15):
            for n in range(2, 10):
                for axis, lh, lw in ((0, n, 64), (1, 64, n)):
                    amp = 1 << (mag_bits - 3 * ((n + axis + filt) & 1))
                    x = torch.from_numpy(rng.integers(
                        -amp, amp, (2, 70, 72)).astype(np.int32)).to(dev)
                    err, _s, ov = w1_against_plain(
                        f"f{FILTERS[filt]} mag_bits {mag_bits} N {n} axis "
                        f"{axis}", x, lh, lw, axis, filt, mag_bits)
                    res["err"] = max(res["err"], err)
                    overflowed += ov
                    cases += 1
    if not 0 < overflowed < cases:
        raise AssertionError(f"W1's short lines: {overflowed} of {cases} "
                             "passes overflow (some must, some not)")
    log(f"W1 bit-equal to its plain version on the card, overflow word "
        f"included (tolerance 0): {cases} passes over 2 canvases of 70x72, "
        f"64 lines of 2-9 samples on each axis, filters A-F and Q, "
        f"mag_bits 7 and 15 ({overflowed} overflow)")
    res["passes"] = {}
    big = _tiled(boat, 2048, 2048)[0]
    huge = _tiled(boat, 3840, 5120)[0]
    for name, img, filt, axes in (
            ("boat 512", boat, 0, (0, 1)), ("boat 512", boat, 1, (0, 1)),
            ("boat 512", boat, 2, (0, 1)), ("2048x2048", big, 5, (0, 1)),
            ("5120x3840", huge, 1, (1,))):
        for label, axis, src in stage1_passes(dev, img, filt, axes):
            tag = f"{name} f{FILTERS[filt]} stage-1 {label} pass"
            nc, H, W = src.shape
            err, plain_s, _ov = w1_against_plain(tag, src, H, W, axis,
                                                 filt, 15)
            res["err"] = max(res["err"], err)
            out = torch.empty_like(src)
            ov = torch.zeros(1, dtype=torch.int32, device=dev)

            def call():
                return WV.inverse_pass(src, H, W, axis, filt, 15, out, ov)
            ms = kernel_ms(call, f"inverse_{label}_pass")
            call_ms = event_ms(call)
            lines, n = (W, H) if axis == 0 else (H, W)
            bd = w1_bound(nc, lines, n)
            res["passes"][tag] = {
                "lines": lines, "n": n, "ms": ms, "call_ms": call_ms,
                "plain_ms": 1e3 * plain_s, "bound": bd}
            log(f"W1 {tag} ({lines} lines of {n} samples): bit-equal to "
                f"plain; kernel {ms:.4f} ms on the card (profiler, median of "
                f"5; bound {bd[0]:.5f} ms, {bd[1]}; "
                f"{1e6 * ms / (n // 2):.1f} ns per restored pair of a line), "
                f"the wrapper's call {call_ms:.4f} ms (CUDA events), plain "
                f"on the card {1e3 * plain_s:.1f} ms | {card}")

    # the inverse DWT alone: kernels, dispatched ops, W1 launches and
    # walls through W1 and through the plain chain (at fA the path before
    # this W1)
    x = torch.as_tensor(boat.astype(np.int32), device=dev)[None]
    inv = {}
    for filt in (0, 1):
        img, _ov = WV.forward_stages(x, 4, filt, 15)
        for way, fn in (("W1", WV.inverse_stages),
                        ("plain chain", WV.inverse_stages_plain)):
            WV.inverse_pass.launches = 0
            kern, ops, (out, _ov) = count_launches(
                lambda: fn(img, 4, filt, 15))
            n_w1 = WV.inverse_pass.launches
            secs = [sync_time(lambda: fn(img, 4, filt, 15))[1]
                    for _ in range(3)]
            if not torch.equal(out, x):
                raise AssertionError(f"inverse DWT f{FILTERS[filt]} ({way}) "
                                     "of boat's forward transform differs "
                                     "from boat")
            # W1 is no aten op: its launches join the dispatched ops
            inv[f"f{FILTERS[filt]} {way}"] = {
                "kernels": kern, "ops": ops + n_w1, "w1": n_w1,
                "ms": 1e3 * statistics.median(secs)}
    res["inverse"] = inv
    for label, r in inv.items():
        log(f"inverse DWT boat 512 s4 {label}: {r['kernels']} kernels on "
            f"the card (profiler), {r['ops']} launches counted by dispatch, "
            f"W1 {r['w1']}; {r['ms']:.3f} ms (median of 3) | {card}")
    for f in "AB":
        r, p = inv[f"f{f} W1"], inv[f"f{f} plain chain"]
        seen = r["kernels"] if r["kernels"] else r["ops"]
        if r["w1"] != 2 * 4 or p["w1"] or seen > W1_INVERSE_KERNELS:
            raise AssertionError(
                f"f{f}'s s4 inverse DWT: {r} through W1 (8 W1 launches and "
                f"at most {W1_INVERSE_KERNELS} kernels), {p} through the "
                "plain chain (no W1)")

    # boat's fA (the main path) and fB decodes through W1 and through the
    # plain chain, in turns, eager (a graph would replay the inverse it
    # captured whichever is swapped in)
    res["decode"] = {}
    for filt in (0, 1):
        cfg = T.CodecConfig(4, filt, 6, None)
        s = T.compress(boat, cfg, device=dev)
        walls = {"W1": [], "plain chain": []}
        for way in ("W1", "plain chain", "plain chain", "W1", "W1",
                    "plain chain"):
            fn = WV.inverse_stages if way == "W1" \
                else WV.inverse_stages_plain
            with swapped(WV, "inverse_stages", fn):
                px, secs = sync_time(lambda: T.decompress(
                    s, cfg, np.uint16, device=dev, graph=False))
            if not np.array_equal(px, boat):
                raise AssertionError(f"f{FILTERS[filt]} decode ({way}) "
                                     "differs from boat")
            walls[way].append(secs)
        res["decode"][f"f{FILTERS[filt]}"] = {
            k: 1e3 * statistics.median(v) for k, v in walls.items()}
        log(f"boat 512 s4 f{FILTERS[filt]} g6 lossless decode wall (median "
            f"of 3, in turns): through W1 "
            f"{res['decode'][f'f{FILTERS[filt]}']['W1']:.2f} ms, through "
            f"the plain chain "
            f"{res['decode'][f'f{FILTERS[filt]}']['plain chain']:.2f} ms | "
            f"{card}")
    return res


def w1_entry(w1r, cfr, main_launches) -> dict:
    """Kernel W1's entry of the kernels line: its launches on the main
    path's fA decode (phase 3) and on the filter-B 512x512 decode of the
    configuration sweep, its time on boat's fA stage-1 column pass beside
    its bound and its plain version's, and every stage-1 pass."""
    col = w1r["passes"]["boat 512 fA stage-1 column pass"]
    return {
        "name": "wavelet_inverse", "route": "cuda",
        "source": "icer_compression_tpu_torch/csrc/wavelet.cu",
        "replaces": "icer_compression_tpu/ops/wavelet.py:383",
        "replaces_kind": "XLA: inverse_stages (inverse_1d per axis, the "
                         "recurrence's lax.scan at :282), no "
                         "pl.pallas_call",
        "launches": main_launches,
        "launches_fb_decode":
            cfr["launches"]["boat512 u16 fB s4 g6 lossless"]["W1"],
        "max_abs_err": w1r["err"], "equal_to_plain": True,
        "shape": f"lines={col['lines']} n={col['n']} (boat 512 fA stage-1 "
                 "column pass)",
        "ms": col["ms"], "plain_ms": col["plain_ms"],
        "bound_ms": col["bound"][0], "bound_by": col["bound"][1],
        "library_ms": None,
        "ns_per_step": 1e6 * col["ms"] / (col["n"] // 2),
        "step": "one restored pair of a line",
        "call_ms": col["call_ms"],
        "passes": {k: {"lines": v["lines"], "n": v["n"], "ms": v["ms"],
                       "call_ms": v["call_ms"], "plain_ms": v["plain_ms"],
                       "bound_ms": v["bound"][0], "bound_by": v["bound"][1]}
                   for k, v in w1r["passes"].items()},
        "inverse_dwt_boat_s4": w1r["inverse"],
        "decode_ms": w1r["decode"],
        "launches_by_path": {k: n["W1"] for k, n in cfr["launches"].items()},
        "path": "decompress of boat 512 at s4 fA g6, lossless (the main "
                "path)"}


def trace_phase(dev, card, boat):
    """Phase 26's trace: one boat 512 main-path encode and decode (s4 fA
    g6, lossless; warm, so both replay their captured graphs) under
    ``torch.profiler`` with the CPU and the card traced, each device
    record put in its layer (``utils/trace.layer_breakdown``: a replay's
    records by stage mark, the rest by the program's span around their
    launch); logs each layer's device ms, launches and host ms, each
    half's wall, busy time, idle share and host time between launches,
    and the program's counts.  Every record of a replay must fall after a
    stage mark."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from icer_compression_tpu_torch.models import grayscale as T
    cfg = T.CodecConfig(4, 0, 6, None)
    s = T.compress(boat, cfg, device=dev)
    for _ in range(3):          # each graph's eager passes, capture
        T.compress(boat, cfg, device=dev)
        T.decompress(s, cfg, np.uint16, device=dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("encode graph"):
            s3 = T.compress(boat, cfg, device=dev)
        with record_function("decode graph"):
            px3 = T.decompress(s, cfg, np.uint16, device=dev)
        torch.cuda.synchronize()
    if s3 != s or not np.array_equal(px3, boat):
        raise AssertionError("the traced main path differs")
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    res = {}
    for half in ("encode graph", "decode graph"):
        r = res[half] = layer_breakdown(events, half)
        log(f"trace, boat 512 main-path {half} (profiled): wall "
            f"{r['wall_ms']:.2f} ms, device busy {r['busy_ms']:.3f} ms, "
            f"idle share {r['idle_share']:.4f}, {r['launches']} launches "
            f"from {r['api_launches']} API calls, "
            f"{r['host_gap_us']:.1f} us of host between launches; counts "
            f"{r['counts']} | {card}")
        for layer, g in sorted(r["layers"].items(),
                               key=lambda kv: -kv[1]["device_ms"]):
            log(f"  {half} layer {layer}: device {g['device_ms']:.3f} ms in "
                f"{g['launches']} launches, host {g['host_ms']:.2f} ms")
        if r["unmarked"]:
            raise AssertionError(f"trace: {r['unmarked']} records of the "
                                 f"{half} replay before any stage mark")
    return res


def config_phase(dev, card, boat, pins, errors):
    """Phase 26, second half: every configuration of ``config_sweep``
    through ``compress`` (the ``auto`` coder) / ``decompress`` or
    ``compress_yuv`` / ``decompress_yuv`` on the card must equal its pin
    from the JAX package (tests/data/golden_configs.sha256), and its
    lossless decode the input (filter C's excepted: its prediction from
    the stored high[1] makes the reference's lossless decode differ from
    the input, and the pin holds the reference's); every case of
    ``error_sweep`` must be refused with the pinned IcerStatus; a batch of
    3 noisy boat variants at filter B equals the single calls; the CLI's
    ``compress -f D -s 3 -g 7`` / ``decompress`` equals the API; then a
    fixed-seed fuzz against the native host codec with no mismatch."""
    from icer_compression_tpu_torch import cli
    from icer_compression_tpu_torch.core.status import IcerError
    from icer_compression_tpu_torch.models import color as TC
    from icer_compression_tpu_torch.models import decode as D
    from icer_compression_tpu_torch.models import grayscale as T
    from icer_compression_tpu_torch.ops import entropy_full as EF
    from icer_compression_tpu_torch.ops import entropy_slim as ES
    from icer_compression_tpu_torch.ops import plane_decode as PDc
    from icer_compression_tpu_torch.ops import wavelet as WV
    from icer_compression_tpu_torch.utils import fuzz
    from icer_compression_tpu_torch.utils.image_io import read_png, write_png

    counted = {"K1": (ES.encode_lanes_slim, ES.encode_lanes_slim_two_word),
               "K4": (EF.encode_lanes_full,), "K2": (PDc.decode_planes,),
               "W1": (WV.inverse_pass,)}

    def reset():
        for fns in counted.values():
            for fn in fns:
                fn.launches = 0
        reset_runs()

    def counts():
        # the kernels' runs as the card counted them
        runs = encode_runs()
        return {"K1": runs["slim_encode"] + runs["slim_encode_two_word"],
                "K4": runs["full_encode"], "K2": runs["plane_decode"],
                "W1": runs["wavelet_inverse"]}

    res = {"launches": {}, "walls": {}}
    for label, img, dtype, cfg_t in config_sweep(boat):
        cfg = T.CodecConfig(*cfg_t)
        color = isinstance(img, tuple)
        reset()
        if color:
            s, enc_s = sync_time(lambda: TC.compress_yuv(*img, cfg,
                                                         device=dev))
            out, dec_s = sync_time(lambda: TC.decompress_yuv(
                s, cfg, dtype, device=dev))
            digest = planes_sha(out)
            h, w = img[0].shape
        else:
            s, enc_s = sync_time(lambda: T.compress(img, cfg, device=dev))
            out, dec_s = sync_time(lambda: T.decompress(
                s, cfg, dtype, device=dev))
            digest = pixels_sha(out)
            h, w = img.shape
        got = (hashlib.sha256(s).hexdigest(), digest)
        if got != pins[label]:
            raise AssertionError(f"{label}: {got} != pins {pins[label]}")
        lossless = cfg.byte_quota is None
        if lossless and cfg.filt != 2 and digest != (
                planes_sha(img) if color else pixels_sha(img)):
            raise AssertionError(f"{label}: lossless decode differs from "
                                 "the input")
        n = counts()
        if not n["K2"] or not n["W1"] or not (n["K1"] or n["K4"]):
            raise AssertionError(f"{label}: a kernel of its path did not "
                                 f"launch: {n}")
        coders = T.make_encoder(w, h, cfg, dtype, dev).bucket_coders
        res["launches"][label] = n
        res["walls"][label] = (enc_s, dec_s)
        log(f"config {label}: {len(s)} B, stream and decode equal the pins"
            f"{', decode returns the input' if lossless and cfg.filt != 2 else ''}"
            f"; encode {1e3 * enc_s:.1f} ms, decode {1e3 * dec_s:.1f} ms; "
            f"coders {coders}; launches {n} | {card}")
    for label, img, cfg_t in error_sweep(boat):
        try:
            if isinstance(img, tuple):
                TC.compress_yuv(*img, T.CodecConfig(*cfg_t), device=dev)
            else:
                T.compress(img, T.CodecConfig(*cfg_t), device=dev)
        except IcerError as e:
            if e.status.name != errors[label]:
                raise AssertionError(f"{label}: {e.status.name} != "
                                     f"{errors[label]}") from e
        else:
            raise AssertionError(f"{label}: encoded, the JAX package "
                                 f"raises {errors[label]}")
    log(f"refusals: {len(errors)} error cases raise the JAX package's "
        f"IcerStatus ({', '.join(sorted(set(errors.values())))})")

    rng = np.random.default_rng(1234)
    batch = np.clip(boat[None].astype(np.int32) + rng.integers(
        -6, 7, (3,) + boat.shape), 0, 255).astype(np.uint16)
    bcfg = T.CodecConfig(4, 1, 6, None)
    reset()
    streams = T.compress_batch(batch, bcfg, device=dev)
    decs = D.decompress_batch(streams, bcfg, np.uint16, device=dev)
    res["launches"]["batch of 3 fB"] = counts()
    for i, img in enumerate(batch):
        if streams[i] != T.compress(img, bcfg, device=dev):
            raise AssertionError(f"fB batch stream {i} differs from compress")
        if not np.array_equal(decs[i], img):
            raise AssertionError(f"fB batch decode {i} differs")
    with no_host_sync():
        collect = D.decompress_batch(streams, bcfg, np.uint16, device=dev,
                                     defer=True)
    if not all(np.array_equal(a, b) for a, b in zip(collect(), batch)):
        raise AssertionError("deferred fB batch decode differs")
    log(f"batch of 3 noisy boat variants, s4 fB g6: streams equal compress, "
        f"decodes the inputs (also deferred, no host sync in its dispatch "
        f"half); launches {res['launches']['batch of 3 fB']}")

    h, w = boat.shape
    args = ["-f", "D", "-s", "3", "-g", "7", "-G", "--device", dev.type]
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        write_png(tmp / "boat.png", boat.astype(np.uint8))
        for op, src, dst in (("compress", "boat.png", "b.icer"),
                             ("decompress", "b.icer", "b.png")):
            if cli.main([op, str(tmp / src), str(tmp / dst)] + args) != 0:
                raise AssertionError(f"cli {op} -f D -s 3 -g 7 failed")
        ccfg = T.CodecConfig(3, 3, 7, h * w)
        s = T.compress(boat, ccfg, device=dev)
        px = np.clip(T.decompress(s, ccfg, np.uint16, device=dev), 0,
                     255).astype(np.uint8)
        if (tmp / "b.icer").read_bytes() != s:
            raise AssertionError("cli -f D -s 3 -g 7 stream differs")
        if not np.array_equal(read_png(tmp / "b.png"), px):
            raise AssertionError("cli -f D -s 3 -g 7 decode differs")
    log("cli compress / decompress -f D -s 3 -g 7 -G on boat: stream and "
        "decode equal the API's")

    out = fuzz.run(fuzz.port_codec(dev), fuzz.native_codec(),
                   trials=FUZZ_TRIALS, seed=FUZZ_SEED, log=log)
    res["fuzz"] = out
    log(f"fuzz, seed {FUZZ_SEED}, against the native host codec: "
        f"{out['trials']} trials in {out['seconds']:.1f} s, per filter "
        f"{out['per_filter']}, per kind {out['per_kind']}, per type "
        f"{out['per_dtype']}, {out['two_word']} with the fused-key limit "
        f"lowered, {out['tiny_quota']} at quotas of 28-63 bytes, "
        f"{len(out['mismatches'])} mismatches | {card}")
    if out["mismatches"]:
        raise AssertionError(f"fuzz mismatches: {out['mismatches']}")
    return res


def guard_rerun(kernels, name):
    """Remove library ``name`` from build/ and load it again: the rebuild
    must run the first-use check, pass it and leave the library under its
    final name."""
    from icer_compression_tpu_torch import kernel_check
    path = kernels.lib_path(name)
    path.unlink()
    kernels._LIBS.pop(name, None)
    kernels.GUARD.pop(name, None)
    t0 = time.perf_counter()
    kernels.load(name)
    load_s = time.perf_counter() - t0
    g = kernels.GUARD.get(name)
    want = tuple(i.label for i in kernel_check.CHECKS[name])
    if not g or g["instances"] != want or not path.exists() \
            or kernels._LIBS.get(name) is None:
        raise AssertionError(f"first-use check of a rebuilt {name}: {g}")
    log(f"first-use check on a rebuild of {name}: ran and passed "
        f"({g['seconds']:.2f} s, instances {', '.join(g['instances'])}; "
        f"rebuild and check {load_s:.2f} s), library back under "
        f"{path.name}")
    return {name: g}


def fault_phase(dev, card, boat, stream, cfg, pins):
    """Phase 22: faulted streams through kernel 2.  The faults of
    ``fault_cases`` on boat's lossless golden stream, decoded one by one
    with ``decompress`` and all at once with one ``decompress_batch``, and
    ``corrupt_random`` on phase 16's colour stream through
    ``decompress_yuv``: each decode equals its pin in
    tests/data/golden_faults.sha256 (from the JAX package).  The same
    faults on boat's 64x64 centre crop: decoded equal to their pins, and
    kernel 2 on every unit of their joint plan held equal to its plain
    version (run on the host CPU)."""
    from icer_compression_tpu_torch.models import color as TC
    from icer_compression_tpu_torch.models import decode as D
    from icer_compression_tpu_torch.models import grayscale as T
    from icer_compression_tpu_torch.ops import plane_decode as PDc
    from icer_compression_tpu_torch.utils import faults

    def sha(b):
        return hashlib.sha256(b).hexdigest()

    def check(label, got, want):
        if got != want:
            raise AssertionError(f"faults: {label} differs from its pin")

    cases = fault_cases(stream, faults)
    for label, bad in cases:
        check(f"boat {label} stream", sha(bad), pins[f"boat {label} stream"])
    PDc.decode_planes.launches = 0
    reset_runs()
    walls = {}
    for label, bad in cases:
        px, walls[label] = sync_time(
            lambda bad=bad: T.decompress(bad, cfg, np.uint16, dev))
        check(f"boat {label} decoded", pixels_sha(px),
              pins[f"boat {label} decoded"])
    single = encode_runs()["plane_decode"]
    PDc.decode_planes.launches = 0
    reset_runs()
    decs, batch_s = sync_time(lambda: D.decompress_batch(
        [b for _l, b in cases], cfg, np.uint16, device=dev))
    batch = encode_runs()["plane_decode"]
    for (label, _b), px in zip(cases, decs):
        check(f"boat {label} batch decoded", pixels_sha(px),
              pins[f"boat {label} decoded"])
    units = D.plan_batch([b for _l, b in cases], cfg, np.uint16)[4]
    if batch != len(units):
        raise AssertionError(f"faults: the batch took {batch} kernel-2 "
                             f"launches for {len(units)} units")

    ccfg = T.CodecConfig(4, 0, 6, None)
    y, u, v = color_planes(color_boat(boat.astype(np.uint8)), np.uint16)
    cbad = faults.corrupt_random(TC.compress_yuv(y, u, v, ccfg, device=dev),
                                 COLOR_FAULT, seed=COLOR_FAULT)
    clabel = f"colour corrupt_random {COLOR_FAULT}"
    check(f"{clabel} stream", sha(cbad), pins[f"{clabel} stream"])
    PDc.decode_planes.launches = 0
    reset_runs()
    planes, color_s = sync_time(
        lambda: TC.decompress_yuv(cbad, ccfg, np.uint16, device=dev))
    color = encode_runs()["plane_decode"]
    check(f"{clabel} decoded planes", planes_sha(planes),
          pins[f"{clabel} decoded planes"])

    crop = np.ascontiguousarray(boat[FAULT_CROP])
    ccases = fault_cases(T.compress(crop, ccfg, device=dev), faults)
    for label, bad in ccases:
        check(f"crop64 {label} stream", sha(bad),
              pins[f"crop64 {label} stream"])
    PDc.decode_planes.launches = 0
    reset_runs()
    for (label, _b), px in zip(ccases, D.decompress_batch(
            [b for _l, b in ccases], ccfg, np.uint16, device=dev)):
        check(f"crop64 {label} decoded", pixels_sha(px),
              pins[f"crop64 {label} decoded"])
    crop_launches = encode_runs()["plane_decode"]
    _w, _h, _ll, blob, cunits = D.plan_batch([b for _l, b in ccases], ccfg,
                                             np.uint16)
    st = torch.as_tensor(blob)
    err, retired, over, plain_s = 0, 0, 0, 0.0
    for i, cu in enumerate(cunits):
        args = [torch.as_tensor(cu[k])
                for k in ("offs", "ebits", "lane_end", "geom")]
        ko = PDc.decode_planes(st.to(dev), *(a.to(dev) for a in args),
                               cu["hmax"], cu["wmax"], 8, 15)
        po, t = sync_time(lambda: PDc.decode_planes_plain(
            st, *args, cu["hmax"], cu["wmax"], 8, 15))
        plain_s += t
        for nm, a, b in zip(("out", "err", "pos"), ko, po):
            err = max(err, assert_equal(f"K2 faulted crop unit {i} {nm}",
                                        a.cpu(), b))
        retired += int(po[1].sum())
        over += int((po[2].numpy() > cu["ebits"]).sum())
    if not retired:
        raise AssertionError("faults: no crop lane retired")
    launches = single + batch + color + crop_launches
    if not (single and batch and color and crop_launches):
        raise AssertionError("faults: kernel 2 did not launch on every path")
    log(f"faults: {len(cases)} faulted boat streams decoded by decompress "
        f"equal to their pins ({single} K2 launches; walls "
        + ", ".join(f"{k} {1e3 * t:.1f}" for k, t in walls.items())
        + f" ms), as one decompress_batch equal to the pins ({batch} "
        f"launches, {len(units)} units, {1e3 * batch_s:.1f} ms); colour "
        f"corrupt_random {COLOR_FAULT} through decompress_yuv equal to its "
        f"pin ({color} launches, {1e3 * color_s:.1f} ms); {len(ccases)} "
        f"faulted 64x64 crop streams equal to their pins, K2 on their "
        f"{len(cunits)} joint units bit-equal to plain on the host CPU "
        f"(tolerance 0; {retired} lanes retired, {over} plane reads past "
        f"their data length; plain {plain_s:.1f} s) | {card}")
    return {"launches": {"plane_decode": launches}, "err": err,
            "plain_ms": 1e3 * plain_s, "units": len(cunits),
            "cases": len(ccases),
            "retired": retired, "over": over}


def host_codec_phase(dev, card, boat, cfg, golden, pins, color_pins,
                     walls):
    """Phase 23: the host codec.  Boat 512 lossless through ``compress``
    with ``backend="native"`` and ``"numpy"`` hashes to the golden stream,
    quota 50,000 through ``"native"`` to its pins, and the native decode
    returns the input; the sequential ``"python"`` decode runs on boat's
    64x64 centre crop (the per-pixel decoder is slow); phase 16's colour
    image through ``compress_yuv(backend="native")`` matches its stream
    pins and decodes through ``"native"`` to Y, U and V.  Each host wall
    is logged beside the card path's on the same image (``walls``: the
    card's boat encode and decode and colour encode and decode, seconds).
    No kernel runs here."""
    from icer_compression_tpu_torch.models import color as TC
    from icer_compression_tpu_torch.models import grayscale as T

    def sha(b):
        return hashlib.sha256(b).hexdigest()

    host = {}
    for backend in ("native", "numpy"):
        s, host[f"boat encode {backend}"] = sync_time(
            lambda b=backend: T.compress(boat, cfg, backend=b))
        if sha(s) != golden:
            raise AssertionError(f"host codec: boat lossless through "
                                 f"{backend} differs from the golden sha")
    d, host["boat decode native"] = sync_time(
        lambda: T.decompress(s, cfg, np.uint16, backend="native"))
    if not np.array_equal(d, boat):
        raise AssertionError("host codec: native decode differs from boat")
    cfg50 = T.CodecConfig(4, 0, 6, 50000)
    s50 = T.compress(boat, cfg50, backend="native")
    d50 = T.decompress(s50, cfg50, np.uint16, backend="native")
    if [sha(s50), pixels_sha(d50)] != pins:
        raise AssertionError("host codec: quota 50000 through native "
                             "differs from its pins")
    crop = np.ascontiguousarray(boat[FAULT_CROP])
    cs, card_crop_enc = sync_time(lambda: T.compress(crop, cfg, device=dev))
    cd, card_crop_dec = sync_time(
        lambda: T.decompress(cs, cfg, np.uint16, device=dev))
    pd, host["crop64 decode python"] = sync_time(
        lambda: T.decompress(cs, cfg, np.uint16, backend="python"))
    nd, host["crop64 decode native"] = sync_time(
        lambda: T.decompress(cs, cfg, np.uint16, backend="native"))
    if not (np.array_equal(pd, crop) and np.array_equal(nd, crop)
            and np.array_equal(cd, crop)):
        raise AssertionError("host codec: a 64x64 crop decode differs")
    rgb = color_boat(boat.astype(np.uint8))
    for i, (label, dtype, quota) in enumerate(COLOR_PINS):
        planes = color_planes(rgb, dtype)
        qcfg = T.CodecConfig(4, 0, 6, quota)
        cstream, t = sync_time(lambda: TC.compress_yuv(
            *planes, qcfg, backend="native"))
        if sha(cstream) != color_pins[2 * i]:
            raise AssertionError(f"host codec: colour {label} through "
                                 "native differs from its pin")
        if i == 0:
            host["colour encode native"] = t
            back, host["colour decode native"] = sync_time(
                lambda: TC.decompress_yuv(cstream, qcfg, dtype,
                                          backend="native"))
            if not all(np.array_equal(a, b) for a, b in zip(back, planes)):
                raise AssertionError("host codec: colour native decode "
                                     "differs from Y, U and V")
    card_walls = {"boat encode": walls["enc"], "boat decode": walls["dec"],
                  "crop64 encode": card_crop_enc,
                  "crop64 decode": card_crop_dec,
                  "colour encode": walls["color_enc"],
                  "colour decode": walls["color_dec"]}
    log("host codec: boat lossless through native and numpy == golden, "
        "quota 50000 native == its pins, native decode == boat; 64x64 crop "
        "through the python decode == crop; colour pins through native "
        "(u16 unlimited, u16 150000, u8) match, native colour decode == "
        "Y, U and V.  Host walls (s): "
        + ", ".join(f"{k} {v:.4f}" for k, v in host.items())
        + "; the card path on the same images (s): "
        + ", ".join(f"{k} {v:.4f}" for k, v in card_walls.items())
        + f" | {card}")
    return {"host_s": host, "card_s": card_walls}


# phase 24's worlds: (process-group backend, ranks, data axis); every rank
# runs on cuda:0, so a world of two takes gloo (NCCL refuses two ranks on
# one device)
SHARDED_WORLDS = (("nccl", 1, 1), ("gloo", 2, 1), ("gloo", 2, 2))
SHARDED_TIMEOUT_S = 300
# phase 24's sharded fuzz: each world of two runs this many trials of
# ``utils/fuzz.sample_sharded`` (meshes 1 x 2 and 2 x 1) from the seed
# plus its data axis, against the native host codec
SHARDED_FUZZ_TRIALS = 40
SHARDED_FUZZ_SEED = 24


def sharded_images(boat: np.ndarray, data: int) -> np.ndarray:
    """Phase 4's 8 noisy boat variants, then boat, then boat again until
    the batch is a multiple of the data axis."""
    h, w = boat.shape
    rng = np.random.default_rng(1234)
    imgs = list(np.clip(boat[None].astype(np.int32)
                        + rng.integers(-6, 7, (8, h, w)), 0, 255)
                .astype(np.uint16)) + [boat]
    while len(imgs) % data:
        imgs.append(boat)
    return np.stack(imgs)


def sharded_colour_planes(boat: np.ndarray) -> list:
    """Phase 17's colour batch as (ys, us, vs), each (4, h, w)."""
    rgb = color_boat(boat.astype(np.uint8))
    rng = np.random.default_rng(1234)
    variants = [np.clip(rgb.astype(np.int32)
                        + rng.integers(-6, 7, rgb.shape), 0, 255)
                .astype(np.uint8) for _ in range(4)]
    planes = [color_planes(c, np.uint16) for c in variants]
    return [np.stack(c) for c in zip(*planes)]


def sharded_rank(rank: int, world: int, data: int, backend: str, port: int,
                 out: str, device: str) -> int:
    """One rank of a phase-24 world (``chip_smoke.py --sharded-rank``):
    the sharded grayscale encoder, decoder and colour encoder on
    ``device``;
    writes its streams' sha256, the decode's equality, its kernel
    launches and walls to ``out/rank{rank}.json``.  Prints no result
    line."""
    from icer_compression_tpu_torch.models.grayscale import CodecConfig
    from icer_compression_tpu_torch.ops import entropy_slim as ES
    from icer_compression_tpu_torch.ops import plane_decode as PDc
    from icer_compression_tpu_torch.parallel import distributed, sharded
    from icer_compression_tpu_torch.utils.image_io import read_png

    # the ranks share the host's cores (as torchrun's one thread per
    # process when several run on a node)
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    if not distributed.initialize(f"tcp://127.0.0.1:{port}", world, rank,
                                  backend=backend, device=device):
        raise AssertionError("no process group")
    mesh = distributed.global_mesh(data=data, device=device)
    boat = read_png(REPO / "tests" / "data" / "boat.512.png") \
        .astype(np.uint16)
    h, w = boat.shape
    imgs = sharded_images(boat, data)
    ys, us, vs = sharded_colour_planes(boat)
    cfg = CodecConfig(4, 0, 6, None)
    ES.encode_lanes_slim.launches = 0
    ES.encode_lanes_slim_two_word.launches = 0
    PDc.decode_planes.launches = 0
    enc = sharded.ShardedGrayscaleEncoder(mesh, w, h, 4, 0, 6)
    reset_runs(device)
    dec = sharded.ShardedGrayscaleDecoder(mesh, w, h, cfg)
    cenc = sharded.ShardedColorEncoder(mesh, w, h, 4, 0, 6)
    walls = {}
    for turn in ("first", "second"):
        streams, walls[f"encode {turn}"] = sync_time(
            lambda: enc.compress_batch(imgs, cfg))
        decoded, walls[f"decode {turn}"] = sync_time(
            lambda: dec.decode_batch(streams))
        colour, walls[f"colour encode {turn}"] = sync_time(
            lambda: cenc.compress_batch(ys, us, vs, cfg))
    res = {"rank": rank, "mesh": mesh.shape, "batch": len(imgs),
           "shas": [hashlib.sha256(s).hexdigest() for s in streams],
           "colour_shas": [hashlib.sha256(s).hexdigest() for s in colour],
           "decoded_equal": all(np.array_equal(a, b)
                                for a, b in zip(decoded, imgs)),
           "slim_encode": sum(encode_runs(device)[k] for k in (
               "slim_encode", "slim_encode_two_word")),
           "plane_decode": encode_runs()["plane_decode"],
           "host_reencode_lanes": enc.enc.fallback_lanes, "walls_s": walls}
    with open(Path(out) / f"rank{rank}.json", "w") as f:
        json.dump(res, f)
    if world == 2:
        from icer_compression_tpu_torch.utils import fuzz
        t0 = time.perf_counter()
        got = fuzz.sharded_results(fuzz.sharded_trials(
            SHARDED_FUZZ_SEED + data, SHARDED_FUZZ_TRIALS), device)
        with open(Path(out) / f"fuzz{rank}.pkl", "wb") as f:
            pickle.dump({"results": got,
                         "seconds": time.perf_counter() - t0}, f)
    torch.distributed.destroy_process_group()
    return 0


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def sharded_phase(card, boat, golden, gray_streams, colour_streams,
                  device: str = "cuda:0"):
    """Phase 24: multi-GPU on the one card.  A world of 1 over NCCL and
    worlds of 2 processes over gloo sharing cuda:0, meshes 2 x 1 (the
    data axis) and 1 x 2 (the seg axis), each rank a process of this
    script.  Every rank's grayscale streams (phase 4's batch and boat)
    must equal ``compress_batch``'s (``gray_streams``) and boat's the
    golden stream, its decode the inputs, its colour streams phase 17's
    ``compress_yuv_batch`` (``colour_streams``); every rank must launch
    kernels 1 and 2.  Each world of two then runs ``SHARDED_FUZZ_TRIALS``
    sharded fuzz trials on both ranks while this process runs them
    through the native host codec: every rank's streams, decodes and
    refusals must equal the reference's and each other's.  A failure of
    any rank, or a fuzz mismatch, fails the phase."""
    from icer_compression_tpu_torch.utils import fuzz
    want_colour = [hashlib.sha256(s).hexdigest() for s in colour_streams]
    # the ranks share the card with this process: hand them its cache
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    res = {}
    for backend, n, data in SHARDED_WORLDS:
        port = _free_port()
        label = f"{backend} {data}x{n // data}"
        with tempfile.TemporaryDirectory() as out:
            t0 = time.perf_counter()
            procs = [subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()),
                 "--sharded-rank", str(r), str(n), str(data), backend,
                 str(port), out, device], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True) for r in range(n)]
            logs = []
            try:
                if n == 2:
                    # the reference's results, while the world runs
                    t_ref = time.perf_counter()
                    trials = fuzz.sharded_trials(SHARDED_FUZZ_SEED + data,
                                                 SHARDED_FUZZ_TRIALS)
                    refs = [fuzz.sharded_reference(t, fuzz.native_codec())
                            for t in trials]
                    ref_s = time.perf_counter() - t_ref
                for p in procs:
                    logs.append(p.communicate(timeout=max(
                        1.0, t0 + SHARDED_TIMEOUT_S - time.perf_counter()))[0])
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
            wall = time.perf_counter() - t0
            for r, (p, out_r) in enumerate(zip(procs, logs)):
                if p.returncode != 0:
                    raise AssertionError(f"sharded {label}: rank {r} failed "
                                         f"({p.returncode}):\n{out_r[-4000:]}")
            ranks = [json.loads((Path(out) / f"rank{r}.json").read_text())
                     for r in range(n)]
            if n == 2:
                fz = []
                for r in range(n):
                    with open(Path(out) / f"fuzz{r}.pkl", "rb") as f:
                        fz.append(pickle.load(f))
                chk = fuzz.check_sharded(trials, [f["results"] for f in fz],
                                         refs, log)
                chk.update(rank_s=[f["seconds"] for f in fz],
                           reference_s=ref_s)
                log(f"sharded {label} fuzz: {chk['trials']} trials from seed "
                    f"{SHARDED_FUZZ_SEED + data} (meshes {chk['per_mesh']}, "
                    f"filters {chk['per_filter']}, quota classes "
                    f"{chk['per_quota']}, colour {chk['color']}, fused-key "
                    f"limit lowered {chk['two_word']}, refused "
                    f"{chk['refused']}): {len(chk['mismatches'])} "
                    f"mismatches; ranks "
                    + ", ".join(f"{x:.1f}" for x in chk["rank_s"])
                    + f" s, native reference {ref_s:.1f} s | {card}")
                if chk["mismatches"]:
                    raise AssertionError(f"sharded {label} fuzz: "
                                         f"{chk['mismatches']}")
        want = [hashlib.sha256(s).hexdigest() for s in gray_streams] \
            + [golden] * (ranks[0]["batch"] - len(gray_streams))
        for r in ranks:
            if r["shas"] != want:
                raise AssertionError(f"sharded {label} rank {r['rank']}: "
                                     "streams differ from compress_batch's "
                                     "or the golden")
            if r["colour_shas"] != want_colour:
                raise AssertionError(f"sharded {label} rank {r['rank']}: "
                                     "colour streams differ from "
                                     "compress_yuv_batch's")
            if not r["decoded_equal"]:
                raise AssertionError(f"sharded {label} rank {r['rank']}: "
                                     "decode differs from the inputs")
            if r["slim_encode"] <= 0 or r["plane_decode"] <= 0:
                raise AssertionError(f"sharded {label} rank {r['rank']}: "
                                     "a kernel did not launch")
            log(f"sharded {label} rank {r['rank']} (mesh {r['mesh']}): "
                f"{r['batch']} grayscale streams == compress_batch, boat's "
                "== golden, decode == inputs, 4 colour streams == "
                f"compress_yuv_batch; K1 {r['slim_encode']} K2 "
                f"{r['plane_decode']} launches, {r['host_reencode_lanes']} "
                "host re-encode lanes; walls (s) "
                + ", ".join(f"{k} {v:.4f}" for k, v in r["walls_s"].items())
                + f" | {card}")
        log(f"sharded {label}: world of {n} in {wall:.1f} s")
        res[label] = {"ranks": ranks, "wall_s": wall}
        if n == 2:
            res[label]["fuzz"] = chk
    return res


# phase 29: the port's programs (bench, scaling harness, examples), each a
# process of its own; seconds each may take, process start included
PROGRAM_TIMEOUT_S = 600
BENCH_MODES = ("native", "cuda", "cuda_batched", "cuda_pipelined")


def run_programs(argvs, cwd) -> list:
    """Run ``python -m <argv>`` for each argv at once, from ``cwd``, with
    this checkout's package; returns [(stdout, seconds)] and raises when
    one exits non-zero."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-m", *a], cwd=cwd, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for a in argvs]
    out = []
    try:
        for a, p in zip(argvs, procs):
            so, se = p.communicate(timeout=max(
                1.0, t0 + PROGRAM_TIMEOUT_S - time.perf_counter()))
            if p.returncode != 0:
                raise AssertionError(f"{' '.join(a)} exited {p.returncode}:"
                                     f"\n{so[-3000:]}\n{se[-5000:]}")
            out.append((so, time.perf_counter() - t0))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def gb(nbytes) -> str:
    return f"{nbytes / 1e9:.2f} GB"


def programs_phase(card, boat, golden, example_pins) -> dict:
    """Phase 29: the port's counterparts of the repository's top-level
    programs.  ``python -m icer_compression_tpu_torch.bench`` at its
    defaults: every mode verified, boat's stream the golden one; each
    mode's figures, the batched and pipelined peaks against the card's
    memory and the device-time block layer by layer are logged.  The four
    examples in a temporary directory (gray on boat, colour on phase 16's
    RGB written as a PNG): streams and decoded PNGs equal
    ``example_pins``.  ``bench_scaling --devices 1,2``: both worlds'
    streams equal the single-card encoder's."""
    from icer_compression_tpu_torch.backend import graph_cache as GC
    from icer_compression_tpu_torch.utils.image_io import read_png, write_png
    torch.cuda.synchronize()
    held = GC.reserved_bytes("cuda")
    GC.CACHE.clear()
    torch.cuda.empty_cache()
    log(f"before phase 29: {len(GC.CACHE.captures)} captures so far, "
        f"{GC.CACHE.replays} replays; the graph pool's {gb(held)} released "
        f"(now {gb(GC.reserved_bytes('cuda'))}) | {card}")
    total = torch.cuda.get_device_properties(0).total_memory
    res = {}
    (out, secs), = run_programs([["icer_compression_tpu_torch.bench"]], REPO)
    bench = json.loads(out.strip().splitlines()[-1])
    d = bench["detail"]
    if d["device"]["name"] != torch.cuda.get_device_name(0):
        raise AssertionError(f"the bench ran on {d['device']}")
    bad = [m for m in BENCH_MODES if not d[m]["verified"]]
    if bad or not d["all_verified"]:
        raise AssertionError(f"bench modes not verified: {bad}")
    if not (d["native"]["stream_matches_reference"]
            and d["cuda"]["stream_matches_reference"]):
        raise AssertionError("the bench's boat stream is not the golden one")
    log(f"bench ({secs:.1f} s): {bench['value']:.4f} MP/s "
        f"({bench['vs_baseline']:.2f}x the C reference), {bench['metric']} "
        f"| {d['device']['nvidia_smi']}")
    nat, one = d["native"], d["cuda"]
    log(f"  bench native: encode {1e3 * nat['encode_s']:.2f} ms, decode "
        f"{1e3 * nat['decode_s']:.2f} ms, {nat['MPs']:.4f} MP/s; "
        f"{d['stream_bytes']} B == golden | {card}")
    log(f"  bench cuda single image: encode {1e3 * one['encode_s']:.2f} ms, "
        f"decode {1e3 * one['decode_s']:.2f} ms, {one['MPs']:.4f} MP/s; "
        f"warm-up {one['warmup_s']:.2f} s; coder {one['entropy_backend']}, "
        f"K1 launches {one['k1_launches']} | {card}")
    b, p = d["cuda_batched"], d["cuda_pipelined"]
    log(f"  bench cuda batched: B_enc {b['B_enc']} in {b['encode_passes']} "
        f"passes of <= {b['pass_images']}, encode {b['encode_s']:.4f} s "
        f"({b['encode_MPs']:.3f} MP/s), B_dec {b['B']} decode "
        f"{b['decode_s']:.4f} s ({b['decode_MPs']:.3f} MP/s); "
        f"{b['MPs']:.4f} MP/s; peaks encode "
        f"{gb(b['encode_peak_allocated_bytes'])} (and graph pools holding "
        f"{gb(b['encode_graph_pool_bytes'])} after it), decode "
        f"{gb(b['decode_peak_allocated_bytes'])} (decode graph pools "
        f"{gb(b['decode_graph_pool_bytes'])}) of {gb(total)} | {card}")
    log(f"  bench cuda pipelined: K {p['batches_in_flight']}, encode "
        f"{1e3 * p['encode_s_per_img']:.3f} ms/img, decode "
        f"{1e3 * p['decode_s_per_img']:.3f} ms/img at B {p['B']} (variants "
        + ", ".join(f"{k} {v:.3f}" for k, v in
                    p["decode_variants_ms_per_img"].items())
        + f" ms/img); {p['MPs']:.4f} MP/s; peaks encode "
        f"{gb(p['encode_peak_allocated_bytes'])} (graph pools "
        f"{gb(p['encode_graph_pool_bytes'])}), decode "
        f"{gb(p['decode_peak_allocated_bytes'])} (decode graph pools "
        f"{gb(p['decode_graph_pool_bytes'])}) of {gb(total)} | {card}")
    log(f"  bench warm-up walls (s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in d["warmup_breakdown_s"].items()))
    dt = d["device_time"]
    for half in ("encode_graph", "decode_graph"):
        r = dt[half]
        log(f"  bench device time, {half} of {r['images']} (profiled): wall "
            f"{r['wall_ms']:.2f} ms, device busy {r['busy_ms']:.3f} ms "
            f"({r['per_image']['busy_ms']:.4f} ms/img), idle share "
            f"{r['idle_share']:.4f}, {r['launches']} launches "
            f"({r['per_image']['launches']:.1f}/img), "
            f"{r['host_gap_us']:.1f} us of host between launches | {card}")
        for layer, g in sorted(r["layers"].items(),
                               key=lambda kv: -kv[1]["host_ms"]):
            log(f"    {half} layer {layer}: device {g['device_ms']:.3f} ms "
                f"({g['device_ms_per_image']:.4f}/img) in {g['launches']} "
                f"launches, host {g['host_ms']:.2f} ms "
                f"({g['host_ms_per_image']:.3f}/img)")
    log(f"  bench ceiling {dt['combined_MPs_ceiling']:.3f} MP/s (pixels / "
        f"device busy time per image of the replayed passes)")
    res["bench"] = bench
    res["bench_s"] = secs

    with tempfile.TemporaryDirectory() as tmp:
        t = Path(tmp)
        write_png(t / "rgb.png", color_boat(boat.astype(np.uint8)))
        mod = "icer_compression_tpu_torch.examples."
        walls = run_programs(
            [[mod + "compress_gray", str(REPO / "tests" / "data"
                                         / "boat.512.png"), "g.bin"],
             [mod + "compress_color", "rgb.png", "c.bin"]], t)
        walls += run_programs([[mod + "decompress_gray", "g.bin", "g.png"],
                               [mod + "decompress_color", "c.bin", "c.png"]],
                              t)
        got = {"gray s4 fA g6 q30000": (
                   hashlib.sha256((t / "g.bin").read_bytes()).hexdigest(),
                   pixels_sha(read_png(t / "g.png"))),
               "colour s4 fA g10 q100000": (
                   hashlib.sha256((t / "c.bin").read_bytes()).hexdigest(),
                   pixels_sha(read_png(t / "c.png")))}
    for label, (s, px) in got.items():
        want = example_pins[label]
        if (s, px) != (want[0], want[2]):
            raise AssertionError(f"example {label}: stream or decoded PNG "
                                 "differs from its pin")
    log("examples (compress_gray, compress_color, then decompress_gray, "
        "decompress_color, two at a time): streams and decoded PNGs == "
        "golden_examples.sha256; process walls (s) "
        + ", ".join(f"{w:.1f}" for _o, w in walls) + f" | {card}")
    res["examples_s"] = [w for _o, w in walls]

    (out, secs), = run_programs(
        [["icer_compression_tpu_torch.bench_scaling", "--devices", "1,2",
          "--device", "cuda"]], REPO)
    worlds = [json.loads(ln) for ln in out.strip().splitlines()]
    if [w["devices"] for w in worlds] != [1, 2] \
            or not all(w["streams_equal"] for w in worlds) \
            or worlds[1]["scaling_efficiency"] is not None:
        raise AssertionError(f"bench_scaling: {worlds}")
    for w in worlds:
        log(f"bench_scaling world of {w['devices']} ({w['backend']}, mesh "
            f"{w['mesh']}, {w['cards']} card, {w['ranks_per_card']} ranks a "
            f"card): batch {w['batch']}, {w['MPs']:.3f} MP/s, efficiency "
            f"{w['scaling_efficiency']}; streams == compress_batch | {card}")
    log(f"bench_scaling: {secs:.1f} s")
    res["scaling"] = worlds
    res["scaling_s"] = secs
    return res


class EagerPasses:
    """A stand-in for ``graph_cache.CACHE`` that runs every pass eagerly:
    phase 30's reference for the entry points that take no encoder
    (``compress``, ``compress_yuv``, the CLI)."""

    lock = contextlib.nullcontext()

    def run(self, key, fn, x):
        return tuple(fn(x)), "eager"


def eager_passes():
    from icer_compression_tpu_torch.backend import graph_cache as GC
    return swapped(GC, "CACHE", EagerPasses())


# phase 30: the 5120x3840 frame's stage-1 bucket codes in two calls a pass
GRAPH_FRAME = (3840, 5120)
# phase 30: the encode kernels, by the name of their device function
ENCODE_KERNELS = {"slim_encode": "slim_encode_kernel",
                  "slim_encode_two_word": "slim_encode_wide_kernel",
                  "full_encode": "full_encode_kernel"}
# and the decode's (a replay adds the copies into its static inputs)
DECODE_KERNELS = {"plane_decode": "plane_decode_kernel",
                  "wavelet_inverse": "inverse_"}


def pass_memory(enc, imgs) -> dict:
    """One pass of ``imgs`` through ``enc``'s device pass: its eager
    allocated and reserved peaks above the baseline, and the pool of its
    capture without expandable segments and with them (the graphs are
    dropped after)."""
    from icer_compression_tpu_torch.backend import graph_cache as GC
    x = enc._upload(imgs)
    res = {}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base_a, base_r = torch.cuda.memory_allocated(), \
        torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    outs = enc.device_pass(x)
    torch.cuda.synchronize()
    res["allocated"] = torch.cuda.max_memory_allocated() - base_a
    res["reserved"] = torch.cuda.max_memory_reserved() - base_r
    del outs
    for label, setting in (("fixed", contextlib.nullcontext),
                           ("expandable", GC.expandable_segments)):
        torch.cuda.empty_cache()
        g = torch.cuda.CUDAGraph()
        with setting(), torch.cuda.graph(g):
            outs = enc.device_pass(x)
        res[label] = GC.pool_bytes(g, torch.device("cuda", 0))
        del g, outs
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    return res


def same_output(a, b) -> bool:
    """Whether two decodes' outputs (arrays, or lists and tuples of them)
    are equal, dtype and value."""
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and a.dtype == b.dtype \
            and np.array_equal(a, b)
    if isinstance(a, (list, tuple)):
        return isinstance(b, (list, tuple)) and len(a) == len(b) \
            and all(same_output(x, y) for x, y in zip(a, b))
    return a == b


def top_pixel(out) -> int:
    """The largest pixel of a decode's output (an array, or lists and
    tuples of them)."""
    if isinstance(out, np.ndarray):
        return int(out.max())
    return max(top_pixel(x) for x in out)


# phase 30's soak of two decode threads on one card
SOAK_TRIALS = 200
SOAK_SEED = 16


def decode_soak(dev, card, cfg, streams) -> dict:
    """``SOAK_TRIALS`` round-robin decodes through
    ``decode_batch_sharded`` given ``[dev, dev]`` (two threads on one card,
    sharing the captured graphs), each of 1-12 streams drawn from
    ``streams`` (seeded), against the same streams decoded one by one on
    this thread.  Any mismatch fails the phase, with ``fuzz._which``'s
    message."""
    from icer_compression_tpu_torch.models import grayscale as T
    from icer_compression_tpu_torch.parallel import sharded as SH
    from icer_compression_tpu_torch.utils import fuzz
    want = [T.decompress(s, cfg, np.uint16, device=dev) for s in streams]
    rng = np.random.default_rng(SOAK_SEED)
    t0 = time.perf_counter()
    mismatches = []
    for trial in range(SOAK_TRIALS):
        pick = rng.integers(0, len(streams), int(rng.integers(1, 13)))
        got = SH.decode_batch_sharded([streams[i] for i in pick], cfg,
                                      np.uint16, [dev, dev])
        ref = [want[i] for i in pick]
        if not same_output(got, ref):
            mismatches.append((trial, fuzz._which(("ok", got), ("ok", ref))))
    secs = time.perf_counter() - t0
    res = {"trials": SOAK_TRIALS, "mismatches": mismatches, "seconds": secs,
           "streams": len(streams)}
    log(f"phase 30 soak: {SOAK_TRIALS} decode_batch_sharded calls on [{dev}, "
        f"{dev}] (two threads, one card, graphs on) of 1-12 of "
        f"{len(streams)} streams, each against the streams decoded on one "
        f"thread: {len(mismatches)} mismatches {mismatches[:3]}, "
        f"{secs:.1f} s | {card}")
    if mismatches:
        raise AssertionError(f"phase 30 soak: {len(mismatches)} mismatches, "
                             f"first {mismatches[0]}")
    return res


def graph_phase(dev, card, boat, golden, pins, cli_graph) -> dict:
    """Phase 30: each encode pass a captured CUDA graph (the default on
    the card) against the same pass run eagerly, byte for byte: boat
    single image; the bench's 112 noisy variants in four passes of 28
    (passes of at most 37, all of one size), each dispatch half under
    ``no_host_sync``; phase 4's batch of
    8; phase 16's colour image; 1024x1024 (K1 two-word); 5120x3840 (two
    coder calls a pass); quota 50,000; boat and a noisy variant through
    ``pallas`` and ``sorted``, deferred with two batches in flight (the
    first collector's host lanes re-encode from words the second replay
    would overwrite).  Each case runs three times on the graph path (a
    key's eager pass, the eager pass its collector captures and checks,
    a replay) and once eagerly: every stream equal, and the third run's
    K1 / K4 runs as the kernels count them on the card equal the eager
    run's.  Each decode pass a captured CUDA graph per plan key against
    the eager decode (``graph=False``), byte for byte, three graph runs
    and one eager as above, the third run replaying every pass and its K2
    / W1 runs counted on the card equal to the eager run's, the graph
    pools and the keys' tables within their bound after each: boat's
    golden stream; the bench's 56 streams; boat's quota-50000 stream,
    whose pinned decode has a pixel of 259 (at least one case must have a
    pixel above 255); the 11 fault pins one by one and as one batch (each
    equal to its pin); phase 16's colour stream; the 5120x3840 frame.  Then the soak (``decode_soak``): two decode threads
    on the card through one cache.  Then: each capture's seconds and
    check, the bytes the graphs' pools and the keys' tables hold on the
    device against their bound
    (one pass budget beyond their static tensors) after the bench's
    batch, after phase 21's CLI defaults (``cli_graph``) and at the end,
    the 37-image pass's pool with and without expandable segments beside
    its eager peaks, boat's encode and decode walls graph against eager in
    turns (medians of 5), and the device work, kernels by name and API
    launches of one boat encode and one boat decode each way.  Last, a
    warm boat decode after a replayed encode, after an eager one and
    after the graphs are dropped (``scripts/decode_after_encode.py``)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from icer_compression_tpu_torch.backend import graph_cache as GC
    from icer_compression_tpu_torch.models import color as TC
    from icer_compression_tpu_torch.models import decode as D
    from icer_compression_tpu_torch.models import grayscale as T

    cache = GC.CACHE
    h, w = boat.shape
    cfg = T.CodecConfig(4, 0, 6, None)

    def counted(fn):
        """(fn(), encode kernel runs counted on the card, seconds, peak
        bytes, replays)."""
        reset_runs()
        r0 = cache.replays
        out, secs, pk = peak(fn)
        runs = {k: n for k, n in encode_runs().items() if n}
        return out, runs, secs, pk, cache.replays - r0

    res = {"cases": {}}
    eager_peaks = []

    def case(label, fn, check=None):
        runs = [counted(fn) for _ in range(3)]
        with eager_passes():
            want, eager_n, eager_s, eager_pk, _r = counted(fn)
        eager_peaks.append(eager_pk)
        for i, r in enumerate(runs):
            if r[0] != want:
                raise AssertionError(f"phase 30 {label}: graph run {i + 1} "
                                     "differs from the eager passes")
        if runs[2][4] <= 0 or runs[2][1] != eager_n or not eager_n:
            raise AssertionError(f"phase 30 {label}: the third run replayed "
                                 f"{runs[2][4]} passes whose kernels ran "
                                 f"{runs[2][1]} times on the card, the "
                                 f"eager passes' {eager_n}")
        if check is not None:
            check(want)
        res["cases"][label] = {
            "runs": eager_n, "replays": runs[2][4],
            "walls_s": [r[2] for r in runs], "eager_s": eager_s,
            "eager_peak": eager_pk, "graph_peaks": [r[3] for r in runs]}
        log(f"phase 30 {label}: 3 graph runs equal the eager passes byte for "
            f"byte; the third replayed {runs[2][4]} pass(es), kernel runs "
            f"counted on the card {runs[2][1]} = eager's; walls (eager "
            f"pass, eager pass and capture, replay) "
            f"{[round(r[2], 4) for r in runs]} s, eager {eager_s:.4f} s; "
            f"peaks {[gb(r[3]) for r in runs]}, eager {gb(eager_pk)} | "
            f"{card}")
        return want

    def sha_is(want_sha, what):
        def check(stream):
            s = stream[0] if isinstance(stream, list) else stream
            if hashlib.sha256(s).hexdigest() != want_sha:
                raise AssertionError(f"phase 30 {what}: stream differs from "
                                     "its pin")
        return check

    def within_bound(what):
        """The graphs' pools and the keys' tables against their bound."""
        torch.cuda.synchronize()
        got = GC.reserved_bytes(dev) + cache.table_bytes(dev)
        bound = cache.bound(dev)
        if got > bound:
            raise AssertionError(f"phase 30 {what}: the graphs' pools and "
                                 f"tables hold {got} B, past their bound "
                                 f"{bound} B")
        return got, bound

    case("boat 512 lossless", lambda: T.compress(boat, cfg, device=dev),
         sha_is(golden, "boat"))

    # the bench's batch, through one encoder as the bench runs it, each
    # dispatch half (a key's first three passes among them) under
    # no_host_sync
    rng = np.random.default_rng(0)
    imgs = np.stack([np.clip(boat.astype(np.int32) + rng.integers(
        -6, 7, boat.shape), 0, 255).astype(np.uint16) for _ in range(112)])
    imgs[0] = boat
    benc = T.make_encoder(w, h, cfg, np.uint16, dev)
    if benc.pass_images != 37:
        raise AssertionError(f"112 images in passes of at most "
                             f"{benc.pass_images}, not 37")

    def bench_batch():
        with no_host_sync():
            collect = benc.encode_batch(imgs, defer=True)
        return T.allocate_streams(collect(), cfg, benc)

    bench_streams = case("bench 112 (4 passes of 28)", bench_batch,
                         sha_is(golden, "bench batch"))
    res["bench_reserved"], res["bench_bound"] = within_bound("bench 112")
    res["bench_static"] = cache.static_bytes(dev)
    log(f"phase 30 bench 112: every dispatch half under no_host_sync "
        f"(set_sync_debug_mode 'error'), the 28-image key's first four "
        f"passes among them: no host sync; graph pools reserve "
        f"{gb(res['bench_reserved'])} against their bound "
        f"{gb(res['bench_bound'])} (one pass budget beyond static tensors "
        f"of {gb(res['bench_static'])}); the batch's eager peak "
        f"{gb(eager_peaks[-1])} | {card}")
    mem = res["pass37"] = pass_memory(
        T.make_encoder(w, h, cfg, np.uint16, dev, graph=False), imgs[:37])
    log(f"phase 30 the pass of 37: eager peak allocated "
        f"{gb(mem['allocated'])}, reserved {gb(mem['reserved'])}; its "
        f"graph's pool with fixed segments {gb(mem['fixed'])}, with "
        f"expandable segments {gb(mem['expandable'])} | {card}")

    rng = np.random.default_rng(1234)
    batch8 = np.clip(boat[None].astype(np.int32) + rng.integers(
        -6, 7, (8, h, w)), 0, 255).astype(np.uint16)
    case("batch of 8 (phase 4)",
         lambda: T.compress_batch(batch8, cfg, device=dev))

    ccfg = T.CodecConfig(4, 0, 6, None)
    planes = color_planes(color_boat(boat.astype(np.uint8)), np.uint16)
    cpin = [ln.split()[0] for ln in (REPO / "tests" / "data"
                                     / "golden_color512.sha256")
            .read_text().splitlines()][0]
    cstream = case("colour 512 u16 unlimited (phase 16)",
                   lambda: TC.compress_yuv(*planes, ccfg, device=dev),
                   sha_is(cpin, "colour"))

    big = long_lane_images(boat)["gray1024"][0]
    case("1024x1024 lossless (K1 two-word)",
         lambda: T.compress(big, cfg, device=dev))
    frame = _tiled(boat, *GRAPH_FRAME)[0]
    fenc = T.make_encoder(GRAPH_FRAME[1], GRAPH_FRAME[0], cfg, np.uint16, dev)
    stage1 = fenc.buckets[0]
    if -(-stage1["rows"] // stage1["call_rows"]) < 2:
        raise AssertionError("5120x3840: stage 1 in one coder call")
    fstream = case("5120x3840 lossless (stage 1 in two coder calls)",
                   lambda: T.compress(frame, cfg, device=dev))
    del fenc
    cfg50 = T.CodecConfig(4, 0, 6, 50000)
    s50 = case("boat quota 50000", lambda: T.compress(boat, cfg50,
                                                      device=dev),
               sha_is(pins[0], "quota 50000"))

    # pallas and sorted, deferred with two batches in flight
    res["deferred"] = {}
    for coder in ("pallas", "sorted"):
        enc = T.make_encoder(w, h, cfg, np.uint16, dev, entropy=coder)
        ref = T.make_encoder(w, h, cfg, np.uint16, dev, entropy=coder,
                             graph=False)
        pair = [boat[None], batch8[1:2]]
        want = [T.allocate_streams(ref.encode_batch(b), cfg, ref)[0]
                for b in pair]
        for b, s in zip(pair, want):          # the eager pass, the capture
            if T.allocate_streams(enc.encode_batch(b), cfg, enc)[0] != s:
                raise AssertionError(f"phase 30 {coder}: graph differs")
        seen = watch_host_lanes(enc)
        lanes0 = enc.fallback_lanes
        first = enc.encode_batch(pair[0], defer=True)
        second = enc.encode_batch(pair[1], defer=True)
        got1 = T.allocate_streams(second(), cfg, enc)[0]
        got0 = T.allocate_streams(first(), cfg, enc)[0]
        if [got0, got1] != want or hashlib.sha256(got0).hexdigest() != golden:
            raise AssertionError(f"phase 30 {coder} deferred: streams differ")
        nlanes, _secs = check_host_lanes(f"phase 30 {coder}", seen)
        if nlanes != enc.fallback_lanes - lanes0:
            raise AssertionError(f"phase 30 {coder}: a host lane uncounted")
        res["deferred"][coder] = {"host_lanes": [len(s[1]) for s in seen]}
        log(f"phase 30 {coder}, boat and a variant deferred with two "
            f"batches in flight: streams equal the eager encoder's (boat's "
            f"the golden one); host lanes {[len(s[1]) for s in seen]}, each "
            f"native payload equal to the sequential coder's on the words it "
            f"re-encoded from its pass run again | {card}")
        del enc, ref, seen

    # the decode's passes: each case three times on the graph path (a
    # key's eager pass, the eager pass its collector captures and checks,
    # a replay) against the eager decode (graph=False), byte for byte
    stream = T.compress(boat, cfg, device=dev)
    if hashlib.sha256(stream).hexdigest() != golden:
        raise AssertionError("phase 30: boat's stream differs from its pin")
    res["decode_cases"] = {}

    def decode_case(label, fn, passes, check=None):
        """``fn(graph)`` decodes; ``passes``: the decode passes a run
        makes, each of which the third run replays."""
        runs = [counted(lambda: fn(None)) for _ in range(3)]
        want, eager_n, eager_s, eager_pk, _r = counted(lambda: fn(False))
        for i, r in enumerate(runs):
            if not same_output(r[0], want):
                raise AssertionError(f"phase 30 decode {label}: graph run "
                                     f"{i + 1} differs from the eager decode")
        if runs[2][4] != passes or runs[2][1] != eager_n \
                or not eager_n.get("plane_decode") \
                or not eager_n.get("wavelet_inverse"):
            raise AssertionError(
                f"phase 30 decode {label}: the third run replayed "
                f"{runs[2][4]} of {passes} passes, whose kernels ran "
                f"{runs[2][1]} times on the card, the eager decode's "
                f"{eager_n}")
        if check is not None:
            check(want)
        reserved, bound = within_bound(f"decode {label}")
        res["decode_cases"][label] = {
            "top_pixel": top_pixel(want),
            "runs": eager_n, "replays": runs[2][4],
            "walls_s": [r[2] for r in runs], "eager_s": eager_s,
            "eager_peak": eager_pk, "graph_peaks": [r[3] for r in runs],
            "decode_pools": cache.pool_total(dev, "decode"),
            "tables": cache.table_bytes(dev),
            "reserved": reserved, "bound": bound}
        log(f"phase 30 decode {label}: 3 graph runs equal the eager decode "
            f"byte for byte, largest pixel {top_pixel(want)}; the third "
            f"replayed {runs[2][4]} pass(es), "
            f"kernel runs counted on the card {runs[2][1]} = eager's; walls "
            f"{[round(r[2], 4) for r in runs]} s, eager {eager_s:.4f} s; "
            f"peaks {[gb(r[3]) for r in runs]}, eager {gb(eager_pk)}; "
            f"decode pools {gb(cache.pool_total(dev, 'decode'))}, keys' "
            f"tables {gb(cache.table_bytes(dev))}, all pools and tables "
            f"{gb(reserved)} within their bound {gb(bound)} | {card}")
        return want

    def lossless(images):
        def check(got):
            if not all(np.array_equal(a, b) for a, b in zip(got, images)):
                raise AssertionError("phase 30: a decode differs from its "
                                     "input")
        return check

    decode_case("boat 512 lossless (golden stream)",
                lambda g: [T.decompress(stream, cfg, np.uint16, device=dev,
                                        graph=g)], 1, lossless([boat]))
    decode_case("bench 56",
                lambda g: D.decompress_batch(
                    bench_streams[:56], cfg, np.uint16, device=dev,
                    graph=g), 1, lossless(imgs[:56]))

    def pinned(px):
        if pixels_sha(px[0]) != pins[1]:
            raise AssertionError("phase 30: boat's quota-50000 decode "
                                 "differs from its pin")

    # a pixel past a byte (259): the pass copies it back once, as uint16
    decode_case("boat quota 50000 (pinned)",
                lambda g: [T.decompress(s50, cfg50, np.uint16, device=dev,
                                        graph=g)], 1, pinned)
    from icer_compression_tpu_torch.utils import faults
    fpins = dict(ln.split(None, 1)[::-1] for ln in (
        REPO / "tests" / "data" / "golden_faults.sha256")
        .read_text().splitlines())
    fcases = fault_cases(stream, faults)

    def fault_pinned(got):
        for (label, _b), px in zip(fcases, got):
            if pixels_sha(px) != fpins[f"boat {label} decoded"]:
                raise AssertionError(f"phase 30 fault {label}: decode "
                                     "differs from its pin")

    decode_case(f"{len(fcases)} fault pins one by one",
                lambda g: [T.decompress(b, cfg, np.uint16, device=dev,
                                        graph=g) for _l, b in fcases],
                len(fcases), fault_pinned)
    decode_case(f"{len(fcases)} fault pins as one batch",
                lambda g: D.decompress_batch(
                    [b for _l, b in fcases], cfg, np.uint16, device=dev,
                    graph=g), 1, fault_pinned)
    decode_case("colour 512 u16 (phase 16)",
                lambda g: [TC.decompress_yuv(cstream, ccfg, np.uint16,
                                             device=dev, graph=g)], 1,
                lossless([planes]))
    decode_case("5120x3840 lossless",
                lambda g: [T.decompress(fstream, cfg, np.uint16, device=dev,
                                        graph=g)], 1, lossless([frame]))
    del frame, fstream
    wide = [k for k, c in res["decode_cases"].items() if c["top_pixel"] > 255]
    if not wide:
        raise AssertionError("phase 30: no decode case has a pixel above 255")
    res["decode_reserved"], res["decode_bound"] = within_bound("decodes")
    res["decode_pools"] = cache.pool_total(dev, "decode")
    res["soak"] = decode_soak(dev, card, cfg, [stream]
                              + list(bench_streams[:16])
                              + [b for _l, b in fcases])

    # boat's walls, graph against eager, in turns
    walls = {"graph": [], "eager": []}
    for i in range(5):
        for mode in ("graph", "eager")[::1 if i % 2 == 0 else -1]:
            with (eager_passes() if mode == "eager"
                  else contextlib.nullcontext()):
                _s, te = sync_time(lambda: T.compress(boat, cfg, device=dev))
            _d, td = sync_time(lambda: T.decompress(
                stream, cfg, np.uint16, device=dev, graph=mode == "graph"))
            walls[mode].append((te, td))
    med = {m: (statistics.median(e for e, _d in v),
               statistics.median(d for _e, d in v)) for m, v in walls.items()}
    res["walls"] = med
    log("phase 30 boat 512 lossless walls in turns (medians of 5): "
        + "; ".join(f"{m} encode {1e3 * e:.2f} ms, decode {1e3 * d:.2f} "
                    f"ms, {h * w / (e + d) / 1e6:.4f} MP/s"
                    for m, (e, d) in med.items()) + f" | {card}")

    # one boat encode and decode each way under the profiler: the encode
    # kernels' records by name inside the replay's window against the
    # eager one's, and each decode's API launches
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("encode graph"):
            T.compress(boat, cfg, device=dev)
        with eager_passes(), record_function("encode eager"):
            T.compress(boat, cfg, device=dev)
        with record_function("decode graph"):
            T.decompress(stream, cfg, np.uint16, device=dev)
        with record_function("decode eager"):
            T.decompress(stream, cfg, np.uint16, device=dev, graph=False)
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    res["trace"] = {}
    for mode in ("graph", "eager"):
        r = res["trace"][mode] = layer_breakdown(events, f"encode {mode}")
        r["encode_kernels"] = {
            k: sum(n for name, n in r["kernels"].items() if fn in name)
            for k, fn in ENCODE_KERNELS.items()}
        log(f"phase 30 boat encode {mode} (profiled): wall {r['wall_ms']:.2f} "
            f"ms, device busy {r['busy_ms']:.3f} ms, idle share "
            f"{r['idle_share']:.4f}, {r['launches']} device launches from "
            f"{r['api_launches']} API calls; encode kernels in the trace "
            f"{r['encode_kernels']} | {card}")
    tg, te = res["trace"]["graph"], res["trace"]["eager"]
    if tg["encode_kernels"] != te["encode_kernels"] \
            or not te["encode_kernels"]["slim_encode"] \
            or tg["api_launches"] >= te["api_launches"]:
        raise AssertionError("phase 30: the replayed boat encode's kernels "
                             f"{tg['encode_kernels']} ({tg['api_launches']} "
                             f"API launches) differ from the eager one's "
                             f"{te['encode_kernels']}")
    for mode in ("graph", "eager"):
        r = res["trace"][f"decode {mode}"] = layer_breakdown(
            events, f"decode {mode}")
        r["decode_kernels"] = {
            k: sum(n for name, n in r["kernels"].items() if fn in name)
            for k, fn in DECODE_KERNELS.items()}
        log(f"phase 30 boat decode {mode} (profiled): wall "
            f"{r['wall_ms']:.2f} ms, device busy {r['busy_ms']:.3f} ms, "
            f"idle share {r['idle_share']:.4f}, {r['launches']} device "
            f"launches from {r['api_launches']} API calls; decode kernels "
            f"in the trace {r['decode_kernels']} | {card}")
    dg, de = res["trace"]["decode graph"], res["trace"]["decode eager"]
    if dg["api_launches"] >= de["api_launches"] \
            or dg["decode_kernels"] != de["decode_kernels"] \
            or not de["decode_kernels"]["plane_decode"]:
        raise AssertionError(f"phase 30: the replayed boat decode's kernels "
                             f"{dg['decode_kernels']} ({dg['api_launches']} "
                             f"API launches) differ from the eager one's "
                             f"{de['decode_kernels']}")

    res["captures"] = list(cache.captures)
    for c in cache.captures:
        k = c["key"]
        what = (f"decode {' '.join(map(str, k[1:9]))} units "
                f"{[u[:3] for u in k[9]]} blob {k[10]}"
                if k[0] == "decode" and isinstance(k[1], int) else
                f"decode {k[1:]}" if k[0] == "decode" else
                f"{k[0]}x{k[1]} B={k[6]} "
                f"{'/'.join(x[0] for x in k[7])} windows {k[8]}")
        log(f"phase 30 capture {what}: attempt "
            f"{c['attempt']}, first replay equal {c['equal']}, "
            f"{c['seconds']:.3f} s, pool {gb(c['pool_bytes'])}, static "
            f"{gb(c['static_bytes'])}")
    if not all(c["equal"] for c in cache.captures):
        raise AssertionError("phase 30: a first-replay check failed")
    res["reserved"], res["bound"] = within_bound("the end")
    res["live"] = cache.pool_total(dev)
    res["static"] = cache.static_bytes(dev)
    res["tables"] = cache.table_bytes(dev)
    res["eager_peak"] = max(eager_peaks)
    res["largest_pool"] = max(c["pool_bytes"] for c in cache.captures)
    log(f"phase 30 graph pools: {len(cache.keys())} graphs, pools and "
        f"keys' tables hold "
        f"{gb(res['reserved'])} against their bound {gb(res['bound'])}, "
        f"live graphs' pools {gb(res['live'])} (after the bench's batch "
        f"{gb(res['bench_reserved'])} against {gb(res['bench_bound'])}; "
        f"after phase 21's CLI defaults {gb(cli_graph['reserved'])} against "
        f"{gb(cli_graph['bound'])}, that run's peak "
        f"{gb(cli_graph['peak'])} against {gb(cli_graph['eager_peak'])} "
        f"eager), of which static tensors {gb(res['static'])}; largest "
        f"pool {gb(res['largest_pool'])}, largest eager peak "
        f"{gb(res['eager_peak'])}; evictions {cache.evictions}, replays "
        f"{cache.replays}; decode pools "
        f"{gb(cache.pool_total(dev, 'decode'))}; keys' tables "
        f"{gb(res['tables'])} ({cache.tables_made} made, "
        f"{cache.tables_dropped} dropped) | {card}")
    # step 0: a warm boat decode after a replayed encode, after an eager
    # one, after the graphs are dropped (last: it drops every graph)
    sys.path.insert(0, str(REPO / "scripts"))
    try:
        import decode_after_encode
    finally:
        sys.path.remove(str(REPO / "scripts"))
    res["positions"] = decode_after_encode.positions(dev, boat, reps=9,
                                                     graph=True)
    for name, r in res["positions"].items():
        log(f"phase 30 boat decode {name}: wall {r['wall_ms_median']:.2f} "
            f"ms (median of 9; profiled {r['profiled_wall_ms']:.2f}), busy "
            f"{r['busy_ms']:.3f} ms, idle share {r['idle_share']:.4f} "
            f"(profiled windows {r['profiled_windows']}, records complete "
            f"{r['records_complete']}), {r['api_launches']} API launches, "
            f"allocator calls "
            f"{r['allocator_calls']}, host ms by layer "
            + ", ".join(f"{k} {v:.2f}" for k, v in
                        r["host_ms_by_layer"].items())
            + f"; reserved {gb(r['reserved_bytes'])}, graph pools "
            f"{gb(r['graph_pool_bytes'])} before it | {card}")
    return res


# phase 31: sort and pack (csrc/slim_pack.cu) against its plain version,
# the sort-based tail, on the card at the main path's shapes: each coder
# call of these frames' buckets at the CLI's defaults
SORT_PACK_FRAMES = (("1024x1024", 2), ("1600x1200", 2), ("5120x3840", 1))


def sort_pack_blocks(dev, boat):
    """[(label, words (L, lanes) on the card, payload cap bits, slice)]:
    kernel 1's input of every coder call the main path makes for the
    first ``SORT_PACK_FRAMES`` buckets (stages) of phase 20's 1024x1024
    frame and phase 25's 1600x1200 and 5120x3840 frames, in their calls of
    ``call_rows`` lanes (two at 5120x3840's stage 1)."""
    from icer_compression_tpu_torch.models import grayscale as T
    from icer_compression_tpu_torch.ops import encode as E
    images = {"1024x1024": long_lane_images(boat)["gray1024"][:1],
              "1600x1200": _tiled(boat, 1200, 1600),
              "5120x3840": _tiled(boat, 3840, 5120)}
    for name, nb in SORT_PACK_FRAMES:
        img = images[name]
        enc = T.make_encoder(img.shape[2], img.shape[1],
                             T.CodecConfig(4, 0, 6, None), np.uint16, dev,
                             graph=False)
        x = torch.as_tensor(img.astype(np.int32), device=dev)
        em = [enc.emit(g, enc.transform(x)[0]) for g in enc.groups]
        for bi, b in enumerate(enc.buckets[:nb]):
            words = enc.bucket_words(b, em)
            _lk, lc, cap = E.bucket_sizes(b["L"])
            n = b["call_rows"]
            for i in range(0, len(words), n):
                call = f" call {i // n + 1}" if len(words) > n else ""
                yield (f"{name} stage {bi + 1}{call}",
                       words[i:i + n].t().contiguous(), cap, lc)
        del em, x


def sort_pack_bound(recs, misc, max_bits: int, slice_to: int):
    """(least ms, "bytes" or "operations", ms of the scratch round trip) of
    sort and pack: the bytes the function has to move, every record and
    state row and the allocation counts read once, the payload, total and
    flag written once (operations are not its bound: tens a record);
    beside it, at the same bandwidth, the kernels' own scratch traffic,
    each packed codeword's word written once and read twice."""
    nbytes = sum(t.numel() * t.element_size() for t in recs) \
        + 4 * misc.shape[1] + misc.shape[1] * (max_bits // 8 + 9)
    packed = int(torch.clamp(misc[1].to(torch.int64), max=slice_to).sum())
    return bound(nbytes, 0) + (bound(12 * packed, 0)[0],)


def sort_pack_entry(sp, main_launches: int, paths: dict) -> dict:
    """The kernels line's entry of sort and pack: phase 31's blocks (each
    equal to the plain tail, or the phase stops), its 1024x1024 stage-1
    block as the entry's shape, phase 3's launches on boat and the
    launches by path of both record modes."""
    key = "1024x1024 stage 1 main path"
    b = sp["blocks"][key]
    return {"name": "slim_pack", "route": "cuda",
            "source": "icer_compression_tpu_torch/csrc/slim_pack.cu",
            "replaces": "icer_compression_tpu/ops/pallas_entropy.py:986",
            "mode": "fused-key records (slim_pack_launch) and two-word "
                    "records (slim_pack_two_word_launch, :1061)",
            "launches": main_launches, "max_abs_err": 0,
            "equal_to_plain": True,
            "shape": f"L={b['L']} lanes={b['lanes']} ({key}, {b['mode']})",
            "ms": b["ms"], "plain_ms": b["plain_ms"],
            "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
            "scratch_ms": b["scratch_ms"], "library_ms": None,
            "launches_by_path": paths["slim_pack"],
            "two_word_launches_by_path": paths["slim_pack_two_word"],
            "replay_runs": sp["replay_runs"], "blocks": sp["blocks"]}


def sort_pack_phase(dev, card, boat) -> dict:
    """Phase 31: on each block of ``sort_pack_blocks``, kernel 1 on the
    card, then sort and pack through ``csrc/slim_pack.cu`` and through the
    plain version on the card: payload and total byte for byte on every
    lane whose misc[0] is clear, the flag (misc[0] ORed in) on every lane;
    on the 1024x1024 stage-1 and stage-2 blocks also with the slice at the
    third quartile of the lanes' allocations and the payload cap at the
    median of their bits, so that lanes are cut by each.  Each block's
    kernel and plain times (CUDA events) beside the kernel's bound.  Then
    a 1024x1024 encode replayed from its graph: sort and pack ran once
    per kernel 1 run, in each record mode, as the kernels count their
    runs on the card."""
    from icer_compression_tpu_torch.backend import graph_cache as GC
    from icer_compression_tpu_torch.models import grayscale as T
    from icer_compression_tpu_torch.ops import entropy_slim as ES

    def same(label, got, want, misc):
        ok = misc[0] == 0
        assert_equal(f"{label} payload", got[0][ok], want[0][ok])
        assert_equal(f"{label} total", got[1][ok], want[1][ok])
        assert_equal(f"{label} flag", got[2] | ~ok, want[2] | ~ok)

    res = {"blocks": {}}
    for label, words, cap, lc in sort_pack_blocks(dev, boat):
        L, lanes = words.shape
        if ES.fused_key_ok(L):
            rec, fstate, misc, ev = ES.encode_lanes_slim(words)
            recs = (rec, fstate, ev)

            def kernel(mb, sl, recs=recs, misc=misc):
                return ES.pack_lanes_slim(*recs, misc, mb, sl)

            def plain(mb, sl, recs=recs):
                return ES.order_and_pack_lanes(
                    ES.slim_sort_operand_packed(*recs), mb, sl)
        else:
            rec1, rec2, fstate, misc, ev1, ev2, fopen = \
                ES.encode_lanes_slim_two_word(words, ES.eviction_rows(L))
            recs = (rec1, rec2, fstate, fopen, ev1, ev2)

            def kernel(mb, sl, recs=recs, misc=misc):
                return ES.pack_lanes_slim_two_word(*recs, misc, mb, sl)

            def plain(mb, sl, recs=recs):
                return ES.order_and_pack_lanes_two_word(
                    *ES.slim_sort_operands(*recs), mb, sl)
        del words
        cuts = [("main path", cap, lc)]
        got = kernel(cap, lc)
        same(label, got, plain(cap, lc), misc)
        if label.startswith("1024x1024"):
            sl = int(torch.quantile(misc[1].double(), 0.75))
            mb = int(got[1].double().median()) // 32 * 32
            cuts.append(("cut", max(mb, 32), max(sl, 1)))
        for tag, mb, sl in cuts:
            got, want = kernel(mb, sl), plain(mb, sl)
            same(f"{label} {tag}", got, want, misc)
            flags = got[2] | (misc[0] != 0)
            k_ms = event_ms(lambda: kernel(mb, sl), reps=5)
            p_ms = event_ms(lambda: plain(mb, sl), reps=2)
            bd = sort_pack_bound(recs, misc, mb, sl)
            key = f"{label} {tag}"
            res["blocks"][key] = {
                "L": L, "lanes": lanes, "mode": "fused-key"
                if ES.fused_key_ok(L) else "two-word", "max_bits": mb,
                "slice": sl, "flagged": int(flags.sum()),
                "misc0": int((misc[0] != 0).sum()),
                "evictions_max": int(misc[2].max()), "ms": k_ms,
                "plain_ms": p_ms, "bound_ms": bd[0], "bound_by": bd[1],
                "scratch_ms": bd[2]}
            log(f"phase 31 {key}: L={L} x {lanes} "
                f"{res['blocks'][key]['mode']}, cap {mb} bits, slice {sl}: "
                f"kernel equal to the plain tail on every lane ({int(flags.sum())} "
                f"flagged, evictions up to {int(misc[2].max())}); "
                f"{k_ms:.3f} ms, plain {p_ms:.3f} ms, bound {bd[0]:.4f} ms "
                f"({bd[1]}; the scratch round trip {bd[2]:.4f} ms more) | "
                f"{card}")
        del recs, misc, got
        torch.cuda.empty_cache()

    img = long_lane_images(boat)["gray1024"][:1]
    enc = T.make_encoder(img.shape[2], img.shape[1],
                         T.CodecConfig(4, 0, 6, None), np.uint16, dev)
    want = [enc.encode_batch(img) for _ in range(3)][0]
    r0 = GC.CACHE.replays
    reset_runs()
    if enc.encode_batch(img) != want:
        raise AssertionError("phase 31: the replayed 1024x1024 encode "
                             "differs from its eager pass")
    runs = encode_runs()
    if GC.CACHE.replays <= r0 or runs["slim_pack"] != runs["slim_encode"] \
            or runs["slim_pack_two_word"] != runs["slim_encode_two_word"] \
            or not runs["slim_pack"] or not runs["slim_pack_two_word"]:
        raise AssertionError(f"phase 31: a replayed 1024x1024 encode ran "
                             f"{runs} (replays {GC.CACHE.replays - r0})")
    res["replay_runs"] = {k: runs[k] for k in (
        "slim_encode", "slim_encode_two_word", "slim_pack",
        "slim_pack_two_word")}
    log(f"phase 31: a replayed 1024x1024 encode ran sort and pack once per "
        f"kernel 1 run: {res['replay_runs']}")
    return res


def main() -> int:
    if sys.argv[1:2] == ["--sharded-rank"]:
        a = sys.argv[2:]
        return sharded_rank(int(a[0]), int(a[1]), int(a[2]), a[3],
                            int(a[4]), a[5], a[6])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    with HostPlain() as host:
        return smoke(host)


def smoke(host) -> int:
    """Phases 1-31 on the card; ``host`` runs the plain versions that are
    checked on the host CPU."""
    from icer_compression_tpu_torch import kernels
    from icer_compression_tpu_torch.models import decode as D
    from icer_compression_tpu_torch.models import grayscale as T
    from icer_compression_tpu_torch.ops import entropy_full as EF
    from icer_compression_tpu_torch.ops import entropy_slim as ES
    from icer_compression_tpu_torch.ops import plane_decode as PDc
    from icer_compression_tpu_torch.ops import wavelet as WV
    from icer_compression_tpu_torch.utils.image_io import read_png

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    card = gpu_line()
    log(f"device: {torch.cuda.get_device_name(0)} | {card} | torch "
        f"{torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    per_src = kernels.build_all()
    build_s = time.perf_counter() - t0
    for name in kernels.KERNELS:
        kernels.load(name)
    log(f"build: {build_s:.2f} s wall, per source "
        f"{ {k: round(v, 2) for k, v in per_src.items()} }")
    for name in kernels.KERNELS:
        g = kernels.GUARD.get(name)
        log(f"first-use check {name}: " + (
            f"{g['seconds']:.2f} s, instances {', '.join(g['instances'])}, "
            f"rebuilt {g['rebuilt']}" if g else "cached build, not checked"))
    guard = guard_rerun(kernels, "full_encode")
    from icer_compression_tpu_torch.backend import native_backend
    t0 = time.perf_counter()
    native_backend.get_lib()
    log(f"native runtime: {native_backend.lib_path().name} "
        f"({time.perf_counter() - t0:.2f} s to build or load)")
    res = kernel_resources(kernels)
    for fn, r in sorted(res.items()):
        log(f"sass/ptxas {fn}: {r}")
    k45 = {fn: r for fn, r in res.items()
           if fn.startswith("full_encode_kernel")}
    if len(k45) != 2 or any(r.get("ldl_stl") or r.get("spill_st")
                            or r.get("spill_ld") for r in k45.values()):
        raise AssertionError(f"kernels 4/5 use local memory: {k45}")
    k1w_res = res.get("slim_encode_wide_kernel")
    if not k1w_res or k1w_res.get("ldl_stl") or k1w_res.get("spill_st") \
            or k1w_res.get("spill_ld"):
        raise AssertionError(f"kernel 1's two-word instance is missing or "
                             f"uses local memory: {k1w_res}")

    data = REPO / "tests" / "data"
    boat = read_png(data / "boat.512.png").astype(np.uint16)
    golden = (data / "golden_boat512.sha256").read_text().split()[0]
    pins = [ln.split()[0] for ln in
            (data / "golden_boat512_q50000.sha256").read_text().splitlines()]
    h, w = boat.shape
    cfg = T.CodecConfig(stages=4, filt=0, segments=6, byte_quota=h * w)
    cfg50 = T.CodecConfig(stages=4, filt=0, segments=6, byte_quota=50000)

    # the plain versions checked on the host CPU start now, beside the
    # card phases: kernel 1's two-word instance on phase 1's blocks whose
    # ordinals pass 2^15 and 2^17, on its noisy block with the TPU
    # kernel's 32 side-buffer rows (lanes past them flagged), on phase 20's
    # 1024x1024 stage-1 bucket and on phase 25's 1600x1200 stage-1 bucket
    # (the last three with the side buffer the encoder sizes), kernel 4 on
    # that bucket compacted
    from icer_compression_tpu_torch import kernel_check
    lw = long_ordinal_words(np.random.default_rng(3))
    hw = kernel_check.wide_words()
    hw_nev = ES.eviction_rows(hw.shape[0])
    nw = noisy_eviction_words(np.random.default_rng(7))
    host.submit("K1 two-word long", "k1w", (lw,), ES.NEV)
    host.submit("K1 two-word past 2^17", "k1w", (hw,), hw_nev)
    host.submit("K1 two-word noisy", "k1w", (nw,), ES.NEV)
    lw, hw, nw = lw.to(dev), hw.to(dev), nw.to(dev)
    long_bw = long_lane_block(dev, boat)
    host.submit("K1 two-word 1024x1024 stage-1", "k1w", (long_bw,),
                ES.eviction_rows(long_bw.shape[0]))
    # kept on the host until phase 25, off the device peaks of the phases
    # between
    big_k1, big_k4 = big_blocks(dev, boat)
    host.submit("K1 two-word 1600x1200 stage-1", "k1w", (big_k1,),
                ES.eviction_rows(big_k1.shape[0]))
    host.submit("K4 1600x1200 stage-1", "k4", big_k4)

    # ---- phase 1: kernel 1 vs its plain version ------------------------
    enc = T.make_encoder(w, h, cfg, np.uint16, dev)
    x = torch.as_tensor(boat.astype(np.int32)[None], device=dev)
    img, _ll, _ov = enc.transform(x)
    emitted = [enc.emit(g, img) for g in enc.groups]
    bucket_words = [enc.bucket_words(b, emitted).t().contiguous()
                    for b in enc.buckets]
    w1 = bucket_words[0]
    k1 = ES.encode_lanes_slim(w1)
    p1, plain_s = sync_time(lambda: ES.encode_lanes_slim_plain(w1))
    k1_err = 0
    for nm, a, b in zip(("rec", "fstate", "misc", "ev"), k1, p1):
        k1_err = max(k1_err, assert_equal(f"K1 boat {nm}", a, b))
    log(f"K1 boat stage-1 block {tuple(w1.shape)}: bit-equal to plain "
        f"(tolerance 0); "
        f"evictions max {int(k1[2][2].max())}, lanes evicting "
        f"{int((k1[2][2] > 0).sum())}, plain {plain_s:.1f} s")
    kn = ES.encode_lanes_slim(nw)
    pn = ES.encode_lanes_slim_plain(nw)
    for nm, a, b in zip(("rec", "fstate", "misc", "ev"), kn, pn):
        k1_err = max(k1_err, assert_equal(f"K1 noisy {nm}", a, b))
    if not (int(kn[2][2].max()) > ES.NEV and bool((kn[2][0] != 0).any())):
        raise AssertionError("noisy block did not overflow the side buffer")
    log(f"K1 noisy block {tuple(nw.shape)}: bit-equal to plain; evictions "
        f"max {int(kn[2][2].max())}, lanes flagged "
        f"{int((kn[2][0] != 0).sum())}")
    ew = eviction_words(np.random.default_rng(5)).to(dev)
    ke = ES.encode_lanes_slim(ew)
    for nm, a, b in zip(("rec", "fstate", "misc", "ev"), ke,
                        ES.encode_lanes_slim_plain(ew)):
        k1_err = max(k1_err, assert_equal(f"K1 eviction {nm}", a, b))
    if not bool((ke[2][2] > 0).any()):
        raise AssertionError("eviction block evicted in no lane")
    log(f"K1 eviction block {tuple(ew.shape)}: bit-equal to plain; lanes "
        f"evicting {int((ke[2][2] > 0).sum())}, evictions max "
        f"{int(ke[2][2].max())}")

    # kernel 1's two-word instance against its plain version: on the
    # eviction block, on a block whose ordinals pass 2^15, and on one
    # whose ordinals pass 2^16
    two_word_outs = TWO_WORD_OUTS
    k1w_err = 0
    pw, k1w_short_plain_s = sync_time(
        lambda: ES.encode_lanes_slim_plain(ew, two_word=True))
    for nm, a, b in zip(two_word_outs, ES.encode_lanes_slim_two_word(ew),
                        pw):
        k1w_err = max(k1w_err, assert_equal(f"K1 two-word eviction {nm}",
                                            a, b))
    if not bool((pw[3][2] > 0).any()):
        raise AssertionError("two-word eviction block evicted in no lane")
    log(f"K1 two-word instance, eviction block {tuple(ew.shape)}: "
        f"rec1/rec2/fstate/misc/ev1/ev2 bit-equal to plain (tolerance 0); "
        f"evictions max {int(pw[3][2].max())}, plain "
        f"{k1w_short_plain_s:.1f} s")
    # (their plain versions run on the host CPU, checked at the end)
    kl = ES.encode_lanes_slim_two_word(lw, ES.NEV)
    top = int(torch.where(kl[0] != 0, kl[1], 0).max())
    if not (top >= 1 << 15 and int(kl[3][1].min()) > 1 << 15
            and bool((kl[3][2][1:] > 0).all())):
        raise AssertionError(f"long block: ordinals reach {top}, "
                             f"allocations {kl[3][1].tolist()}, evictions "
                             f"{kl[3][2].tolist()}")
    k1w_long_ms = event_ms(lambda: ES.encode_lanes_slim_two_word(lw))
    k1w_long_b = k1_bound(lw, kl[3], ES.NEV)
    log(f"K1 two-word instance, block {tuple(lw.shape)} with allocation "
        f"ordinals up to {top} (allocations {kl[3][1].tolist()}, evictions "
        f"{kl[3][2].tolist()}): kernel {k1w_long_ms:.3f} ms (bound "
        f"{k1w_long_b[0]:.5f} ms, {k1w_long_b[1]}) | {card}")
    # the noisy block with the TPU kernel's 32 side-buffer rows: the lanes
    # past them flagged, as the fused-key instance flags them
    knw = ES.encode_lanes_slim_two_word(nw, ES.NEV)
    if not (torch.equal(knw[3][0] != 0, knw[3][2] > ES.NEV)
            and torch.equal(knw[3][0], kn[2][0])):
        raise AssertionError(f"two-word noisy block: flags "
                             f"{knw[3][0].tolist()}, evictions "
                             f"{knw[3][2].tolist()}")
    log(f"K1 two-word instance, noisy block {tuple(nw.shape)} with "
        f"{ES.NEV} side-buffer rows: evictions max {int(knw[3][2].max())}, "
        f"lanes flagged {int((knw[3][0] != 0).sum())} (the fused-key "
        f"instance's)")
    # ordinals past the 17-bit field of the TPU kernel's bin state and
    # evictions past its 32 rows, with the side buffer the encoder sizes
    kh = ES.encode_lanes_slim_two_word(hw, hw_nev)
    top_h = top_ordinal(kh)
    if not (top_h > 1 << 17 and int(kh[6].max()) > 1 << 17
            and bool((kh[3][2] > ES.NEV).all()) and not kh[3][0].any()):
        raise AssertionError(f"block past 2^17: ordinals reach {top_h}, "
                             f"evictions {kh[3][2].tolist()}, flagged "
                             f"{kh[3][0].tolist()}")
    k1w_wide_ms = event_ms(lambda: ES.encode_lanes_slim_two_word(hw, hw_nev))
    log(f"K1 two-word instance, block {tuple(hw.shape)} with allocation "
        f"ordinals up to {top_h} (allocations {kh[3][1].tolist()}, "
        f"evictions {kh[3][2].tolist()} in {hw_nev} side-buffer rows, "
        f"flagged {kh[3][0].tolist()}, open ordinals up to "
        f"{int(kh[6].max())}): kernel {k1w_wide_ms:.3f} ms | {card}")

    # ---- phase 2: kernel 2 vs its plain version ------------------------
    crop = np.ascontiguousarray(boat[200:296, 180:276])
    k2_err = 0
    for q in (None, 3000):
        ccfg = T.CodecConfig(4, 0, 6, q)
        s = T.compress(crop, ccfg, device=dev)
        _cw, _ch, _lls, blob, units = D.plan_batch([s], ccfg, np.uint16)
        st = torch.as_tensor(blob, device=dev)
        for u in units:
            args = [torch.as_tensor(u[k], device=dev)
                    for k in ("offs", "ebits", "lane_end", "geom")]
            ko = PDc.decode_planes(st, *args, u["hmax"], u["wmax"], 8, 15)
            po = PDc.decode_planes_plain(st, *args, u["hmax"], u["wmax"], 8,
                                         15)
            for nm, a, b in zip(("out", "err", "pos"), ko, po):
                k2_err = max(k2_err, assert_equal(f"K2 crop q{q} {nm}", a, b))
        dec = T.decompress(s, ccfg, dtype=np.uint16, device=dev)
        if q is None and not np.array_equal(dec, crop):
            raise AssertionError("crop lossless round trip differs")
        log(f"K2 crop 96x96 quota {q} ({len(s)} B, {len(units)} launches): "
            "out/err/pos bit-equal to plain")

    # ---- phase 3: main path --------------------------------------------
    ES.encode_lanes_slim.launches = 0
    ES.pack_lanes_slim.launches = 0
    PDc.decode_planes.launches = 0
    EF.encode_lanes_full.launches = 0
    WV.inverse_pass.launches = 0
    reset_runs()
    menc = T.make_encoder(w, h, cfg, np.uint16, dev)
    stream = T.compress_batch(boat[None], cfg, encoder=menc)[0]
    out = T.decompress(stream, cfg, dtype=np.uint16, device=dev)
    launches = {"slim_encode": ES.encode_lanes_slim.launches,
                "slim_pack": ES.pack_lanes_slim.launches,
                "plane_decode": PDc.decode_planes.launches,
                "wavelet_inverse": WV.inverse_pass.launches}
    if set(menc.bucket_coders) != {"slim"} or EF.encode_lanes_full.launches:
        raise AssertionError(f"boat's buckets left kernel 1: "
                             f"{menc.bucket_coders}")
    sha = hashlib.sha256(stream).hexdigest()
    if sha != golden:
        raise AssertionError(f"boat lossless sha {sha} != golden {golden}")
    if not np.array_equal(out, boat):
        raise AssertionError("boat lossless decode differs from the input")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel did not launch: {launches}")
    # the keys' first passes run eagerly: each launch ran once on the card
    if any(encode_runs()[k] != n for k, n in launches.items()):
        raise AssertionError(f"the kernels ran {encode_runs()} times on the "
                             f"card, their wrappers launched {launches}")
    log(f"main path boat 512 lossless: {len(stream)} B sha {sha[:16]}... == "
        f"golden, decode pixel-exact; launches {launches}; host re-encode "
        f"lanes {menc.fallback_lanes}")
    s50 = T.compress(boat, cfg50, device=dev)
    d50 = T.decompress(s50, cfg50, dtype=np.uint16, device=dev)
    sha50 = hashlib.sha256(s50).hexdigest()
    psha = hashlib.sha256(np.ascontiguousarray(d50, "<u2").tobytes()) \
        .hexdigest()
    if [sha50, psha] != pins:
        raise AssertionError(f"quota 50000: {sha50} / {psha} != pins {pins}")
    log(f"main path boat 512 quota 50000: {len(s50)} B stream and decoded "
        "pixels match the pins")

    # ---- phase 4: a batch of requests ----------------------------------
    rng = np.random.default_rng(1234)
    batch = np.clip(boat[None].astype(np.int32)
                    + rng.integers(-6, 7, (8, h, w)), 0, 255).astype(np.uint16)
    bcfg = T.CodecConfig(4, 0, 6, None)
    streams, enc_s = sync_time(
        lambda: T.compress_batch(batch, bcfg, device=dev))
    decs, dec_s = sync_time(
        lambda: D.decompress_batch(streams, bcfg, np.uint16, device=dev))
    for i in range(len(batch)):
        if not np.array_equal(decs[i], batch[i]):
            raise AssertionError(f"batch image {i} round trip differs")
    if streams[0] != T.compress(batch[0], bcfg, device=dev):
        raise AssertionError("batched stream differs from the single encode")
    log(f"batch of 8 noisy variants: all round trips pixel-exact; "
        f"{sum(map(len, streams))} B; encode {enc_s:.3f} s, decode "
        f"{dec_s:.3f} s ({8 * h * w / (enc_s + dec_s) / 1e6:.3f} MP/s)")

    # ---- phase 5: timings ----------------------------------------------
    enc_t, dec_t = [], []
    for _ in range(5):
        _s, t_e = sync_time(lambda: T.compress(boat, cfg, device=dev))
        _d, t_d = sync_time(
            lambda: T.decompress(stream, cfg, dtype=np.uint16, device=dev))
        enc_t.append(t_e)
        dec_t.append(t_d)
    enc_med, dec_med = statistics.median(enc_t), statistics.median(dec_t)
    log(f"boat 512 lossless wall (median of 5): encode {1e3 * enc_med:.1f} "
        f"ms, decode {1e3 * dec_med:.1f} ms, "
        f"{h * w / (enc_med + dec_med) / 1e6:.4f} MP/s | {card}")

    k1_ms = [event_ms(lambda bw=bw: ES.encode_lanes_slim(bw))
             for bw in bucket_words]
    k1_bounds = [k1_bound(bw, ES.encode_lanes_slim(bw)[2])
                 for bw in bucket_words]
    _cw, _ch, _ll2, blob, units = D.plan_batch([stream], cfg, np.uint16)
    st = torch.as_tensor(blob, device=dev)
    k2_ms, k2_bounds, k2_args = [], [], []
    for u in units:
        args = [torch.as_tensor(u[k], device=dev)
                for k in ("offs", "ebits", "lane_end", "geom")]
        k2_args.append(args)
        k2_ms.append(event_ms(lambda a=args, u=u: PDc.decode_planes(
            st, *a, u["hmax"], u["wmax"], 8, 15)))
        pos = PDc.decode_planes(st, *args, u["hmax"], u["wmax"], 8, 15)[2]
        k2_bounds.append(k2_bound(u, pos))
    small = min(range(len(units)),
                key=lambda i: units[i]["hmax"] * units[i]["wmax"])
    big = max(range(len(units)),
              key=lambda i: units[i]["hmax"] * units[i]["wmax"])
    # the rounds of a lane run as a wavefront, round k two rows behind
    # round k - 1: the chain is one round's pixels plus that lag per round
    ub = units[big]
    k2_steps = ub["hmax"] * ub["wmax"] + 2 * ub["wmax"] * (
        ub["offs"].shape[0] - 1)
    inputs = D.unit_inputs(units, dev)
    k2_all_ms = event_ms(lambda: D.decode_units(st, inputs, 8, 15))
    for i, (a, b) in enumerate(zip(D.decode_units(st, inputs, 8, 15),
                                   [PDc.decode_planes(st, *a, 8, 15)
                                    for a in inputs])):
        for nm, x, y in zip(("out", "err", "pos"), a, b):
            assert_equal(f"K2 unit {i} overlapped vs alone {nm}", x, y)
    if not k2_all_ms < sum(k2_ms):
        raise AssertionError(f"the decode's units did not overlap: "
                             f"{k2_all_ms:.3f} ms together, "
                             f"{sum(k2_ms):.3f} ms one by one")
    log(f"K2 all {len(units)} units on their own streams: {k2_all_ms:.3f} "
        f"ms, against {sum(k2_ms):.3f} ms one by one and {max(k2_ms):.3f} "
        f"ms for the longest (units overlap); stage-1 launch "
        f"{1e6 * k2_ms[big] / k2_steps:.1f} ns per dependent step "
        f"({k2_steps} steps) | {card}")
    us = units[small]
    po, k2_plain_s = sync_time(lambda: PDc.decode_planes_plain(
        st, *k2_args[small], us["hmax"], us["wmax"], 8, 15))
    ko = PDc.decode_planes(st, *k2_args[small], us["hmax"], us["wmax"], 8, 15)
    for nm, a, b in zip(("out", "err", "pos"), ko, po):
        k2_err = max(k2_err, assert_equal(f"K2 boat stage-4 {nm}", a, b))
    log(f"K2 boat 512 stage-4 launch: out/err/pos bit-equal to plain "
        f"(tolerance 0), plain {k2_plain_s:.1f} s")
    for i, u in enumerate(units):
        log(f"K2 launch {i}: {u['offs'].shape[1]} lanes, canvas "
            f"{u['hmax']}x{u['wmax']}, {u['offs'].shape[0]} rounds: "
            f"{k2_ms[i]:.3f} ms (bound {k2_bounds[i][0]:.4f} ms, "
            f"{k2_bounds[i][1]})")
    for i, bw in enumerate(bucket_words):
        log(f"K1 launch {i}: {tuple(bw.shape)}: {k1_ms[i]:.3f} ms "
            f"(bound {k1_bounds[i][0]:.4f} ms, {k1_bounds[i][1]}; "
            f"{1e6 * k1_ms[i] / bw.shape[0]:.1f} ns per step)")

    long_pins = dict(ln.split(None, 1)[::-1] for ln in
                     (data / "golden_long_lanes.sha256").read_text()
                     .splitlines())
    mark_captures("phases 1-3 and the kernels' checks")
    lat, new = later_phases(dev, card, boat, img, bucket_words, stream,
                            golden, pins, cfg, cfg50, long_pins)
    mark_captures("phases 4-12")
    crop_launches = lat["crop_launches"]
    dec = decode_phases(dev, card, boat, st, units, small)
    mark_captures("phases 13-15")
    col = color_phases(dev, card, boat, [
        ln.split()[0] for ln in
        (data / "golden_color512.sha256").read_text().splitlines()])
    mark_captures("phases 16-17")
    dfr = deferred_phase(dev, card, boat)
    mark_captures("phase 18")
    cl = cli_phase(dev, card, boat)
    mark_captures("phase 19")
    lng = long_lane_phases(dev, card, boat, long_pins, batch, host, long_bw)
    mark_captures("phase 20")
    del long_bw
    cld, cli_graph = cli_defaults_phase(dev, card, boat)
    mark_captures("phase 21")
    flt = fault_phase(dev, card, boat, stream, cfg, dict(
        ln.split(None, 1)[::-1] for ln in
        (data / "golden_faults.sha256").read_text().splitlines()))
    mark_captures("phase 22")
    hst = host_codec_phase(dev, card, boat, cfg, golden, pins, [
        ln.split()[0] for ln in
        (data / "golden_color512.sha256").read_text().splitlines()], {
        "enc": enc_med, "dec": dec_med, "color_enc": col["enc_ms"] / 1e3,
        "color_dec": col["dec_ms"] / 1e3})
    shd = sharded_phase(card, boat, golden, streams, col["batch_streams"])
    mark_captures("phases 23-24")
    big_pins = dict(ln.split(None, 1)[::-1] for ln in
                    (data / "golden_big_images.sha256").read_text()
                    .splitlines())
    large = big_image_phase(dev, card, boat, big_pins, host, big_k1, big_k4)
    mark_captures("phase 25")
    del big_k1, big_k4
    w1r = w1_phase(dev, card, boat)
    trc = trace_phase(dev, card, boat)
    cfr = config_phase(dev, card, boat,
                       *read_config_pins(data / "golden_configs.sha256"))
    cpl = coder_plan_phase(dev, card, boat)
    mark_captures("phases 26-27")
    srt = sorted_pass_phase(dev, card, boat, long_pins, big_pins)
    # phase 1's long blocks against their plain versions (host CPU)
    late_s = {}
    for name, kout, blk in (("K1 two-word long", kl, lw),
                            ("K1 two-word past 2^17", kh, hw),
                            ("K1 two-word noisy", knw, nw)):
        err, late_s[name] = host.check(name, kout, two_word_outs)
        k1w_err = max(k1w_err, err)
        log(f"{name} block {tuple(blk.shape)} (phase 1): "
            f"outputs bit-equal to plain on the host CPU (tolerance 0), "
            f"plain {late_s[name]:.1f} s")
    k1w_plain_s = late_s["K1 two-word long"]
    k1w_huge_plain_s = late_s["K1 two-word past 2^17"]
    # the host workers are done: phase 29's walls share the host with no one
    mark_captures("phase 28")
    t29 = time.perf_counter()
    prg = programs_phase(card, boat, golden, {
        ln.split(None, 3)[3]: ln.split()[:3] for ln in
        (data / "golden_examples.sha256").read_text().splitlines()})
    t29 = time.perf_counter() - t29
    mark_captures("phase 29")
    t30 = time.perf_counter()
    g30 = graph_phase(dev, card, boat, golden, pins, cli_graph)
    t30 = time.perf_counter() - t30
    mark_captures("phase 30")
    from icer_compression_tpu_torch.backend import graph_cache as GC
    GC.CACHE.clear()
    torch.cuda.empty_cache()
    t31 = time.perf_counter()
    sp31 = sort_pack_phase(dev, card, boat)
    t31 = time.perf_counter() - t31
    mark_captures("phase 31")
    for label, n, secs in capture_counts():
        log(f"graph captures in {label}: {n}, {secs:.3f} s (this process; "
            "phase 24's ranks and phase 29's programs capture in their own)")
    paths = {"slim_encode": {}, "slim_encode_two_word": {},
             "slim_pack": {}, "slim_pack_two_word": {},
             "plane_decode": {}, "full_encode": {}, "wavelet_inverse": {}}
    for path, counts in (
            [("grayscale", launches), ("color", col["launches"]),
             ("color_batch", col["batch_launches"]),
             ("deferred", dfr["launches"]), ("cli", cl["launches"]),
             ("crop256 s1 g1", {"slim_encode_two_word": crop_launches}),
             ("faults", flt["launches"])]
            + list(lng["launches"].items())
            + [(f"cli defaults {op}", r["launches"])
               for op, r in cld.items()]
            + [(f"sharded {label} rank {r['rank']} (per rank)",
                {"slim_encode": r["slim_encode"],
                 "plane_decode": r["plane_decode"]})
               for label, world in shd.items() for r in world["ranks"]]
            + [(f"large {label}", c)
               for label, c in large["launches"].items()]):
        for k, n in counts.items():
            paths[k][path] = n

    # kernel 4 left the default path in phase 25 (kernel 1 codes every
    # bucket): its entry keeps the pallas backend's numbers on boat
    # (phases 6, 7 and 12), and beside them the large frames through
    # entropy="pallas" and the 1600x1200 stage-1 block against its plain
    # version
    k4e, bk = new[0], large["k4"]
    paths["full_encode"]["pallas boat 512"] = k4e["launches"]
    bdt = prg["bench"]["detail"]
    paths["slim_encode"]["bench single image (its own process)"] = \
        bdt["cuda"]["k1_launches"]["fused-key"]
    k4e.update(
        max_abs_err=max(k4e["max_abs_err"], bk["err"]),
        launches_by_path=paths["full_encode"],
        default_path_launches=sum(paths["full_encode"][f"large {label}"]
                                  for label in large["launches"]),
        large_frames_pallas=large["pallas"],
        block_1600x1200={
            "shape": "L={} lanes={} (1600x1200 stage 1, compacted)".format(
                *bk["shape"]),
            "ms": bk["ms"], "plain_cpu_ms": bk["plain_ms"],
            "bound_ms": bk["bound"][0], "bound_by": bk["bound"][1],
            "ns_per_step": 1e6 * bk["ms"] / bk["shape"][0],
            "ns_per_valid_step": 1e6 * bk["ms"] / bk["chain"]})
    kw = large["k1w"]

    kern = [
        {"name": "slim_encode", "route": "cuda",
         "source": "icer_compression_tpu_torch/csrc/slim_encode.cu",
         "replaces": "icer_compression_tpu/ops/pallas_entropy.py:744",
         "launches": launches["slim_encode"], "max_abs_err": k1_err,
         "equal_to_plain": True,
         "shape": f"L={w1.shape[0]} lanes={w1.shape[1]} (boat stage-1)",
         "ms": k1_ms[0], "plain_ms": 1e3 * plain_s,
         "bound_ms": k1_bounds[0][0], "bound_by": k1_bounds[0][1],
         "library_ms": None, "ms_per_image": sum(k1_ms),
         "bound_ms_per_image": sum(b[0] for b in k1_bounds),
         "ns_per_step": 1e6 * k1_ms[0] / w1.shape[0],
         "step": "one emission slot of a stage-1 lane",
         "launches_by_path": paths["slim_encode"],
         "color_launches_per_image": col["k1_launches"],
         "color_ms_per_image": col["k1_ms"],
         "color_bound_ms_per_image": col["k1_bound_ms"],
         "color_plain_check": {"shape": f"L={col['k1_shape'][0]} lanes="
                                        f"{col['k1_shape'][1]} (uint8 colour "
                                        "shortest bucket)",
                               "max_abs_err": col["k1_err"],
                               "plain_ms": col["k1_plain_ms"]}},
        {"name": "plane_decode", "route": "cuda",
         "source": "icer_compression_tpu_torch/csrc/plane_decode.cu",
         "replaces": "icer_compression_tpu/ops/pallas_decode.py:99",
         "launches": launches["plane_decode"], "max_abs_err": k2_err,
         "equal_to_plain": True,
         "shape": f"lanes={us['offs'].shape[1]} canvas={us['hmax']}x"
                  f"{us['wmax']} rounds={us['offs'].shape[0]} "
                  "(boat stage-4)",
         "ms": k2_ms[small], "plain_ms": 1e3 * k2_plain_s,
         "bound_ms": k2_bounds[small][0], "bound_by": k2_bounds[small][1],
         "library_ms": None, "ms_per_image": sum(k2_ms),
         "bound_ms_per_image": sum(b[0] for b in k2_bounds),
         "units_overlapped_ms": k2_all_ms, "stage1_ms": k2_ms[big],
         "stage1_bound_ms": k2_bounds[big][0],
         "ns_per_step": 1e6 * k2_ms[big] / k2_steps,
         "step": "one pixel of a stage-1 lane's critical path: one "
                 "round's pixels plus two rows per later round",
         "retirement_max_abs_err": dec["retire_err"],
         "fault_plain_check": {
             "shape": f"{flt['units']} units of {flt['cases']} faulted "
                      "64x64 crop streams' joint plan",
             "max_abs_err": flt["err"], "plain_cpu_ms": flt["plain_ms"],
             "lanes_retired": flt["retired"],
             "reads_past_data_length": flt["over"]},
         "device_placement_max_abs_err": dec["place_err"],
         "launches_by_path": paths["plane_decode"],
         "color_launches_per_image": col["k2_launches"],
         "color_units_overlapped_ms": col["k2_ms"],
         "color_bound_ms_per_image": col["k2_bound_ms"],
         "color_plain_check": {"shape": "lanes={} canvas={}x{} rounds={} "
                                        "lsb0=6 mag_bits=7 (uint8 colour "
                                        "smallest unit)".format(
                                            *col["k2_shape"]),
                               "max_abs_err": col["k2_err"],
                               "plain_ms": col["k2_plain_ms"]}},
        {"name": "slim_encode_two_word", "route": "cuda",
         "source": "icer_compression_tpu_torch/csrc/slim_encode.cu",
         "replaces": "icer_compression_tpu/ops/pallas_entropy.py:744",
         "mode": "two-word records (fused_key=False, call :845)",
         "launches": lng["launches"]["gray1024 unlimited"][
             "slim_encode_two_word"],
         "max_abs_err": max(k1w_err, lng["k1w_err"], kw["err"]),
         "equal_to_plain": True,
         "shape": "L={} lanes={} (1024x1024 stage 1)".format(
             *lng["k1w_shape"]),
         "ms": lng["k1w_ms"], "plain_ms": lng["k1w_plain_ms"],
         "bound_ms": lng["k1w_bound"][0], "bound_by": lng["k1w_bound"][1],
         "library_ms": None, "top_ordinal": lng["k1w_top"],
         "ns_per_step": 1e6 * lng["k1w_ms"] / lng["k1w_shape"][0],
         "step": "one emission slot of a 1024x1024 stage-1 lane",
         "launches_by_path": paths["slim_encode_two_word"],
         "eviction_plain_check": {
             "shape": f"L={ew.shape[0]} lanes={ew.shape[1]}",
             "plain_ms": 1e3 * k1w_short_plain_s},
         "long_plain_check": {
             "shape": f"L={lw.shape[0]} lanes={lw.shape[1]} (ordinals past "
                      "2^15)",
             "ms": k1w_long_ms, "plain_cpu_ms": 1e3 * k1w_plain_s,
             "bound_ms": k1w_long_b[0], "top_ordinal": top},
         "wide_plain_check": {
             "shape": f"L={hw.shape[0]} lanes={hw.shape[1]} (ordinals past "
                      f"2^17, {hw_nev} side-buffer rows)",
             "ms": k1w_wide_ms, "plain_cpu_ms": 1e3 * k1w_huge_plain_s,
             "top_ordinal": top_h,
             "evictions": kh[3][2].tolist()},
         "bucket_1600x1200": {
             "shape": "L={} lanes={} (1600x1200 stage 1, {} side-buffer "
                      "rows)".format(*kw["shape"], kw["nev"]),
             "ms": kw["ms"], "plain_cpu_ms": kw["plain_ms"],
             "bound_ms": kw["bound"][0], "bound_by": kw["bound"][1],
             "top_ordinal": kw["top"], "evictions_max": kw["evictions"]},
         "large_frame_launches": {
             label: [{"shape": list(sh), "nev": nev, "ms": ms,
                      "bound_ms": bd[0]} for sh, nev, ms, bd in r["k1"]
                     if nev is not None]
             for label, r in large["images"].items() if r.get("k1")},
         "path": "compress of a 1024x1024 image at the CLI's defaults: the "
                 "stage-1 bucket"},
        sort_pack_entry(sp31, launches["slim_pack"], paths),
        w1_entry(w1r, cfr, launches["wavelet_inverse"]),
    ] + new
    bd, bb, bp = (bdt["device_time"], bdt["cuda_batched"],
                  bdt["cuda_pipelined"])
    log(f"build_seconds {build_s:.2f}; encode_ms {1e3 * enc_med:.2f}; "
        f"decode_ms {1e3 * dec_med:.2f}; color_encode_ms "
        f"{col['enc_ms']:.2f}; color_decode_ms {col['dec_ms']:.2f}; "
        f"deferred_mps_k4 {max(dfr['mps_k4']):.3f}; deferred_mps_k1 "
        f"{max(dfr['mps_k1']):.3f}; long-lane walls (encode, decode ms) "
        + "; ".join(f"{k} {e:.2f}, {d:.2f}"
                    for k, (e, d) in lng["walls"].items())
        + "; coder bytes per word "
        + ", ".join(f"{k} {v:.1f}" for k, v in lng["bytes_per_word"].items())
        + "; host re-encodes (encode wall s, lanes, native s, sequential "
        "s) " + ", ".join(f"{k} {e:.3f}, {n}, {t:.4f}, {q:.3f}"
                          for k, (e, n, t, q) in lat["host"].items())
        + "; first-use check s "
        + ", ".join(f"{k} {g['seconds']:.2f}"
                    for k, g in {**kernels.GUARD, **guard}.items())
        + "; cli defaults peak allocated GB "
        + ", ".join(f"{op} {r['peak_allocated_gb']:.2f}"
                    for op, r in cld.items())
        + "; host codec s " + ", ".join(f"{k} {v:.4f}"
                                         for k, v in hst["host_s"].items())
        + "; sharded world walls s " + ", ".join(
            f"{k} {v['wall_s']:.1f}" for k, v in shd.items())
        + "; large images (encode s, decode s, host lanes, host s, peak "
        "encode GB; pallas encode s, host lanes, host s) " + ", ".join(
            f"{k} {r['enc_s']:.3f}, {r['dec_s']:.3f}, {r['host']}, "
            f"{r['host_s']:.3f}, {r['enc_peak'] / 1e9:.2f}; "
            f"{p['enc_s']:.3f}, {p['host']}, {p['host_s']:.3f}"
            for k, r in large["images"].items() if "host" in r
            for p in [large["pallas"][k.split()[0]]])
        + f"; two-word pass bytes per coder word "
        f"{large['bytes_per_word']:.1f}, sorted {large['sorted'][3]:.1f}"
        + "; config sweep (encode ms, decode ms) " + "; ".join(
            f"{k} {1e3 * e:.1f}, {1e3 * d:.1f}"
            for k, (e, d) in cfr["walls"].items())
        + "; inverse DWT boat s4 ms (W1, plain chain) " + ", ".join(
            f"f{f} {w1r['inverse'][f'f{f} W1']['ms']:.3f}, "
            f"{w1r['inverse'][f'f{f} plain chain']['ms']:.3f}" for f in "AB")
        + "; decode ms (W1, plain chain) " + ", ".join(
            f"{k} {v['W1']:.2f}, {v['plain chain']:.2f}"
            for k, v in w1r["decode"].items())
        + "; main-path trace (wall ms, idle share) " + ", ".join(
            f"{k} {v['wall_ms']:.2f}, {v['idle_share']:.4f}"
            for k, v in trc.items())
        + f"; fuzz {cfr['fuzz']['trials']} trials, "
        f"{cfr['fuzz']['seconds']:.1f} s, 0 mismatches; sharded fuzz "
        + ", ".join(f"{k} {v['fuzz']['trials']} trials, 0 mismatches"
                    for k, v in shd.items() if "fuzz" in v)
        + "; coder pass peaks (B per coder word) " + ", ".join(
            f"{k} {r['bpw']:.1f}" for k, r in cpl.items())
        + "; sorted at full passes (wall s, peak GB, budget GB, host lanes) "
        + ", ".join(f"{k} x{r['images']} {r['s']:.3f}, {r['peak'] / 1e9:.2f}, "
                    f"{r['budget'] / 1e9:.2f}, {r['host']}"
                    for k, r in srt.items())
        + "; bench MP/s " + ", ".join(
            f"{m} {prg['bench']['detail'][m]['MPs']:.4f}" for m in BENCH_MODES)
        + f", ceiling {bd['combined_MPs_ceiling']:.3f}; bench peaks "
        f"batched {gb(bb['encode_peak_allocated_bytes'])}, pipelined "
        f"{gb(bp['encode_peak_allocated_bytes'])}; phase 29 {t29:.1f} s "
        f"(bench {prg['bench_s']:.1f}, scaling {prg['scaling_s']:.1f})"
        + f"; phase 30 {t30:.1f} s: {len(g30['captures'])} captures, "
        f"graph pools {gb(g30['reserved'])} (largest eager pass "
        f"{gb(g30['eager_peak'])}), boat encode graph / eager "
        f"{1e3 * g30['walls']['graph'][0]:.2f} / "
        f"{1e3 * g30['walls']['eager'][0]:.2f} ms, decode graph / eager "
        f"{1e3 * g30['walls']['graph'][1]:.2f} / "
        f"{1e3 * g30['walls']['eager'][1]:.2f} ms, API launches a boat "
        f"encode {g30['trace']['graph']['api_launches']} / "
        f"{g30['trace']['eager']['api_launches']}, a boat decode "
        f"{g30['trace']['decode graph']['api_launches']} / "
        f"{g30['trace']['decode eager']['api_launches']}; decode pools "
        f"{gb(g30['decode_pools'])}; soak {g30['soak']['trials']} trials, "
        f"{len(g30['soak']['mismatches'])} mismatches"
        + f"; phase 31 {t31:.1f} s, sort and pack ms (kernel, plain, "
        "bound) " + "; ".join(
            f"{k} {r['ms']:.3f}, {r['plain_ms']:.2f}, {r['bound_ms']:.4f}"
            for k, r in sp31["blocks"].items())
        + f"; phases 1-31 {time.perf_counter() - t_start:.1f} s")
    log(card)
    log(json.dumps({"kernels": kern}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
