"""The CLI's colour batch compress (``batch-compress -c``): batches of
``batch`` RGB frames cycled over a seeded pool of ``pool``, each batch's
YCbCr planes through ``models/color.compress_yuv_batch(defer=True)``, at
most ``inflight`` collectors open (the CLI's ``_pipelined``), closed
loop.

Content: ``color_frame`` (chip_smoke.py's ``color_boat`` of boat tiled to
a square of the frame's longer side, cut to the frame: R = boat, G = boat
rolled 7 columns, B = boat transposed) with noise of +-``noise`` on each
RGB channel from ``default_rng([seed, 0])``, clipped to 8 bits.  Set-up
converts the pool with the port's ``utils/colorspace.rgb_to_ycbcr`` to
``uint16`` planes, as the CLI does when it loads its inputs, outside the
window.  A request is one batch; its megapixels are the frames' w x h, as
the CLI's ``--time`` counts them (not three canvases a frame).

The reference (``reference/color.py``) encodes the checked frames' RGB
itself, conversion included.
"""

from __future__ import annotations

import time

import numpy as np

from benchmark import check, frames, load
from benchmark.reference import color as RC
from benchmark.reference import constants as C
from benchmark.reference.workers import Workers


def color_frame(h: int, w: int) -> np.ndarray:
    """The (h, w, 3) int32 RGB base frame."""
    side = max(h, w)
    t = frames.tiled(side, side)
    return np.stack([t, np.roll(t, 7, axis=1), t.T], axis=-1)[:h, :w]


def rgb_pool(config: dict, seed: int, n: int) -> np.ndarray:
    """``n`` distinct RGB frames of ``config`` from ``seed``: (n, h, w, 3)
    uint8."""
    base = color_frame(config["height"], config["width"])
    rng = np.random.default_rng([seed, 0])
    out = np.empty((n,) + base.shape, np.uint8)
    for i in range(n):
        out[i] = frames.noisy(base, rng, config["noise"])
    return out


def ycbcr_pool(rgb: np.ndarray) -> np.ndarray:
    """The pool's (n, 3, h, w) uint16 planes, through the port's
    conversion (the CLI's ``load_image`` path)."""
    from icer_compression_tpu_torch.utils.colorspace import rgb_to_ycbcr
    out = np.empty((len(rgb), 3) + rgb.shape[1:3], np.uint16)
    for i, frame in enumerate(rgb):
        for c, plane in enumerate(rgb_to_ycbcr(frame)):
            out[i, c] = plane
    return out


def run(run, seconds, profile, dev):
    from icer_compression_tpu_torch.models import color as CL
    c, t = run.config, run.traffic
    cfg = load.codec_config(c, t)
    pool = rgb_pool(c, run.seed, t["pool"])
    planes = ycbcr_pool(pool)
    B, K = t["batch"], t["inflight"]
    keep = set(load._check_keys(run, range(t["pool"])))

    def submit(idx):
        return CL.compress_yuv_batch(
            *([planes[i, c] for i in idx] for c in range(3)), cfg,
            device=dev, defer=True)

    def finish_warm(hold, idx, t0):
        hold()

    for idx in list(load._take(load._cycle(t["pool"], B), t["warm_serial"])):
        finish_warm(submit(idx), idx, 0)
    load._pipelined(submit, finish_warm, load._cycle(t["pool"], B), K,
                    limit=t["warm_pipelined"])

    def finish(hold, idx, t0):
        streams = hold()
        t1 = time.perf_counter()
        run.requests.append((load.ENCODE, t0, t1, len(idx) * run.mp))
        run.answered += len(streams)
        run.encoded_frames.extend(idx)
        for i, s in zip(idx, streams):
            run.answers.append((i, "stream", s))

    def submit_counted(idx):
        run.attempted += len(idx)
        return submit(idx)

    with load._window(run, profile, dev):
        load._pipelined(submit_counted, finish, load._cycle(t["pool"], B), K,
                        until=None if run.trace_on
                        else time.perf_counter() + seconds,
                        limit=t["trace_batches"] if run.trace_on else None)
    run.pool = pool
    run.planes = planes
    run.check_keys = keep
    return []


def reference(run, quota, workers, control):
    """The checked frames' streams and planes from ``reference/color.py``,
    with ``control``'s fault put in: a codeword buffer that never fills
    (``unbounded_window``), each channel's decode one plane short
    (``one_plane_short``)."""
    keys = sorted(run.check_keys)
    codec = check.reference_codec(run.config)
    window = 1 << 40 if control == "unbounded_window" else C.CIRC_BUF_SIZE
    with Workers(workers) as pool:
        out = RC.encode_color([run.pool[k] for k in keys], quota, codec,
                              pool, window)
    res = {}
    for k, r in zip(keys, out):
        included = r["included"]
        if control == "one_plane_short":
            included = [check._one_plane_short(s) for s in included]
        res[k] = {"stream": r["stream"],
                  "pixels": RC.expected_pixels(r, codec, included)}
    return res
