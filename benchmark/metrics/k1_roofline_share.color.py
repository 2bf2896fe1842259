"""Kernel 1's share of its roofline in the colour batch encode:
``roofline.k1_bound`` of each YCbCr canvas of every frame encoded in the
traced window (every plane coded; the canvases the mode kept,
``run.planes``) over the K1 records' device time, %.  The all-zero
canvases that pad a batch's last pass are coded too, and left out of the
bound."""

import numpy as np

from benchmark import check
from benchmark.reference import codec as R
from benchmark.roofline import K1_NAMES, k1_bound
from benchmark.tracemath import kernel_seconds


def read(run):
    planes = getattr(run, "planes", None)
    if run.trace is None or planes is None or not run.encoded_frames:
        return None
    t = kernel_seconds(run.work, K1_NAMES)
    if t <= 0:
        return None
    codec = check.reference_codec(run.config)
    bp = codec.bitplanes
    npx = run.config["width"] * run.config["height"]
    bound = {}
    for k in set(run.encoded_frames):
        secs = 0.0
        for plane in planes[k]:
            coeffs, _ = R.transform(plane, codec)
            mag = coeffs & ((1 << codec.mag_bits) - 1)
            nnz = int(np.count_nonzero((mag != 0) & (mag < (1 << bp))))
            secs += k1_bound(bp * npx, bp * npx + nnz)
        bound[k] = secs
    return 100 * sum(bound[k] for k in run.encoded_frames) / t
