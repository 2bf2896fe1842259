"""Pins for the fault phase of ``chip_smoke.py``, from the JAX package.

Encodes boat 512 lossless (stages 4, filter A, 6 segments, quota w*h: the
golden stream) and its 64x64 centre crop (``chip_smoke.FAULT_CROP``,
unlimited) with the JAX package's host codec, makes the faulted copies of
``chip_smoke.fault_cases`` with the JAX package's ``utils/faults.py`` and
decodes each with ``models/grayscale.decompress``; phase 16's colour
stream (uint16, unlimited) gets ``corrupt_random(COLOR_FAULT,
COLOR_FAULT)`` and ``models/color.decompress_yuv``.  Prints one line per
pin: the sha256 of a faulted stream or of its decode
(``chip_smoke.pixels_sha``, ``planes_sha``) and its label.  Runs on the
host CPU in seconds:

    python scripts/pin_faults.py > tests/data/golden_faults.sha256
"""

from __future__ import annotations

import hashlib
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from chip_smoke import (  # noqa: E402
    COLOR_FAULT, FAULT_CROP, color_boat, color_planes, fault_cases,
    pixels_sha, planes_sha)
from icer_compression_tpu_torch.utils.image_io import read_png  # noqa: E402


def pins():
    """[(sha256 hex, label)] in the pin file's order."""
    from icer_compression_tpu.models import color as CL
    from icer_compression_tpu.models import grayscale as G
    from icer_compression_tpu.utils import faults
    boat = read_png(REPO / "tests" / "data" / "boat.512.png") \
        .astype(np.uint16)
    h, w = boat.shape
    out = []

    def sha(b):
        return hashlib.sha256(b).hexdigest()

    for name, img, quota in (("boat", boat, h * w),
                             ("crop64", boat[FAULT_CROP], None)):
        cfg = G.CodecConfig(4, 0, 6, quota)
        stream = G.compress(np.ascontiguousarray(img), cfg)
        for label, bad in fault_cases(stream, faults):
            px = G.decompress(bad, cfg, dtype=np.uint16)
            out += [(sha(bad), f"{name} {label} stream"),
                    (pixels_sha(px), f"{name} {label} decoded")]
    y, u, v = color_planes(color_boat(boat.astype(np.uint8)), np.uint16)
    cfg = G.CodecConfig(4, 0, 6, None)
    bad = faults.corrupt_random(CL.compress_yuv(y, u, v, cfg), COLOR_FAULT,
                                seed=COLOR_FAULT)
    planes = CL.decompress_yuv(bad, cfg, dtype=np.uint16)
    out += [(sha(bad), f"colour corrupt_random {COLOR_FAULT} stream"),
            (planes_sha(planes),
             f"colour corrupt_random {COLOR_FAULT} decoded planes")]
    return out


if __name__ == "__main__":
    for sha, label in pins():
        print(f"{sha}  {label}")
