"""Pins for the configuration sweep of ``chip_smoke.py`` (phase 26), from
the JAX package.

Builds the sweep with ``chip_smoke.config_sweep`` (boat 512 under filters
A-F and Q, stages 1-6, segments 1-32, uint8 and uint16; phase 20's 999x601
crop and a 333x257 crop of it; phase 25's 1600x1200 and 2048x2048; phase
16's colour image) and codes each configuration with the JAX package's
host codec (``models/grayscale.compress`` / ``decompress``,
``models/color.compress_yuv`` / ``decompress_yuv``).  Prints one line per
configuration, the sha256 of its stream and of its decoded pixels
(``chip_smoke.pixels_sha``, ``planes_sha``) and its label; then one line
per case of ``chip_smoke.error_sweep``, the name of the ``IcerStatus``
the JAX package raises and its label.  Runs on the host CPU (~30 s):

    python scripts/pin_configs.py > tests/data/golden_configs.sha256
"""

from __future__ import annotations

import hashlib
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from chip_smoke import (  # noqa: E402
    config_sweep, error_sweep, pixels_sha, planes_sha)
from icer_compression_tpu_torch.utils.image_io import read_png  # noqa: E402


def read_boat() -> np.ndarray:
    return read_png(REPO / "tests" / "data" / "boat.512.png") \
        .astype(np.uint16)


def pin_config(image, dtype, cfg) -> tuple[str, str]:
    """(stream sha256, decoded-pixel sha256) of one configuration of
    ``config_sweep`` through the JAX package's host codec; ``image`` is a
    2-D array or the (y, u, v) planes."""
    from icer_compression_tpu.models import color as CL
    from icer_compression_tpu.models import grayscale as G
    config = G.CodecConfig(*cfg)
    if isinstance(image, tuple):
        s = CL.compress_yuv(*image, config)
        return (hashlib.sha256(s).hexdigest(),
                planes_sha(CL.decompress_yuv(s, config, dtype=dtype)))
    s = G.compress(image, config)
    return (hashlib.sha256(s).hexdigest(),
            pixels_sha(G.decompress(s, config, dtype=dtype)))


def pin_error(image, cfg) -> str:
    """The name of the IcerStatus that the JAX package's ``compress`` (or
    ``compress_yuv`` of (y, u, v) planes) raises on one case of
    ``error_sweep``."""
    from icer_compression_tpu.core.status import IcerError
    from icer_compression_tpu.models import color as CL
    from icer_compression_tpu.models import grayscale as G
    try:
        if isinstance(image, tuple):
            CL.compress_yuv(*image, G.CodecConfig(*cfg))
        else:
            G.compress(image, G.CodecConfig(*cfg))
    except IcerError as e:
        return e.status.name
    raise AssertionError(f"the JAX package encodes {cfg}")


def pins(boat=None) -> list[tuple[str, str]]:
    """[(pin fields, label)] in the pin file's order."""
    boat = read_boat() if boat is None else boat
    out = [(" ".join(pin_config(img, dtype, cfg)), label)
           for label, img, dtype, cfg in config_sweep(boat)]
    out += [(pin_error(img, cfg), label)
            for label, img, cfg in error_sweep(boat)]
    return out


if __name__ == "__main__":
    for fields, label in pins():
        print(f"{fields}  {label}")
