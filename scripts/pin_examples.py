"""Pins for the port's example programs (``chip_smoke.py`` phase 29), from
the JAX package.

Codes the examples' inputs at the examples' configurations with the JAX
package's host codec and colour conversion: boat 512 through
``models/grayscale.compress`` at stages 4, filter A, 6 segments, quota
30,000, and phase 16's RGB (``chip_smoke.color_boat``) through
``utils/colorspace.rgb_to_ycbcr`` and ``models/color.compress_yuv`` at
stages 4, filter A, 10 segments, quota 100,000.  Prints one line each:
the sha256 of the stream, of the decoded pixels (``chip_smoke.pixels_sha``;
the colour planes Y, U and V, ``chip_smoke.planes_sha``) and of the
pixels of the PNG that the decompression example writes (clipped to 8
bits; the colour one through ``ycbcr_to_rgb``), then the label.  Runs on
the host CPU (~5 s):

    python scripts/pin_examples.py > tests/data/golden_examples.sha256
"""

from __future__ import annotations

import hashlib
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from chip_smoke import color_boat, pixels_sha, planes_sha  # noqa: E402
from icer_compression_tpu_torch.utils.image_io import read_png  # noqa: E402

# (label, stages, filter, segments, quota) of the examples
GRAY = ("gray s4 fA g6 q30000", 4, 0, 6, 30000)
COLOR = ("colour s4 fA g10 q100000", 4, 0, 10, 100000)


def pin_gray(image: np.ndarray, stages=4, filt=0, segments=6,
             quota=30000) -> tuple[str, str, str]:
    """(stream, decoded pixels, PNG pixels) sha256 of the grayscale
    examples on ``image`` through the JAX package."""
    from icer_compression_tpu.models import grayscale as G
    s = G.compress(image.astype(np.uint16),
                   G.CodecConfig(stages, filt, segments, quota))
    px = np.asarray(G.decompress(s, G.CodecConfig(stages, filt, segments),
                                 dtype=np.uint16))
    return (hashlib.sha256(s).hexdigest(), pixels_sha(px),
            pixels_sha(np.clip(px, 0, 255).astype(np.uint8)))


def pin_color(rgb: np.ndarray, stages=4, filt=0, segments=10,
              quota=100000) -> tuple[str, str, str]:
    """(stream, decoded Y/U/V, PNG pixels) sha256 of the colour examples
    on ``rgb`` through the JAX package."""
    from icer_compression_tpu.models import color as CL
    from icer_compression_tpu.models.grayscale import CodecConfig
    from icer_compression_tpu.utils.colorspace import (rgb_to_ycbcr,
                                                       ycbcr_to_rgb)
    y, u, v = (c.astype(np.uint16) for c in rgb_to_ycbcr(rgb))
    s = CL.compress_yuv(y, u, v, CodecConfig(stages, filt, segments, quota))
    planes = [np.asarray(c) for c in CL.decompress_yuv(
        s, CodecConfig(stages, filt, segments), dtype=np.uint16)]
    return (hashlib.sha256(s).hexdigest(), planes_sha(planes),
            pixels_sha(ycbcr_to_rgb(*planes)))


def pins(boat=None) -> list[tuple[str, str]]:
    """[(pin fields, label)] in the pin file's order."""
    if boat is None:
        boat = read_png(REPO / "tests" / "data" / "boat.512.png")
    return [(" ".join(pin_gray(boat, *GRAY[1:])), GRAY[0]),
            (" ".join(pin_color(color_boat(boat), *COLOR[1:])), COLOR[0])]


def main() -> int:
    for fields, label in pins():
        print(f"{fields} {label}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
