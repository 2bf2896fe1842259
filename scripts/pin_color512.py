"""Pins for the colour phase of ``chip_smoke.py``, from the JAX package.

Builds phase 16's 512x512 RGB image from boat (``chip_smoke.color_boat``),
converts it with the port's ``rgb_to_ycbcr`` and compresses the planes with
the JAX package's ``models/color.compress_yuv`` at stages 4, filter A and 6
segments, then decodes each stream with its ``decompress_yuv``.  For each
case of ``chip_smoke.COLOR_PINS`` it prints the stream's sha256 and the
decoded planes' (``chip_smoke.planes_sha``).  Runs on the host CPU:

    python scripts/pin_color512.py > tests/data/golden_color512.sha256
"""

from __future__ import annotations

import hashlib
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from chip_smoke import COLOR_PINS, color_boat, color_planes, planes_sha  # noqa: E402
from icer_compression_tpu_torch.utils.image_io import read_png  # noqa: E402


def pins():
    """[(sha256 hex, label)] in the pin file's order."""
    from icer_compression_tpu.models import color as CL
    from icer_compression_tpu.models.grayscale import CodecConfig
    rgb = color_boat(read_png(REPO / "tests" / "data" / "boat.512.png"))
    out = []
    for label, dtype, quota in COLOR_PINS:
        y, u, v = color_planes(rgb, dtype)
        cfg = CodecConfig(stages=4, filt=0, segments=6, byte_quota=quota)
        stream = CL.compress_yuv(y, u, v, cfg)
        planes = CL.decompress_yuv(stream, cfg, dtype=dtype)
        out.append((hashlib.sha256(stream).hexdigest(),
                    f"{label} stream ({len(stream)} B)"))
        out.append((planes_sha(planes), f"{label} decoded planes"))
    return out


if __name__ == "__main__":
    for sha, label in pins():
        print(f"{sha}  {label}")
