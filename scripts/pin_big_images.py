"""Pins for the large-image phase of ``chip_smoke.py``, from the JAX package.

Builds phase 25's images with ``chip_smoke.big_images`` (boat tiled to
1600x1200, 2048x2048 and 5120x3840 with seeded noise, the 1600x1200
colour image and the CLI's colour variants) and codes them with the JAX
package's host codec (``models/grayscale.compress`` / ``decompress``,
``models/color.compress_yuv`` / ``decompress_yuv``) at stages 4, filter
A, 6 segments: 1600x1200, the first 2048x2048 variant and the colour
image at each quota of ``chip_smoke.BIG_QUOTAS``, every 2048x2048 variant
and 5120x3840 unlimited, and each CLI variant at the CLI's default quota
(3 w h bytes), its decode as the RGB the CLI writes.  Prints one line per
pin, the sha256 of a stream or of the decoded pixels
(``chip_smoke.pixels_sha``, ``planes_sha``) and its label.  Runs on the
host CPU:

    python scripts/pin_big_images.py > tests/data/golden_big_images.sha256
"""

from __future__ import annotations

import hashlib
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from chip_smoke import (  # noqa: E402
    BIG_QUOTAS, big_images, color_planes, pixels_sha, planes_sha)
from icer_compression_tpu_torch.utils.colorspace import (  # noqa: E402
    ycbcr_to_rgb)
from icer_compression_tpu_torch.utils.image_io import read_png  # noqa: E402


def pins(boat=None):
    """[(sha256 hex, label)] in the pin file's order, for ``boat`` (by
    default tests/data/boat.512.png)."""
    from icer_compression_tpu.models import color as CL
    from icer_compression_tpu.models import grayscale as G
    if boat is None:
        boat = read_png(REPO / "tests" / "data" / "boat.512.png") \
            .astype(np.uint16)
    images = big_images(boat)
    out = []

    def sha(b):
        return hashlib.sha256(b).hexdigest()

    def tag(q):
        return "unlimited" if q is None else f"quota {q}"

    for key in ("gray1600x1200", "gray2048", "gray5120x3840"):
        imgs = images[key]
        for q in BIG_QUOTAS if key != "gray5120x3840" else (None,):
            cfg = G.CodecConfig(4, 0, 6, q)
            # every 2048x2048 variant unlimited (the batch), the first at
            # each quota
            for i, img in enumerate(imgs if q is None else imgs[:1]):
                s = G.compress(img, cfg)
                out.append((sha(s), f"{key} v{i} {tag(q)} stream"))
                if i == 0:
                    d = G.decompress(s, cfg, dtype=np.uint16)
                    out.append((pixels_sha(d), f"{key} v0 {tag(q)} decoded"))
    planes = color_planes(images["color1600x1200"], np.uint16)
    for q in BIG_QUOTAS:
        cfg = G.CodecConfig(4, 0, 6, q)
        s = CL.compress_yuv(*planes, cfg)
        out += [(sha(s), f"color1600x1200 {tag(q)} stream"),
                (planes_sha(CL.decompress_yuv(s, cfg, dtype=np.uint16)),
                 f"color1600x1200 {tag(q)} decoded")]
    for i, rgb in enumerate(images["cli1600x1200"]):
        h, w = rgb.shape[:2]
        cfg = G.CodecConfig(4, 0, 6, 3 * h * w)
        s = CL.compress_yuv(*color_planes(rgb, np.uint16), cfg)
        back = ycbcr_to_rgb(*CL.decompress_yuv(s, cfg, dtype=np.uint16))
        out += [(sha(s), f"cli1600x1200 c{i} stream"),
                (pixels_sha(back), f"cli1600x1200 c{i} decoded rgb")]
    return out


if __name__ == "__main__":
    for digest, label in pins():
        print(f"{digest}  {label}")
