"""Pins for the long-lane phase of ``chip_smoke.py``, from the JAX package.

Builds phase 20's images with ``chip_smoke.long_lane_images`` (boat tiled
to 1024x1024 with seeded noise, its 999x601 crops, the colour image) and
phase 9's 256x256 centre crop of boat, and codes them with the JAX
package's host codec (``models/grayscale.compress`` / ``decompress``,
``models/color.compress_yuv`` / ``decompress_yuv``): stages 4, filter A,
6 segments at each quota of ``chip_smoke.LONG_LANE_QUOTAS`` (the crop at
one stage and one segment, unlimited).  Prints one line per pin, the
sha256 of a stream or of the decoded pixels (``chip_smoke.pixels_sha``,
``planes_sha``) and its label.  Runs on the host CPU:

    python scripts/pin_long_lanes.py > tests/data/golden_long_lanes.sha256
"""

from __future__ import annotations

import hashlib
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from chip_smoke import (  # noqa: E402
    LONG_LANE_QUOTAS, color_planes, long_lane_images, pixels_sha, planes_sha)
from icer_compression_tpu_torch.utils.image_io import read_png  # noqa: E402


def pins(boat=None):
    """[(sha256 hex, label)] in the pin file's order, for ``boat`` (by
    default tests/data/boat.512.png)."""
    from icer_compression_tpu.models import color as CL
    from icer_compression_tpu.models import grayscale as G
    if boat is None:
        boat = read_png(REPO / "tests" / "data" / "boat.512.png") \
            .astype(np.uint16)
    out = []

    def sha(b):
        return hashlib.sha256(b).hexdigest()

    h, w = boat.shape
    crop = np.ascontiguousarray(boat[h // 4:3 * h // 4, w // 4:3 * w // 4])
    cfg = G.CodecConfig(1, 0, 1, None)
    s = G.compress(crop, cfg)
    out += [(sha(s), "crop256 s1 g1 unlimited stream"),
            (pixels_sha(G.decompress(s, cfg, dtype=np.uint16)),
             "crop256 s1 g1 unlimited decoded")]
    images = long_lane_images(boat)
    for key in ("gray1024", "gray999x601"):
        for q in LONG_LANE_QUOTAS:
            cfg = G.CodecConfig(4, 0, 6, q)
            tag = "unlimited" if q is None else f"quota {q}"
            # every variant unlimited (the batch), the first at each quota
            for i, img in enumerate(images[key] if q is None
                                    else images[key][:1]):
                s = G.compress(img, cfg)
                out.append((sha(s), f"{key} v{i} {tag} stream"))
                if i == 0:
                    out.append((pixels_sha(G.decompress(
                        s, cfg, dtype=np.uint16)), f"{key} v0 {tag} decoded"))
    planes = color_planes(images["color1024"], np.uint16)
    for q in LONG_LANE_QUOTAS:
        cfg = G.CodecConfig(4, 0, 6, q)
        tag = "unlimited" if q is None else f"quota {q}"
        s = CL.compress_yuv(*planes, cfg)
        out += [(sha(s), f"color1024 {tag} stream"),
                (planes_sha(CL.decompress_yuv(s, cfg, dtype=np.uint16)),
                 f"color1024 {tag} decoded")]
    return out


if __name__ == "__main__":
    for digest, label in pins():
        print(f"{digest}  {label}")
