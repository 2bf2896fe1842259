"""Colour decompression example (the reference's example_decode_color.c):
YCbCr planes back to RGB; stages 4, filter A, 10 segments.

    python -m icer_compression_tpu_torch.examples.decompress_color
        [in.bin] [out.png] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np

from ..models import color
from ..models.grayscale import CodecConfig
from ..utils.colorspace import ycbcr_to_rgb
from ..utils.image_io import save_image

CONFIG = CodecConfig(stages=4, filt=0, segments=10)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("input", nargs="?", default="compressed_color.bin")
    ap.add_argument("output", nargs="?", default="decompressed_color.png")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    data = Path(args.input).read_bytes()
    t0 = time.time()
    y, u, v = color.decompress_yuv(data, CONFIG, dtype=np.uint16,
                                   device=args.device)
    rgb = ycbcr_to_rgb(y, u, v)
    dt = time.time() - t0
    save_image(args.output, rgb)
    print(f"decompressed {rgb.shape[1]}x{rgb.shape[0]} in {dt:.3f}s -> "
          f"{args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
