"""Colour compression example (the reference's example_encode_color.c):
RGB -> YCbCr integer conversion, stages 4, filter A, 10 segments, a
100,000-byte quota.

    python -m icer_compression_tpu_torch.examples.compress_color
        [in.png] [out.bin] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np

from ..models import color
from ..models.grayscale import CodecConfig
from ..utils.colorspace import rgb_to_ycbcr
from ..utils.image_io import load_image
from .compress_gray import DEFAULT_IN

CONFIG = CodecConfig(stages=4, filt=0, segments=10, byte_quota=100000)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("input", nargs="?", default=str(DEFAULT_IN))
    ap.add_argument("output", nargs="?", default="compressed_color.bin")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    rgb = load_image(args.input, force_color=True)[0]
    y, u, v = (c.astype(np.uint16) for c in rgb_to_ycbcr(rgb))
    t0 = time.time()
    stream = color.compress_yuv(y, u, v, CONFIG, device=args.device)
    dt = time.time() - t0
    Path(args.output).write_bytes(stream)
    print(f"compressed size {len(stream)}, time taken: {dt:.3f}s -> "
          f"{args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
