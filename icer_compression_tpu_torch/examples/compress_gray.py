"""Grayscale compression example (the reference's example_encode.c):
stages 4, filter A, 6 segments, a 30,000-byte quota.

    python -m icer_compression_tpu_torch.examples.compress_gray
        [in.png] [out.bin] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np

from ..models import grayscale
from ..models.grayscale import CodecConfig
from ..utils.image_io import load_image

CONFIG = CodecConfig(stages=4, filt=0, segments=6, byte_quota=30000)
DEFAULT_IN = Path(__file__).resolve().parents[2] / "tests" / "data" \
    / "boat.512.png"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("input", nargs="?", default=str(DEFAULT_IN))
    ap.add_argument("output", nargs="?", default="compressed.bin")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    img = load_image(args.input, force_color=False)[0].astype(np.uint16)
    t0 = time.time()
    stream = grayscale.compress(img, CONFIG, device=args.device)
    dt = time.time() - t0
    Path(args.output).write_bytes(stream)
    print(f"compressed size {len(stream)}, time taken: {dt:.3f}s")
    print(f"output saved to {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
