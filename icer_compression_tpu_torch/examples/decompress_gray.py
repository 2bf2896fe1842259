"""Grayscale decompression example (the reference's example_decode.c);
the parameters match the encoder's (stages 4, filter A, 6 segments).

    python -m icer_compression_tpu_torch.examples.decompress_gray
        [in.bin] [out.png] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np

from ..models import grayscale
from ..models.grayscale import CodecConfig
from ..utils.image_io import save_image

CONFIG = CodecConfig(stages=4, filt=0, segments=6)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("input", nargs="?", default="compressed.bin")
    ap.add_argument("output", nargs="?", default="decompressed.png")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    data = Path(args.input).read_bytes()
    t0 = time.time()
    img = grayscale.decompress(data, CONFIG, dtype=np.uint16,
                               device=args.device)
    dt = time.time() - t0
    save_image(args.output, img)
    print(f"decompressed {img.shape[1]}x{img.shape[0]} in {dt:.3f}s -> "
          f"{args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
