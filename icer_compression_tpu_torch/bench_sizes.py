"""The port's bench at two frame sizes and one batch, for where the host's
time goes per image and per pixel.

Runs ``python -m icer_compression_tpu_torch.bench --batch B --batch-enc B``
on boat 512 and on boat tiled to 1024x1024 with noise of +-6 (the first
draw of ``default_rng(0)``, chip_smoke phase 20's first image), written as
a PNG to a temporary directory, each in a process of its own, and prints
per frame size each mode's MP/s and the device-time block's layers per
image and per megapixel (device ms, launches, host ms); with ``--out``
each bench's JSON line also goes to that file.  On the card (~2 min):

    python -m icer_compression_tpu_torch.bench_sizes [--batch 8]
        [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

from .utils.image_io import read_png, write_png

REPO = Path(__file__).resolve().parents[1]


def tiled_boat(boat: np.ndarray) -> np.ndarray:
    """Boat tiled 2x2 to 1024x1024 with noise of +-6 (``default_rng(0)``),
    clipped to 8 bits."""
    big = np.tile(boat, (2, 2)).astype(np.int32)
    rng = np.random.default_rng(0)
    return np.clip(big + rng.integers(-6, 7, big.shape), 0, 255).astype(
        np.uint8)


def bench(image: Path, batch: int) -> dict:
    """The bench's result on ``image`` at one batch for encode and
    decode; raises when it exits non-zero."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run(
        [sys.executable, "-m", "icer_compression_tpu_torch.bench", "--image",
         str(image), "--batch", str(batch), "--batch-enc", str(batch),
         "--reps", "5"], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=900)
    if r.returncode != 0:
        raise RuntimeError(f"bench on {image.name} exited {r.returncode}:\n"
                           f"{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(
        prog="python -m icer_compression_tpu_torch.bench_sizes",
        description="The bench at one batch on boat 512 and its 1024x1024 "
                    "tiling, layers per image and per megapixel.")
    ap.add_argument("--batch", type=int, default=8,
                    help="encode and decode batch")
    ap.add_argument("--out", help="file for the benches' JSON lines")
    args = ap.parse_args()
    boat = REPO / "tests" / "data" / "boat.512.png"
    lines = []
    with tempfile.TemporaryDirectory() as tmp:
        big = Path(tmp) / "boat1024.png"
        write_png(big, tiled_boat(read_png(boat)))
        for image in (boat, big):
            res = bench(image, args.batch)
            lines.append(json.dumps(res))
            d = res["detail"]
            mp = read_png(image).size / 1e6
            print(f"{image.name} ({mp:.3f} MP), B {args.batch}: "
                  + ", ".join(f"{m} {d[m]['MPs']:.4f}" for m in
                              ("native", "cuda", "cuda_batched",
                               "cuda_pipelined"))
                  + f" MP/s, all verified {d['all_verified']} | "
                  f"{d['device']['nvidia_smi']}")
            for half in ("encode_graph", "decode_graph"):
                r = d["device_time"][half]
                print(f"  {half}: busy {r['per_image']['busy_ms']:.4f} "
                      f"ms/img ({r['per_image']['busy_ms'] / mp:.4f} ms/MP), "
                      f"wall {r['per_image']['wall_ms']:.3f} ms/img "
                      f"({r['per_image']['wall_ms'] / mp:.3f} ms/MP), idle "
                      f"share {r['idle_share']:.4f}")
                for layer, g in sorted(r["layers"].items(),
                                       key=lambda kv: -kv[1]["host_ms"]):
                    print(f"    {layer}: host {g['host_ms_per_image']:.3f} "
                          f"ms/img ({g['host_ms_per_image'] / mp:.3f} ms/MP), "
                          f"device {g['device_ms_per_image']:.4f} ms/img "
                          f"({g['device_ms_per_image'] / mp:.4f} ms/MP), "
                          f"{g['launches_per_image']:.1f} launches/img")
    if args.out:
        Path(args.out).write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
