#!/usr/bin/env python3
"""Cost of the port's CLI batch operations at their default --batch-size and
--pipeline on one CUDA card, against --pipeline 1.

    python3 scripts/cli_defaults.py [--n 224]

Writes N colour 512x512 PNGs (chip_smoke's phase-16 RGB made from boat,
with seeded noise of +-6 per image), then runs ``batch-compress -c`` and
``batch-decompress -c`` each in a process of its own, at the defaults (K
from the parser) and with ``--pipeline 1``, in turns K, 1, 1, K.  224
images are four batches of 56, so the default run holds four batches in
flight.  Per run it prints one JSON line: the CLI's wall (after CUDA and the
kernels are loaded), the process's peak resident set, the peak of the
caching host (pinned) allocator and the peak device memory allocated and
reserved.  The decode runs read the first default compress run's streams.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def child(op: str, src: str, dst: str, pipeline: int) -> None:
    """One CLI run in this process; prints its costs as JSON."""
    import torch

    from icer_compression_tpu_torch import cli, kernels
    kernels.build_all()
    for name in kernels.KERNELS:
        kernels.load(name)
    torch.zeros(1, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.reset_peak_host_memory_stats()
    flags = ["--pipeline", str(pipeline)] if pipeline else []
    t0 = time.perf_counter()
    rc = cli.main([op, src, dst, "-c"] + flags)
    wall = time.perf_counter() - t0
    host = torch.cuda.host_memory_stats()
    print(json.dumps({
        "rc": rc, "wall_s": wall,
        "pinned_peak_bytes": {k: v for k, v in host.items()
                              if k.endswith(".peak")},
        "device_allocated_peak_bytes": torch.cuda.max_memory_allocated(),
        "device_reserved_peak_bytes": torch.cuda.max_memory_reserved()}))


def run(op, src, dst, pipeline, label):
    proc = subprocess.Popen(
        [sys.executable, __file__, "--child", op, str(src), str(dst),
         str(pipeline)], stdout=subprocess.PIPE, text=True)
    out = proc.stdout.read()
    _pid, status, usage = os.wait4(proc.pid, 0)
    rc = os.waitstatus_to_exitcode(status)
    res = json.loads(out.strip().splitlines()[-1]) if rc == 0 else {"rc": rc}
    res.update(op=op, pipeline=label, rss_peak_bytes=usage.ru_maxrss * 1024)
    print(json.dumps(res), flush=True)
    return res["rc"] == 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=224)
    ap.add_argument("--child", nargs=4, metavar=("OP", "SRC", "DST", "K"))
    args = ap.parse_args()
    if args.child:
        op, src, dst, k = args.child
        child(op, src, dst, int(k))
        return 0

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("cli_defaults: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        return 0 if runs(Path(tmp), args.n) else 1


def runs(out: Path, n: int) -> bool:
    """Every run in turns; False if any failed (a child that fails prints
    its error to stderr, and the decode runs then read the first compress
    run that passed)."""
    import numpy as np

    from icer_compression_tpu_torch.utils.image_io import read_png, write_png
    (out / "png").mkdir()
    boat = read_png(REPO / "tests" / "data" / "boat.512.png").astype(np.int32)
    rgb = np.stack([boat, np.roll(boat, 7, axis=1), boat.T], axis=-1)
    rng = np.random.default_rng(1234)
    for i in range(n):
        noisy = np.clip(rgb + rng.integers(-6, 7, rgb.shape), 0, 255)
        write_png(out / "png" / f"{i:04d}.png", noisy.astype(np.uint8))
    order = list(enumerate((0, 1, 1, 0)))
    passed = [out / f"icer_{j}" for j, k in order
              if run("batch-compress", out / "png", out / f"icer_{j}", k,
                     "default" if k == 0 else "1")]
    if not passed:
        return False
    decoded = [run("batch-decompress", passed[0], out / f"dec_{j}", k,
                   "default" if k == 0 else "1") for j, k in order]
    return len(passed) == len(order) and all(decoded)


if __name__ == "__main__":
    sys.exit(main())
