"""Scaling harness of the sharded encoder over worlds of 1..N ranks.

Counterpart: ``bench_scaling.py`` at the repository root (the JAX
package's, over meshes of 1..N devices), with its arguments and images.
For each world size n it starts n ranks, each a process of this module
(``--rank``), joined by ``parallel/distributed.initialize`` on a free
local port; rank r runs on ``cuda:(r % device_count)`` (``--device
cuda``) or on the CPU.  A world whose ranks share a card, or that runs on
the CPU, joins over gloo; otherwise over NCCL.  Every rank builds the
default ('data', 'seg') mesh (``parallel/sharded.make_mesh``) and a
``ShardedGrayscaleEncoder``; rank 0 times ``compress_batch`` of
``batch-per-device * data`` images (after ``graph_cache.CAPTURE_AT``
warm-up calls, so the timed ones replay each pass's graph) and checks
its streams against the single-device ``models/grayscale.compress_batch``.

Prints one JSON line per world: ``devices`` (ranks), ``mesh``, ``batch``,
``MPs``, ``scaling_efficiency`` against the first world, ``cards`` and
``ranks_per_card``.  The efficiency is null where ranks share a card or
run on the CPU (neither measures scaling across cards) and for the first
world.  Exits non-zero when a rank fails or a stream differs, and without
a card unless ``--device cpu`` is given.

    python -m icer_compression_tpu_torch.bench_scaling [--devices 1,2,4,8]
        [--device cuda|cpu] [--size 128] [--segments 4] [--stages 2]
        [--batch-per-device 2] [--reps 3]
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

# seconds a world may take, process start included
WORLD_TIMEOUT_S = 600


def world_images(counts, index: int, size: int, batch_per_device: int):
    """The images of world ``counts[index]``: the root bench's recipe, one
    generator (``default_rng(0)``) drawn world after world."""
    from .parallel.sharded import mesh_shape
    rng = np.random.default_rng(0)
    base = np.add.outer(np.arange(size) * 3, np.arange(size))[None] % 200
    for n in counts[:index + 1]:
        B = mesh_shape(n)[0] * batch_per_device
        imgs = (base + rng.integers(0, 40, (B, size, size))).astype(
            np.uint16)
    return imgs


def rank_main(args) -> int:
    """One rank of a world: encode, and on rank 0 time and check."""
    from .backend import graph_cache
    from .models import grayscale as T
    from .parallel import distributed
    from .parallel.sharded import ShardedGrayscaleEncoder
    counts = [int(x) for x in args.devices.split(",")]
    n, rank = counts[args.world_index], args.rank
    if args.device == "cpu":
        device, backend = "cpu", "gloo"
    else:
        cards = torch.cuda.device_count()
        device = f"cuda:{rank % cards}"
        backend = "nccl" if n <= cards else "gloo"
    torch.set_num_threads(max(1, (torch.get_num_threads()) // n))
    distributed.initialize(f"tcp://127.0.0.1:{args.port}", n, rank,
                           backend=backend, device=device)
    mesh = distributed.global_mesh(device=device)
    H = W = args.size
    imgs = world_images(counts, args.world_index, args.size,
                        args.batch_per_device)
    cfg = T.CodecConfig(args.stages, 0, args.segments, None)
    enc = ShardedGrayscaleEncoder(mesh, W, H, args.stages, 0, args.segments,
                                  mag_bits=15)
    # warm up through a pass's capture (at its CAPTURE_AT-th call), so
    # that the timed calls replay its graph
    for _ in range(graph_cache.CAPTURE_AT):
        streams = enc.compress_batch(imgs, cfg)
    t0 = time.perf_counter()
    for _ in range(args.reps):
        enc.compress_batch(imgs, cfg)
    dt = (time.perf_counter() - t0) / args.reps
    if rank == 0:
        ref = T.compress_batch(imgs, cfg, device=mesh.device)
        Path(args.out).write_text(json.dumps({
            "mesh": mesh.shape, "batch": len(imgs),
            "MPs": len(imgs) * H * W / dt / 1e6,
            "backend": backend, "streams_equal": streams == ref}))
    torch.distributed.destroy_process_group()
    return 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_world(args, index: int) -> dict:
    """Start the ranks of world ``index``, wait for them and return rank
    0's result; raises when a rank fails."""
    n = int(args.devices.split(",")[index])
    port = _free_port()
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "rank0.json"
        cmd = [sys.executable, "-m", __spec__.name, "--rank", "{r}",
               "--world-index", str(index), "--port", str(port),
               "--out", str(out), "--devices", args.devices,
               "--device", args.device, "--size", str(args.size),
               "--segments", str(args.segments), "--stages",
               str(args.stages), "--batch-per-device",
               str(args.batch_per_device), "--reps", str(args.reps)]
        # the ranks import this package from where this process did
        root = str(Path(__file__).resolve().parents[1])
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
        procs = [subprocess.Popen([c.format(r=r) for c in cmd], env=env,
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for r in range(n)]
        t0 = time.perf_counter()
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=max(
                    1.0, t0 + WORLD_TIMEOUT_S - time.perf_counter()))[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, log) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                raise RuntimeError(f"world of {n}: rank {r} failed "
                                   f"({p.returncode}):\n{log[-4000:]}")
        return json.loads(out.read_text())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m icer_compression_tpu_torch.bench_scaling",
        description="Sharded-encoder throughput over worlds of 1..N ranks.")
    ap.add_argument("--devices", default="1,2,4,8",
                    help="world sizes (ranks), comma-separated")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--segments", type=int, default=4)
    ap.add_argument("--stages", type=int, default=2)
    ap.add_argument("--batch-per-device", type=int, default=2)
    ap.add_argument("--reps", type=int, default=3)
    # one rank of a world (started by this program)
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--world-index", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--out", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("bench_scaling: no CUDA device (pass --device cpu for a host "
              "run)", file=sys.stderr)
        return 2
    if args.rank is not None:
        return rank_main(args)
    cards = torch.cuda.device_count() if args.device == "cuda" else 0
    base = None
    ok = True
    for i, n in enumerate(int(x) for x in args.devices.split(",")):
        r = run_world(args, i)
        used = min(n, cards)
        per_card = -(-n // used) if used else None
        scales = per_card == 1
        eff = None
        if base is None:
            base = (n, r["MPs"], scales)
        elif scales and base[2]:
            eff = (r["MPs"] / base[1]) / (n / base[0])
        ok = ok and r["streams_equal"]
        print(json.dumps({"devices": n, "mesh": r["mesh"],
                          "batch": r["batch"], "MPs": r["MPs"],
                          "scaling_efficiency": eff, "cards": used,
                          "ranks_per_card": per_card,
                          "backend": r["backend"],
                          "streams_equal": r["streams_equal"]}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
