#!/usr/bin/env python
"""Differential fuzz of the port (``icer_compression_tpu_torch``) against a
reference codec (not collected by pytest; run directly).

    python tests/fuzz_torch.py [--trials N | --seconds S] [--seed K]
        [--device cuda|cpu] [--against native|jax] [--max-side M]
        [--sharded]

Samples trials with ``icer_compression_tpu_torch.utils.fuzz`` (the
envelope of ``fuzz_oracle.py``, with colour trials and batches of 2-4
images) and runs each through the port on ``--device`` and through the
reference: ``native``, the port's host codec on its native runtime (the
default with ``--device cuda``; the machine with the card has no JAX), or
``jax``, the JAX package's host codec on the CPU (the default with
``--device cpu``).  Streams must be equal byte for byte, decodes pixel
for pixel and refusals by IcerStatus.  A mismatch dumps the trial's
configuration, images and streams to a temporary directory, and the run
exits 1.  On the CPU the port runs its kernels' plain versions, whose
decoder steps pixel by pixel in Python: keep ``--max-side`` near 48 there.

``--sharded`` soaks the sharded classes of ``parallel/sharded.py`` (the
way ``tests/fuzz_sharded.py`` soaks the JAX package's): worlds of two
processes joined over gloo, both ranks on ``--device`` (``cuda`` means
cuda:0, which both share), each world running a list of
``SHARDED_CHUNK`` sharded trials (``utils.fuzz.sample_sharded``; seed K,
then K + 1, ... per world) while this process computes the reference's
results; every rank's streams, decodes and refusals must equal the
reference's and each other's.
"""

import argparse
import json
import os
import pickle
import sys
import tempfile
import time
from collections import Counter
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from icer_compression_tpu_torch.core.status import (  # noqa: E402
    IcerError, IcerStatus)
from icer_compression_tpu_torch.utils import fuzz  # noqa: E402


def jax_codec() -> fuzz.Codec:
    """The JAX package's host codec (models/grayscale, models/color), its
    refusals raised as the port's IcerError of the same status."""
    from icer_compression_tpu.models import color as CL
    from icer_compression_tpu.models import grayscale as G

    def cfg_of(cfg):
        return G.CodecConfig(cfg.stages, cfg.filt, cfg.segments,
                             cfg.byte_quota)

    return fuzz.Codec(
        "JAX host codec",
        _statuses(lambda img, cfg: G.compress(img, cfg_of(cfg))),
        _statuses(lambda s, cfg, dt: G.decompress(s, cfg_of(cfg), dtype=dt)),
        _statuses(lambda y, u, v, cfg: CL.compress_yuv(y, u, v,
                                                       cfg_of(cfg))),
        _statuses(lambda s, cfg, dt: CL.decompress_yuv(s, cfg_of(cfg),
                                                       dtype=dt)))


def _statuses(fn):
    from icer_compression_tpu.core.status import IcerError as JaxIcerError

    def call(*args):
        try:
            return fn(*args)
        except JaxIcerError as e:
            raise IcerError(IcerStatus[e.status.name], str(e)) from e
    return call


SHARDED_CHUNK = 25              # sharded trials per world
SHARDED_WORLD_TIMEOUT_S = 1200


def sharded_rank(rank: int, port: int, out: str, seed: int, count: int,
                 max_side: int, big_side: int, min_side: int,
                 device: str) -> None:
    """One rank of a sharded soak's world of two: every trial of
    ``fuzz.sharded_trials(seed, ...)`` through the port's sharded classes
    on ``device``; the results go to ``out/rank{rank}.pkl``."""
    import torch
    from icer_compression_tpu_torch.parallel import distributed
    torch.set_num_threads(1)
    distributed.initialize(f"tcp://127.0.0.1:{port}", 2, rank,
                           backend="gloo", device=device)
    trials = fuzz.sharded_trials(seed, count, max_side, big_side, min_side)
    res = fuzz.sharded_results(trials, device)
    with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
    torch.distributed.destroy_process_group()


def sharded_world(ref: fuzz.Codec, seed: int, count: int, max_side: int,
                  big_side: int, min_side: int = 8, device: str = "cpu",
                  log=print) -> dict:
    """One world of two ranks over ``count`` sharded trials from ``seed``,
    checked against ``ref`` (``fuzz.check_sharded``'s summary, with the
    world's seconds)."""
    from test_torch_parallel import finish_world, start_world
    t0 = time.perf_counter()
    args = [str(a) for a in (seed, count, max_side, big_side, min_side,
                             device)]
    with tempfile.TemporaryDirectory() as out:
        world = start_world(0, out, lambda rank, port: [
            sys.executable, os.path.abspath(__file__), "--sharded-rank",
            str(rank), str(port), out, *args], SHARDED_WORLD_TIMEOUT_S)
        try:
            trials = fuzz.sharded_trials(seed, count, max_side, big_side,
                                         min_side)
            refs = [fuzz.sharded_reference(t, ref) for t in trials]
        finally:
            ranks = finish_world(world, out)
    res = fuzz.check_sharded(trials, ranks, refs, log)
    return {**res, "seconds": time.perf_counter() - t0}


def sharded_soak(args, ref: fuzz.Codec) -> dict:
    """Worlds of ``SHARDED_CHUNK`` trials (seed, seed + 1, ...) until
    ``--trials`` have run or ``--seconds`` have passed."""
    device = "cuda:0" if args.device == "cuda" else "cpu"
    total = {"trials": 0, "mismatches": [], "worlds": 0, "color": 0,
             "refused": 0, "tiny_quota": 0, "two_word": 0,
             "per_mesh": Counter(), "per_quota": Counter()}
    t0 = time.perf_counter()
    while (args.trials is None or total["trials"] < args.trials) and (
            args.seconds is None or time.perf_counter() - t0 < args.seconds):
        count = SHARDED_CHUNK if args.trials is None else min(
            SHARDED_CHUNK, args.trials - total["trials"])
        res = sharded_world(ref, args.seed + total["worlds"], count,
                            args.max_side, big_side(args.max_side),
                            device=device)
        total["worlds"] += 1
        for k in ("trials", "color", "refused", "tiny_quota", "two_word",
                  "per_mesh", "per_quota"):
            total[k] += res[k] if isinstance(res[k], int) else Counter(
                res[k])
        total["mismatches"] += res["mismatches"]
    total["seconds"] = time.perf_counter() - t0
    return total


def big_side(max_side: int) -> int:
    return 1024 if max_side >= 160 else max_side


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trials", type=int)
    ap.add_argument("--seconds", type=float)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--against", choices=("native", "jax"))
    ap.add_argument("--max-side", type=int, default=160)
    ap.add_argument("--sharded", action="store_true",
                    help="soak the sharded classes in worlds of two")
    args = ap.parse_args(argv)
    if args.trials is None and args.seconds is None:
        args.seconds = 300
    against = args.against or ("native" if args.device == "cuda" else "jax")
    ref = fuzz.native_codec() if against == "native" else jax_codec()
    if args.sharded:
        out = sharded_soak(args, ref)
        print(json.dumps({"port": "sharded classes, worlds of two on "
                          f"{args.device}", "reference": ref.name,
                          "seed": args.seed, **{
                              k: v for k, v in out.items()
                              if k != "mismatches"},
                          "mismatches": len(out["mismatches"])}))
        return 1 if out["mismatches"] else 0
    port = fuzz.port_codec(args.device)
    out = fuzz.run(port, ref, trials=args.trials, seconds=args.seconds,
                   seed=args.seed, max_side=args.max_side,
                   big_side=big_side(args.max_side))
    print(json.dumps({"port": port.name, "reference": ref.name,
                      "seed": args.seed, **{k: v for k, v in out.items()
                                            if k != "mismatches"},
                      "mismatches": len(out["mismatches"])}))
    return 1 if out["mismatches"] else 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--sharded-rank"]:
        a = sys.argv[2:]
        sharded_rank(int(a[0]), int(a[1]), a[2], *map(int, a[3:8]), a[8])
    else:
        sys.exit(main())
