#!/usr/bin/env python
"""Differential fuzz of the port (``icer_compression_tpu_torch``) against a
reference codec (not collected by pytest; run directly).

    python tests/fuzz_torch.py [--trials N | --seconds S] [--seed K]
        [--device cuda|cpu] [--against native|jax] [--max-side M]

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
"""

import argparse
import json
import sys
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trials", type=int)
    ap.add_argument("--seconds", type=float)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--against", choices=("native", "jax"))
    ap.add_argument("--max-side", type=int, default=160)
    args = ap.parse_args(argv)
    if args.trials is None and args.seconds is None:
        args.seconds = 300
    against = args.against or ("native" if args.device == "cuda" else "jax")
    ref = fuzz.native_codec() if against == "native" else jax_codec()
    port = fuzz.port_codec(args.device)
    out = fuzz.run(port, ref, trials=args.trials, seconds=args.seconds,
                   seed=args.seed, max_side=args.max_side,
                   big_side=1024 if args.max_side >= 160 else args.max_side)
    print(json.dumps({"port": port.name, "reference": ref.name,
                      "seed": args.seed, **{k: v for k, v in out.items()
                                            if k != "mismatches"},
                      "mismatches": len(out["mismatches"])}))
    return 1 if out["mismatches"] else 0


if __name__ == "__main__":
    sys.exit(main())
