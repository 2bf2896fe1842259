"""The control of a cell's check: a run of the cell whose checked answers
are replaced, once its window has closed, by the plain reference with a
known fault put in the program's place.  Its numbers must come out over
their limits (``correct`` false).

    python3 -m benchmark.control --workload <cell> --seed <n> \
        --seconds <s> --control unbounded_window|one_plane_short

``unbounded_window``: a coder that never force-completes the oldest
codeword when the buffer of 2,048 words is full (the rule a faster coder
would be tempted to drop): streams differ wherever a lane fills it.
``one_plane_short``: a decoder that stops one plane early in every
segment.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys

from . import check, run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", choices=check.CONTROLS, required=True)
    args = ap.parse_args(argv)
    with open(run.ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    out = run.execute(bench, args.workload, args.seed, args.seconds, False,
                      control=args.control)
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      "control": args.control, "correct": out["correct"],
                      "checks": out["checks"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
