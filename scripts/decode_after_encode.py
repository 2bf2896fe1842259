#!/usr/bin/env python3
"""A warm boat decode (512x512, lossless, s4 fA g6) on one CUDA card in
three positions, each traced: after a replayed encode, after an eager
encode (``graph=False``), and after ``graph_cache.CACHE.clear()`` with
``torch.cuda.empty_cache()``.

    python3 scripts/decode_after_encode.py [--reps 5] [--graph] [--out DIR]

The decode runs eagerly (``graph=False``).  ``--graph`` adds a fourth
position, the default decode (a replayed graph) after a replayed encode.

Per position: the decode's wall, unprofiled, as the median of ``--reps``
runs taken in turns with the other positions (the position after
``clear``, which drops every graph, after the others are done); then one
run under ``torch.profiler``, read by layer from the program's own spans
and stage marks (``utils/trace.layer_breakdown``; up to five windows,
until one holds K2's and W1's kernels, since the profiler can drop
records late in a long process):
the decode's wall, device busy ms and idle share, the allocator calls the
profiler sees in the decode's window (``cudaMalloc``, ``cudaFree``,
``cudaHostAlloc``, ``cudaFreeHost`` and their variants) and the host ms
by layer.  Also the device memory reserved and allocated
before the decode.  Prints one JSON line; with ``--out DIR`` it also
writes it to ``DIR/decode_after_encode.json``.  chip_smoke.py
phase 30 calls ``positions``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parents[1]
ALLOC_CALLS = ("cudaMalloc", "cudaFree", "cudaHostAlloc", "cudaFreeHost",
               "cudaMallocHost", "cudaMallocAsync", "cudaFreeAsync",
               "cuMemCreate", "cuMemRelease", "cuMemMap", "cuMemUnmap",
               "cuMemAddressReserve", "cuMemAddressFree")


def allocator_calls(events, window: str) -> dict:
    """{call: count} of the allocator's runtime and driver calls inside
    the host range ``window`` of a chrome trace's events."""
    (win,) = [e for e in events if e.get("cat") == "user_annotation"
              and e.get("name") == window]
    t0, t1 = win["ts"], win["ts"] + win["dur"]
    out: dict = {}
    for e in events:
        if e.get("cat") in ("cuda_runtime", "cuda_driver") \
                and t0 <= e["ts"] <= t1 and e.get("name") in ALLOC_CALLS:
            out[e["name"]] = out.get(e["name"], 0) + 1
    return out


def positions(dev, boat, reps: int = 5, graph: bool = False) -> dict:
    """The decode's numbers in each position (module docstring)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from icer_compression_tpu_torch.backend import graph_cache as GC
    from icer_compression_tpu_torch.models import grayscale as T
    from icer_compression_tpu_torch.utils.trace import layer_breakdown

    h, w = boat.shape
    cfg = T.CodecConfig(4, 0, 6, None)
    genc = T.make_encoder(w, h, cfg, np.uint16, dev)
    eenc = T.make_encoder(w, h, cfg, np.uint16, dev, graph=False)
    eager_kw = {"graph": False}

    def encode(enc):
        return T.compress_batch(boat[None], cfg, encoder=enc)[0]

    stream = encode(eenc)
    for _ in range(3):               # the graph's eager passes, capture
        if encode(genc) != stream:
            raise AssertionError("graph encode differs from the eager one")

    def decode(kw):
        return T.decompress(stream, cfg, np.uint16, device=dev, **kw)

    def clear():
        GC.CACHE.clear()
        torch.cuda.empty_cache()

    setups = {"after a replayed encode": (lambda: encode(genc), eager_kw),
              "after an eager encode": (lambda: encode(eenc), eager_kw)}
    if graph:
        setups["graph decode after a replayed encode"] = (
            lambda: encode(genc), {})
    setups["after clear and empty_cache"] = (clear, eager_kw)
    turns = list(setups)[:-1]
    for _ in range(3):               # warm every path (graph keys too)
        for name in turns:
            setup, kw = setups[name]
            setup()
            decode(kw)
    walls: dict = {k: [] for k in setups}

    def timed(name):
        setup, kw = setups[name]
        setup()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        px = decode(kw)
        torch.cuda.synchronize()
        walls[name].append(time.perf_counter() - t0)
        if not np.array_equal(px, boat):
            raise AssertionError(f"decode {name} differs from boat")

    def window(name):
        setup, kw = setups[name]
        setup()
        torch.cuda.synchronize()
        mem = {"reserved_bytes": torch.cuda.memory_reserved(),
               "allocated_bytes": torch.cuda.memory_allocated(),
               "graph_pool_bytes": GC.reserved_bytes(dev)}
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function("decode"):
                decode(kw)
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / "trace.json"
            prof.export_chrome_trace(str(path))
            events = json.loads(path.read_text())["traceEvents"]
        return mem, events, layer_breakdown(events, "decode")

    def complete(r) -> bool:
        return all(any(k in n for n in r["kernels"])
                   for k in ("plane_decode_kernel", "inverse_"))

    def profiled(name) -> dict:
        # the profiler can drop a window's records late in a long process:
        # up to five windows, until one holds K2's and W1's kernels
        got = None
        for tries in range(1, 6):
            try:
                got = window(name)
            except AssertionError:      # a window with no device work
                continue
            if complete(got[2]):
                break
        if got is None:
            raise AssertionError(f"five profiled windows of the decode "
                                 f"{name} held no device work")
        mem, events, r = got
        return {
            "profiled_windows": tries, "records_complete": complete(r),
            "wall_ms_median": 1e3 * statistics.median(walls[name]),
            "walls_ms": [1e3 * t for t in walls[name]],
            "profiled_wall_ms": r["wall_ms"], "busy_ms": r["busy_ms"],
            "idle_share": r["idle_share"], "launches": r["launches"],
            "api_launches": r["api_launches"],
            "allocator_calls": allocator_calls(events, "decode"),
            "host_ms_by_layer": {k: g["host_ms"]
                                 for k, g in r["layers"].items()},
            "device_ms_by_layer": {k: g["device_ms"]
                                   for k, g in r["layers"].items()},
            **mem}

    for i in range(reps):
        for name in turns if i % 2 == 0 else turns[::-1]:
            timed(name)
    res = {name: profiled(name) for name in turns}
    # last: the clear drops the graphs that the positions above replay
    for _ in range(reps):
        timed("after clear and empty_cache")
    res["after clear and empty_cache"] = profiled(
        "after clear and empty_cache")
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--graph", action="store_true")
    ap.add_argument("--out", default=None,
                    help="directory for a copy of the JSON line")
    args = ap.parse_args()
    sys.path.insert(0, str(HERE))
    import torch
    if not torch.cuda.is_available():
        print("decode_after_encode: no CUDA device", file=sys.stderr)
        return 2
    from icer_compression_tpu_torch import kernels
    from icer_compression_tpu_torch.utils.image_io import read_png
    kernels.build_all()
    boat = read_png(HERE / "tests" / "data" / "boat.512.png") \
        .astype(np.uint16)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    out = {"card": card, "torch": torch.__version__,
           "positions": positions(torch.device("cuda"), boat, args.reps,
                                  args.graph)}
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        dest = Path(args.out)
        dest.mkdir(parents=True, exist_ok=True)
        (dest / "decode_after_encode.json").write_text(
            line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
