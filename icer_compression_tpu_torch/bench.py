"""Headline benchmark of the port: 512x512 grayscale lossless encode +
decode throughput.

Counterpart: ``bench.py`` at the repository root (the JAX package's), with
its configuration: boat 512, lossless (quota w * h), stages 4, filter A,
6 segments.  Modes, each verified while it is timed:

  native          the native host runtime (``backend="native"``), single
                  image, best of ``--reps``;
  <dev>           the card path, single image: ``models/grayscale.compress``
                  and ``decompress`` on ``--device``, best of
                  ``--reps-card``, after a warm-up that includes the
                  kernels' first-use build and check;
  <dev>_batched   ``--batch-enc`` noisy variants of the image through one
                  encoder (``make_encoder`` -> ``encode_batch`` ->
                  ``allocate_streams``, in device passes of its coder's
                  share of ``ops.encode.PASS_WORDS``), decoded by
                  ``models/decode.decompress_batch`` in chunks of
                  ``--batch`` (each decode pass a captured graph per plan
                  key once its key repeats); peak device memory, and the
                  bytes the captured graphs' pools hold beside it, all of
                  them and the decode passes';
  <dev>_pipelined ``--pipe`` batches in a row through
                  ``encode_batch(defer=True)`` and
                  ``decompress_batch(defer=True)``, each batch dispatched
                  before the one before it is collected (so two are on
                  the card at once, as in the root bench), each dispatch half
                  under ``torch.cuda.set_sync_debug_mode("error")`` on the
                  card; the decode at ``--batch`` and at half of it, the
                  best verified one kept; peak device memory and the
                  graphs' pools, as above;
  device_time     ``torch.profiler`` (CPU and CUDA) over the batched
                  mode's encode of ``--batch-enc`` images and decode of
                  ``--batch`` streams, their passes replayed as captured
                  graphs (``encode_graph``, ``decode_graph``), each device
                  record put in its layer (``utils/trace``: a replay's
                  records by stage mark, the rest by the program's span
                  around their launch): per image the device's busy ms
                  (the union of kernel and copy intervals), idle share,
                  device and API launches and each layer's device ms,
                  launches and host ms, and the program's counts; the
                  ceiling MP/s, pixels / (encode + decode busy time per
                  image).  Card only: a CPU run reports it as not
                  measured.

Every stream must equal the native one (and ``tests/data/golden_boat512
.sha256`` for boat), the batch's first stream the single-image stream, and
every decode its input.  Prints one JSON line with the root bench's keys
(``metric``, ``value``: the best verified mode's MP/s, ``unit``,
``vs_baseline`` against the C reference's 1.186 MP/s, ``detail``: each
mode and the device).  A mode that raises ends the run with its error; a
mode that fails verification is printed with its flags and the run exits
1.  Without a card it exits 2 unless ``--device cpu`` is given.

    python -m icer_compression_tpu_torch.bench [--reps 15] [--reps-card 5]
        [--batch 56] [--batch-enc 112] [--pipe 4] [--device cuda|cpu]
        [--image PATH]
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from .backend import graph_cache
from .device import resolve_device
from .models import decode as D
from .models import grayscale as T
from .ops import entropy_slim as ES
from .utils.image_io import load_image
from .utils.trace import layer_breakdown

REPO = Path(__file__).resolve().parents[1]
BOAT = REPO / "tests" / "data" / "boat.512.png"
GOLDEN = REPO / "tests" / "data" / "golden_boat512.sha256"
# the C reference on one core: 0.102 s encode + 0.119 s decode of boat 512
# (BASELINE.md)
BASELINE_MPS = (512 * 512) / (0.102 + 0.119) / 1e6


def best(fn, reps: int) -> float:
    """The least wall of ``reps`` calls of fn(), in seconds (fn returns
    host data, so each call ends with the card done)."""
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return min(ts)


def noisy_variants(image: np.ndarray, n: int) -> np.ndarray:
    """The root bench's batch: ``n`` variants of ``image`` with noise of
    +-6 (``default_rng(0)``), clipped to 8 bits, the first the image
    itself."""
    rng = np.random.default_rng(0)
    imgs = np.stack([np.clip(image.astype(np.int32)
                             + rng.integers(-6, 7, image.shape), 0, 255)
                     .astype(np.uint16) for _ in range(n)])
    imgs[0] = image
    return imgs


@contextlib.contextmanager
def no_host_sync(dev: torch.device):
    """On the card, any host synchronisation inside the block raises."""
    if dev.type != "cuda":
        yield
        return
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)


@contextlib.contextmanager
def peak_memory(dev: torch.device, out: dict):
    """``out`` receives the peak allocated device bytes inside the block,
    the bytes allocated before it and the bytes the captured graphs'
    pools hold after it, all of them and the decode passes' (None on the
    CPU).  A replay runs in its graph's pool, reserved at the capture, so
    a block that replays graphs captured before it peaks below what it
    holds on the device."""
    if dev.type != "cuda":
        yield
        out.update(peak_allocated_bytes=None, base_allocated_bytes=None,
                   graph_pool_bytes=None, decode_graph_pool_bytes=None)
        return
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    yield
    torch.cuda.synchronize(dev)
    out.update(peak_allocated_bytes=torch.cuda.max_memory_allocated(dev),
               base_allocated_bytes=base,
               graph_pool_bytes=graph_cache.reserved_bytes(dev),
               decode_graph_pool_bytes=graph_cache.CACHE.pool_total(
                   dev, "decode"))


def device_info(dev: torch.device) -> dict:
    """The device the card modes ran on: name, power limit (as
    ``nvidia-smi --query-gpu=name,power.limit`` gives it) and count."""
    if dev.type != "cuda":
        return {"type": "cpu", "name": None, "nvidia_smi": None, "count": 0}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    return {"type": "cuda", "name": torch.cuda.get_device_name(dev),
            "nvidia_smi": smi, "count": torch.cuda.device_count(),
            "total_memory_bytes":
                torch.cuda.get_device_properties(dev).total_memory}


def native_mode(image, cfg, reps, golden):
    """The native host runtime, single image."""
    stream = T.compress(image, cfg, backend="native")
    dec = T.decompress(stream, cfg, dtype=np.uint16, backend="native")
    enc_s = best(lambda: T.compress(image, cfg, backend="native"), reps)
    dec_s = best(lambda: T.decompress(stream, cfg, dtype=np.uint16,
                                      backend="native"), reps)
    sha = hashlib.sha256(stream).hexdigest()
    res = {"encode_s": enc_s, "decode_s": dec_s,
           "MPs": image.size / (enc_s + dec_s) / 1e6,
           "stream_matches_reference": None if golden is None
           else sha == golden,
           "lossless_roundtrip": bool(np.array_equal(dec, image))}
    res["verified"] = res["stream_matches_reference"] is not False \
        and res["lossless_roundtrip"]
    return stream, res


def single_mode(image, cfg, dev, reps, golden, native_stream, warm):
    """The card path, single image; ``warm`` receives the first calls'
    walls.  ``k1_launches`` counts kernel 1's launches per instance in one
    encode (the plain versions on the CPU count none)."""
    ES.encode_lanes_slim.launches = 0
    ES.encode_lanes_slim_two_word.launches = 0
    t0 = time.perf_counter()
    stream = T.compress(image, cfg, device=dev)
    warm["single_encode"] = time.perf_counter() - t0
    k1 = {"fused-key": ES.encode_lanes_slim.launches,
          "two-word": ES.encode_lanes_slim_two_word.launches}
    t0 = time.perf_counter()
    dec = T.decompress(stream, cfg, dtype=np.uint16, device=dev)
    warm["single_decode"] = time.perf_counter() - t0
    enc_s = best(lambda: T.compress(image, cfg, device=dev), reps)
    dec_s = best(lambda: T.decompress(stream, cfg, dtype=np.uint16,
                                      device=dev), reps)
    sha = hashlib.sha256(stream).hexdigest()
    res = {"encode_s": enc_s, "decode_s": dec_s,
           "MPs": image.size / (enc_s + dec_s) / 1e6,
           "stream_matches_reference": None if golden is None
           else sha == golden,
           "stream_matches_native": stream == native_stream,
           "lossless_roundtrip": bool(np.array_equal(dec, image)),
           "warmup_s": warm["single_encode"] + warm["single_decode"],
           "entropy_backend": "auto", "k1_launches": k1}
    res["verified"] = res["stream_matches_reference"] is not False \
        and res["stream_matches_native"] and res["lossless_roundtrip"]
    return stream, res


def batched_mode(imgs, cfg, dev, B, reps, single_stream, warm):
    """``len(imgs)`` images through one encoder, decoded ``B`` at a time.
    Returns (encoder, streams, the mode's entry)."""
    BE, h, w = imgs.shape
    enc = T.make_encoder(w, h, cfg, imgs.dtype, device=dev)

    def encode_all():
        return T.allocate_streams(enc.encode_batch(imgs), cfg, enc)

    def decode(streams):
        return D.decompress_batch(streams, cfg, dtype=np.uint16, device=dev)

    mem_e, mem_d = {}, {}
    t0 = time.perf_counter()
    with peak_memory(dev, mem_e):
        streams = encode_all()
    warm["batched_encode"] = time.perf_counter() - t0
    ok = streams[0] == single_stream
    t0 = time.perf_counter()
    with peak_memory(dev, mem_d):
        decs = decode(streams[:B])
    warm["batched_decode"] = time.perf_counter() - t0
    for c0 in range(0, BE, B):
        if c0:
            decs = decode(streams[c0:c0 + B])
        ok = ok and all(np.array_equal(d, i)
                        for d, i in zip(decs, imgs[c0:c0 + B]))
    benc = best(encode_all, max(2, reps - 2))
    bdec = best(lambda: decode(streams[:B]), max(2, reps - 2))
    px = h * w
    res = {"B": B, "B_enc": BE, "encode_s": benc, "decode_s": bdec,
           "encode_passes": -(-BE // enc.pass_images),
           "pass_images": enc.pass_images,
           "MPs": px / (benc / BE + bdec / B) / 1e6,
           "encode_MPs": px * BE / benc / 1e6,
           "decode_MPs": px * B / bdec / 1e6,
           "encode_peak_allocated_bytes": mem_e["peak_allocated_bytes"],
           "encode_graph_pool_bytes": mem_e["graph_pool_bytes"],
           "decode_peak_allocated_bytes": mem_d["peak_allocated_bytes"],
           "decode_graph_pool_bytes": mem_d["decode_graph_pool_bytes"],
           "base_allocated_bytes": mem_e["base_allocated_bytes"],
           "per_image_verified": bool(ok)}
    res["verified"] = res["per_image_verified"]
    return enc, streams, res


def pipelined_mode(imgs, cfg, dev, enc, streams, B, K, batched_ok):
    """``K`` batches through the deferred collectors: each batch's
    dispatch is queued before the previous one is collected, so at most
    two batches hold device memory at once."""
    BE, h, w = imgs.shape

    def encode_pipe():
        out, hold = [], None
        for _ in range(K):
            with no_host_sync(dev):
                nxt = enc.encode_batch(imgs, defer=True)
            if hold is not None:
                out.extend(T.allocate_streams(hold(), cfg, enc))
            hold = nxt
        out.extend(T.allocate_streams(hold(), cfg, enc))
        return out

    def make_decode_pipe(bd):
        def decode_pipe():
            out, hold = [], None
            for _ in range(K):
                with no_host_sync(dev):
                    nxt = D.decompress_batch(streams[:bd], cfg,
                                             dtype=np.uint16, device=dev,
                                             defer=True)
                if hold is not None:
                    out.extend(hold())
                hold = nxt
            out.extend(hold())
            return out
        return decode_pipe

    mem_e, mem_d = {}, {}
    with peak_memory(dev, mem_e):
        pstreams = encode_pipe()
    pok_e = batched_ok and pstreams == streams * K
    penc = best(encode_pipe, 2) / (K * BE)
    dec_bs = [B] + ([B // 2] if B % 2 == 0 and B // 2 >= 2 else [])
    runs = {}
    for bd in dec_bs:
        dp = make_decode_pipe(bd)
        with peak_memory(dev, mem_d.setdefault(bd, {})):
            decs = dp()
        vok = all(np.array_equal(d, i)
                  for d, i in zip(decs, list(imgs[:bd]) * K))
        runs[bd] = (best(dp, 2) / (K * bd), vok)
    good = [(t, bd) for bd, (t, v) in runs.items() if v]
    bd_best = min(good)[1] if good else B
    pdec, pok_d = runs[bd_best]
    res = {"B": bd_best, "B_enc": BE, "batches_in_flight": K,
           "encode_s_per_img": penc, "decode_s_per_img": pdec,
           "decode_variants_ms_per_img": {str(bd): 1e3 * t
                                          for bd, (t, _v) in runs.items()},
           "MPs": h * w / (penc + pdec) / 1e6,
           "encode_peak_allocated_bytes": mem_e["peak_allocated_bytes"],
           "encode_graph_pool_bytes": mem_e["graph_pool_bytes"],
           "decode_peak_allocated_bytes": mem_d[B]["peak_allocated_bytes"],
           "decode_graph_pool_bytes": mem_d[B]["decode_graph_pool_bytes"],
           "per_image_verified": bool(pok_e and pok_d)}
    res["verified"] = res["per_image_verified"]
    return res


def device_time_mode(imgs, cfg, dev, enc, streams, B) -> dict:
    """One encode of ``imgs`` through ``enc`` and one decode of ``B`` of
    its streams, whose passes are captured graphs by now, each under
    ``torch.profiler`` by layer (``utils/trace.layer_breakdown``)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    BE, h, w = imgs.shape
    torch.cuda.synchronize(dev)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    def events_of(prof):
        # read before the next profiler starts: it clears these events
        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / "trace.json"
            prof.export_chrome_trace(str(path))
            return json.loads(path.read_text())["traceEvents"]

    halves = (("encode graph", BE, lambda: T.allocate_streams(
                  enc.encode_batch(imgs), cfg, enc)),
              ("decode graph", B, lambda: D.decompress_batch(
                  streams[:B], cfg, dtype=np.uint16, device=dev)))
    res, got = {}, {}
    for half, n, fn in halves:
        # each in a profile of its own: the encode's 28,000 kernel records
        # would crowd the decode's out of one
        with profile(activities=acts) as prof:
            with record_function(half):
                got[half] = fn()
            torch.cuda.synchronize(dev)
        r = layer_breakdown(events_of(prof), half)
        res[half.replace(" ", "_")] = {
            "images": n, "wall_ms": r["wall_ms"],
            "busy_ms": r["busy_ms"], "idle_share": r["idle_share"],
            "launches": r["launches"], "api_launches": r["api_launches"],
            "host_gap_us": r["host_gap_us"],
            "per_image": {"wall_ms": r["wall_ms"] / n,
                          "busy_ms": r["busy_ms"] / n,
                          "launches": r["launches"] / n,
                          "api_launches": r["api_launches"] / n},
            "layers": {k: {"device_ms": g["device_ms"],
                           "launches": g["launches"],
                           "host_ms": g["host_ms"],
                           "device_ms_per_image": g["device_ms"] / n,
                           "launches_per_image": g["launches"] / n,
                           "host_ms_per_image": g["host_ms"] / n}
                       for k, g in r["layers"].items()},
            "counts": r["counts"], "unmarked": r["unmarked"]}
    if got["encode graph"] != streams or not all(
            np.array_equal(g, i)
            for g, i in zip(got["decode graph"], imgs[:B])):
        raise AssertionError("the traced batch differs from the batched "
                             "mode's")
    res["combined_MPs_ceiling"] = h * w / (
        (res["encode_graph"]["per_image"]["busy_ms"]
         + res["decode_graph"]["per_image"]["busy_ms"]) / 1e3) / 1e6
    res["note"] = ("torch.profiler, CPU and CUDA traced: one batched encode "
                   f"of {BE} and a decode of {B} through the captured "
                   "graphs, by layer (a replay's records by stage mark, the "
                   "rest by program span); busy = union of kernel and copy "
                   "intervals; the profiler slows the host")
    return res


def run(image: np.ndarray, cfg, device, reps: int = 15, reps_card: int = 5,
        batch: int = 56, batch_enc: int = 112, pipe: int = 4,
        golden: str | None = None) -> dict:
    """Every mode on ``image`` under ``cfg``; the result dict that the
    program prints.  ``golden`` is the stream's expected sha256 (None: not
    pinned).  ``detail["all_verified"]`` says whether every mode passed
    its checks."""
    image = np.asarray(image, np.uint16)
    dev = resolve_device(device)
    B = batch
    BE = batch_enc if batch_enc >= B and batch_enc % B == 0 else B
    detail: dict = {"device": device_info(dev)}
    warm: dict = {}
    native_stream, detail["native"] = native_mode(image, cfg, reps, golden)
    detail["stream_bytes"] = len(native_stream)
    stream, detail[dev.type] = single_mode(image, cfg, dev, reps_card,
                                           golden, native_stream, warm)
    imgs = noisy_variants(image, BE)
    enc, streams, detail[f"{dev.type}_batched"] = batched_mode(
        imgs, cfg, dev, B, reps_card, stream, warm)
    detail["warmup_breakdown_s"] = warm
    if pipe > 1:
        detail[f"{dev.type}_pipelined"] = pipelined_mode(
            imgs, cfg, dev, enc, streams, B, pipe,
            detail[f"{dev.type}_batched"]["verified"])
    detail["device_time"] = (
        device_time_mode(imgs, cfg, dev, enc, streams, B)
        if dev.type == "cuda" else "not measured: no card (device cpu)")
    modes = {name: m for name, m in detail.items()
             if isinstance(m, dict) and "verified" in m}
    detail["all_verified"] = all(m["verified"] for m in modes.values())
    mps, mode = max(((m["MPs"], name) for name, m in modes.items()
                     if m["verified"]), default=(0.0, "none"))
    h, w = image.shape
    return {
        "metric": (f"MP/s encode+decode, {w}x{h} grayscale lossless "
                   f"(stages={cfg.stages}, filter {'ABCDEFQ'[cfg.filt]}, "
                   f"{cfg.segments} segments), bit-exact vs lib_icer; best "
                   f"mode: {mode}"),
        "value": mps,
        "unit": "MP/s",
        "vs_baseline": mps / BASELINE_MPS,
        "detail": detail}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m icer_compression_tpu_torch.bench",
        description="Encode + decode throughput of the port, boat 512 "
                    "lossless, s4 fA g6.")
    ap.add_argument("--reps", type=int, default=15,
                    help="native host runtime: best of this many")
    ap.add_argument("--reps-card", type=int, default=5,
                    help="card single image: best of this many")
    ap.add_argument("--batch", type=int, default=56,
                    help="decode batch (B_dec)")
    ap.add_argument("--batch-enc", type=int, default=112,
                    help="encode batch (B_enc), a multiple of --batch")
    ap.add_argument("--pipe", type=int, default=4,
                    help="batches in flight in the pipelined mode")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--image", default=str(BOAT),
                    help="8-bit image (read as grayscale)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("bench: no CUDA device (pass --device cpu for a host run)",
              file=sys.stderr)
        return 2
    image = load_image(args.image, force_color=False)[0].astype(np.uint16)
    h, w = image.shape
    golden = None
    if Path(args.image).resolve() == BOAT.resolve() and GOLDEN.exists():
        golden = GOLDEN.read_text().split()[0]
    cfg = T.CodecConfig(stages=4, filt=0, segments=6, byte_quota=h * w)
    result = run(image, cfg, args.device, args.reps, args.reps_card,
                 args.batch, args.batch_enc, args.pipe, golden)
    print(json.dumps(result), flush=True)
    return 0 if result["detail"]["all_verified"] else 1


if __name__ == "__main__":
    sys.exit(main())
