#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``icer_compression_tpu_torch``).

Run from the repository root on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py

It builds both CUDA kernels from ``icer_compression_tpu_torch/csrc`` (one
``nvcc`` per source, in parallel, into ``build/``), then:

  1. holds kernel 1 (slim encode coder) bit-equal to its plain PyTorch
     version on boat 512's stage-1 emission words and on a noisy block
     that overflows the eviction side buffer;
  2. holds kernel 2 (multi-round plane decoder) bit-equal to its plain
     version on a crop of boat, lossless and at a truncating quota;
  3. drives the main path: boat 512 lossless (stages 4, filter A, 6
     segments) must hash to tests/data/golden_boat512.sha256 and decode to
     the input; quota 50,000 must match tests/data/golden_boat512_q50000
     .sha256 for the stream and the decoded pixels; both kernels must have
     launched;
  4. encodes and decodes a batch of 8 noisy variants of boat, pixel-exact;
  5. times encode, decode and each kernel (CUDA events) beside its bound.

Any failure raises and exits non-zero.  The line before the last is a
JSON object {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.  Without a CUDA device it exits non-zero
and prints no result.
"""

from __future__ import annotations

import hashlib
import json
import statistics
import struct
import subprocess
import sys
import time
import zlib
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3 (data sheet)
# int32 ALU peak: 64 int32 ops per clock per SM x 132 SMs x 1.98 GHz boost
# (Hopper architecture white paper)
INT32_OPS_PER_S = 64 * 132 * 1.98e9
# integer operations of one step, counted from the kernels' source:
# kernel 1: 16 cutoff compares + ~32 for counters, bin state, completion
# and the record per valid emission, + a 17-row scan per allocation;
# kernel 2: ~60 per decoded pixel (neighbour contexts, bin, stack).
K1_OPS_PER_VALID = 48
K1_OPS_PER_ALLOC = 34
K2_OPS_PER_PIXEL = 60


def log(msg: str) -> None:
    print(msg, flush=True)


def read_png_gray8(path: Path) -> np.ndarray:
    """8-bit grayscale, non-interlaced PNG -> (h, w) uint8."""
    data = path.read_bytes()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path} is not a PNG file")
    i, idat, hdr = 8, [], None
    while i < len(data):
        n, kind = struct.unpack(">I4s", data[i:i + 8])
        body = data[i + 8:i + 8 + n]
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        i += 12 + n
    w, h, depth, ctype, _c, _f, interlace = hdr
    if (depth, ctype, interlace) != (8, 0, 0):
        raise ValueError("only 8-bit grayscale non-interlaced PNGs")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(h, w + 1).astype(np.int32)
    out = np.zeros((h, w), np.int32)
    prev = np.zeros(w, np.int32)
    for y in range(h):
        f, line = raw[y, 0], raw[y, 1:]
        if f == 0:
            cur = line.copy()
        elif f == 1:
            cur = np.cumsum(line) & 255
        elif f == 2:
            cur = (line + prev) & 255
        else:
            cur = np.zeros(w, np.int32)
            for x in range(w):
                a = cur[x - 1] if x else 0
                b = prev[x]
                if f == 3:
                    pred = (a + b) >> 1
                else:
                    c = prev[x - 1] if x else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (
                        b if pb <= pc else c)
                cur[x] = (line[x] + pred) & 255
        out[y] = cur
        prev = cur
    return out.astype(np.uint8)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def sync_time(fn):
    """(result, seconds) of fn(), synchronised on both ends."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def event_ms(fn, reps: int = 5, warm: int = 1) -> float:
    """Median device time of fn() in ms (CUDA events, after warm-up)."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def assert_equal(name, a, b) -> int:
    """Bit-equality of two int tensors; returns the max abs difference."""
    err = int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) \
        if a.numel() else 0
    if a.shape != b.shape or err != 0:
        raise AssertionError(f"{name}: kernel and plain version differ "
                             f"(shapes {tuple(a.shape)} {tuple(b.shape)}, "
                             f"max abs diff {err})")
    return err


def noisy_eviction_words(rng, L=16384, lanes=32, warm=3072, feed=144):
    """Skewed contexts warmed up into many bins, then uncoded emissions
    with one zero fed to each context in turn every 16 * ``feed`` steps:
    each feed opens a codeword that the reorder window evicts later, so
    lanes collect more than the 32-row side buffer holds."""
    p = np.exp(rng.uniform(np.log(0.003), np.log(0.2), (16, lanes)))
    ctx = np.full((L, lanes), 17)
    bit = rng.integers(0, 2, (L, lanes))
    wc = rng.integers(0, 16, (warm, lanes))
    ctx[:warm] = wc
    bit[:warm] = rng.random((warm, lanes)) < p[wc, np.arange(lanes)]
    t = np.arange(L - warm)[:, None]
    fed = (t % feed) == 0
    ctx[warm:] = np.where(fed, (t // feed) % 16, 17)
    bit[warm:] = np.where(fed, 0, bit[warm:])
    return torch.from_numpy((1 | (ctx << 1) | (bit << 6)).astype(np.int32))


def bound(nbytes: int, ops: int):
    """(least time in ms, "bytes" or "operations") for work that must move
    ``nbytes`` through HBM and do ``ops`` int32 operations."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / INT32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def k1_bound(words, misc):
    """Kernel 1: words in, records out, state rows out; ops from this
    run's valid emissions and allocations."""
    L, lanes = words.shape
    nbytes = 4 * (2 * L * lanes + (17 + 8 + 32) * lanes)
    ops = (K1_OPS_PER_VALID * int((words & 1).sum())
           + K1_OPS_PER_ALLOC * int(misc[1].sum()))
    return bound(nbytes, ops)


def k2_bound(unit, pos):
    """Kernel 2: the payload bytes the lanes consumed, the plan rows in,
    the canvas and flags out; ops from the pixels of the rounds run."""
    R, n = unit["offs"].shape
    p = pos.cpu().numpy().astype(np.int64)
    nbytes = (int(((p + 7) // 8).sum()) + 4 * (2 * R * n + 4 * n)
              + 4 * (unit["hmax"] * unit["wmax"] * n + n + R * n))
    area = unit["geom"][0].astype(np.int64) * unit["geom"][1]
    ops = K2_OPS_PER_PIXEL * int(((p > 0) * area).sum())
    return bound(nbytes, ops)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from icer_compression_tpu_torch import kernels
    from icer_compression_tpu_torch.models import decode as D
    from icer_compression_tpu_torch.models import grayscale as T
    from icer_compression_tpu_torch.ops import entropy_slim as ES
    from icer_compression_tpu_torch.ops import plane_decode as PDc

    dev = torch.device("cuda")
    card = gpu_line()
    log(f"device: {torch.cuda.get_device_name(0)} | {card} | torch "
        f"{torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    per_src = kernels.build_all()
    build_s = time.perf_counter() - t0
    for name in kernels.KERNELS:
        kernels.load(name)
    log(f"build: {build_s:.2f} s wall, per source "
        f"{ {k: round(v, 2) for k, v in per_src.items()} }")

    data = REPO / "tests" / "data"
    boat = read_png_gray8(data / "boat.512.png").astype(np.uint16)
    golden = (data / "golden_boat512.sha256").read_text().split()[0]
    pins = [ln.split()[0] for ln in
            (data / "golden_boat512_q50000.sha256").read_text().splitlines()]
    h, w = boat.shape
    cfg = T.CodecConfig(stages=4, filt=0, segments=6, byte_quota=h * w)
    cfg50 = T.CodecConfig(stages=4, filt=0, segments=6, byte_quota=50000)

    # ---- phase 1: kernel 1 vs its plain version ------------------------
    enc = T.make_encoder(w, h, cfg, np.uint16, dev)
    x = torch.as_tensor(boat.astype(np.int32)[None], device=dev)
    img, _ll, _ov = enc.transform(x)
    emitted = [enc.emit(g, img) for g in enc.groups]
    bucket_words = [enc.bucket_words(b, emitted).t().contiguous()
                    for b in enc.buckets]
    w1 = bucket_words[0]
    k1 = ES.encode_lanes_slim(w1)
    p1, plain_s = sync_time(lambda: ES.encode_lanes_slim_plain(w1))
    k1_err = 0
    for nm, a, b in zip(("rec", "fstate", "misc", "ev"), k1, p1):
        k1_err = max(k1_err, assert_equal(f"K1 boat {nm}", a, b))
    log(f"K1 boat stage-1 block {tuple(w1.shape)}: bit-equal to plain "
        f"(tolerance 0); "
        f"evictions max {int(k1[2][2].max())}, lanes evicting "
        f"{int((k1[2][2] > 0).sum())}, plain {plain_s:.1f} s")
    nw = noisy_eviction_words(np.random.default_rng(7)).to(dev)
    kn = ES.encode_lanes_slim(nw)
    pn = ES.encode_lanes_slim_plain(nw)
    for nm, a, b in zip(("rec", "fstate", "misc", "ev"), kn, pn):
        k1_err = max(k1_err, assert_equal(f"K1 noisy {nm}", a, b))
    if not (int(kn[2][2].max()) > ES.NEV and bool((kn[2][0] != 0).any())):
        raise AssertionError("noisy block did not overflow the side buffer")
    log(f"K1 noisy block {tuple(nw.shape)}: bit-equal to plain; evictions "
        f"max {int(kn[2][2].max())}, lanes flagged "
        f"{int((kn[2][0] != 0).sum())}")

    # ---- phase 2: kernel 2 vs its plain version ------------------------
    crop = np.ascontiguousarray(boat[200:296, 180:276])
    k2_err = 0
    for q in (None, 3000):
        ccfg = T.CodecConfig(4, 0, 6, q)
        s = T.compress(crop, ccfg, device=dev)
        _cw, _ch, _lls, blob, units = D.plan_batch([s], ccfg, np.uint16)
        st = torch.as_tensor(blob, device=dev)
        for u in units:
            args = [torch.as_tensor(u[k], device=dev)
                    for k in ("offs", "ebits", "lane_end", "geom")]
            ko = PDc.decode_planes(st, *args, u["hmax"], u["wmax"], 8, 15)
            po = PDc.decode_planes_plain(st, *args, u["hmax"], u["wmax"], 8,
                                         15)
            for nm, a, b in zip(("out", "err", "pos"), ko, po):
                k2_err = max(k2_err, assert_equal(f"K2 crop q{q} {nm}", a, b))
        dec = T.decompress(s, ccfg, dtype=np.uint16, device=dev)
        if q is None and not np.array_equal(dec, crop):
            raise AssertionError("crop lossless round trip differs")
        log(f"K2 crop 96x96 quota {q} ({len(s)} B, {len(units)} launches): "
            "out/err/pos bit-equal to plain")

    # ---- phase 3: main path --------------------------------------------
    ES.encode_lanes_slim.launches = 0
    PDc.decode_planes.launches = 0
    menc = T.make_encoder(w, h, cfg, np.uint16, dev)
    stream = T.compress_batch(boat[None], cfg, encoder=menc)[0]
    out = T.decompress(stream, cfg, dtype=np.uint16, device=dev)
    launches = {"slim_encode": ES.encode_lanes_slim.launches,
                "plane_decode": PDc.decode_planes.launches}
    sha = hashlib.sha256(stream).hexdigest()
    if sha != golden:
        raise AssertionError(f"boat lossless sha {sha} != golden {golden}")
    if not np.array_equal(out, boat):
        raise AssertionError("boat lossless decode differs from the input")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel did not launch: {launches}")
    log(f"main path boat 512 lossless: {len(stream)} B sha {sha[:16]}... == "
        f"golden, decode pixel-exact; launches {launches}; host re-encode "
        f"lanes {menc.fallback_lanes}")
    s50 = T.compress(boat, cfg50, device=dev)
    d50 = T.decompress(s50, cfg50, dtype=np.uint16, device=dev)
    sha50 = hashlib.sha256(s50).hexdigest()
    psha = hashlib.sha256(np.ascontiguousarray(d50, "<u2").tobytes()) \
        .hexdigest()
    if [sha50, psha] != pins:
        raise AssertionError(f"quota 50000: {sha50} / {psha} != pins {pins}")
    log(f"main path boat 512 quota 50000: {len(s50)} B stream and decoded "
        "pixels match the pins")

    # ---- phase 4: a batch of requests ----------------------------------
    rng = np.random.default_rng(1234)
    batch = np.clip(boat[None].astype(np.int32)
                    + rng.integers(-6, 7, (8, h, w)), 0, 255).astype(np.uint16)
    bcfg = T.CodecConfig(4, 0, 6, None)
    streams, enc_s = sync_time(
        lambda: T.compress_batch(batch, bcfg, device=dev))
    decs, dec_s = sync_time(
        lambda: D.decompress_batch(streams, bcfg, np.uint16, device=dev))
    for i in range(len(batch)):
        if not np.array_equal(decs[i], batch[i]):
            raise AssertionError(f"batch image {i} round trip differs")
    if streams[0] != T.compress(batch[0], bcfg, device=dev):
        raise AssertionError("batched stream differs from the single encode")
    log(f"batch of 8 noisy variants: all round trips pixel-exact; "
        f"{sum(map(len, streams))} B; encode {enc_s:.3f} s, decode "
        f"{dec_s:.3f} s ({8 * h * w / (enc_s + dec_s) / 1e6:.3f} MP/s)")

    # ---- phase 5: timings ----------------------------------------------
    enc_t, dec_t = [], []
    for _ in range(5):
        _s, t_e = sync_time(lambda: T.compress(boat, cfg, device=dev))
        _d, t_d = sync_time(
            lambda: T.decompress(stream, cfg, dtype=np.uint16, device=dev))
        enc_t.append(t_e)
        dec_t.append(t_d)
    enc_med, dec_med = statistics.median(enc_t), statistics.median(dec_t)
    log(f"boat 512 lossless wall (median of 5): encode {1e3 * enc_med:.1f} "
        f"ms, decode {1e3 * dec_med:.1f} ms, "
        f"{h * w / (enc_med + dec_med) / 1e6:.4f} MP/s | {card}")

    k1_ms = [event_ms(lambda bw=bw: ES.encode_lanes_slim(bw))
             for bw in bucket_words]
    k1_bounds = [k1_bound(bw, ES.encode_lanes_slim(bw)[2])
                 for bw in bucket_words]
    _cw, _ch, _ll2, blob, units = D.plan_batch([stream], cfg, np.uint16)
    st = torch.as_tensor(blob, device=dev)
    k2_ms, k2_bounds, k2_args = [], [], []
    for u in units:
        args = [torch.as_tensor(u[k], device=dev)
                for k in ("offs", "ebits", "lane_end", "geom")]
        k2_args.append(args)
        k2_ms.append(event_ms(lambda a=args, u=u: PDc.decode_planes(
            st, *a, u["hmax"], u["wmax"], 8, 15)))
        pos = PDc.decode_planes(st, *args, u["hmax"], u["wmax"], 8, 15)[2]
        k2_bounds.append(k2_bound(u, pos))
    small = min(range(len(units)),
                key=lambda i: units[i]["hmax"] * units[i]["wmax"])
    us = units[small]
    po, k2_plain_s = sync_time(lambda: PDc.decode_planes_plain(
        st, *k2_args[small], us["hmax"], us["wmax"], 8, 15))
    ko = PDc.decode_planes(st, *k2_args[small], us["hmax"], us["wmax"], 8, 15)
    for nm, a, b in zip(("out", "err", "pos"), ko, po):
        k2_err = max(k2_err, assert_equal(f"K2 boat stage-4 {nm}", a, b))
    log(f"K2 boat 512 stage-4 launch: out/err/pos bit-equal to plain "
        f"(tolerance 0), plain {k2_plain_s:.1f} s")
    for i, u in enumerate(units):
        log(f"K2 launch {i}: {u['offs'].shape[1]} lanes, canvas "
            f"{u['hmax']}x{u['wmax']}, {u['offs'].shape[0]} rounds: "
            f"{k2_ms[i]:.3f} ms (bound {k2_bounds[i][0]:.4f} ms, "
            f"{k2_bounds[i][1]})")
    for i, bw in enumerate(bucket_words):
        log(f"K1 launch {i}: {tuple(bw.shape)}: {k1_ms[i]:.3f} ms "
            f"(bound {k1_bounds[i][0]:.4f} ms, {k1_bounds[i][1]})")

    kern = [
        {"name": "slim_encode", "route": "cuda",
         "source": "icer_compression_tpu_torch/csrc/slim_encode.cu",
         "replaces": "icer_compression_tpu/ops/pallas_entropy.py:744",
         "launches": launches["slim_encode"], "max_abs_err": k1_err,
         "equal_to_plain": True,
         "shape": f"L={w1.shape[0]} lanes={w1.shape[1]} (boat stage-1)",
         "ms": k1_ms[0], "plain_ms": 1e3 * plain_s,
         "bound_ms": k1_bounds[0][0], "bound_by": k1_bounds[0][1],
         "library_ms": None, "ms_per_image": sum(k1_ms),
         "bound_ms_per_image": sum(b[0] for b in k1_bounds)},
        {"name": "plane_decode", "route": "cuda",
         "source": "icer_compression_tpu_torch/csrc/plane_decode.cu",
         "replaces": "icer_compression_tpu/ops/pallas_decode.py:99",
         "launches": launches["plane_decode"], "max_abs_err": k2_err,
         "equal_to_plain": True,
         "shape": f"lanes={us['offs'].shape[1]} canvas={us['hmax']}x"
                  f"{us['wmax']} rounds={us['offs'].shape[0]} "
                  "(boat stage-4)",
         "ms": k2_ms[small], "plain_ms": 1e3 * k2_plain_s,
         "bound_ms": k2_bounds[small][0], "bound_by": k2_bounds[small][1],
         "library_ms": None, "ms_per_image": sum(k2_ms),
         "bound_ms_per_image": sum(b[0] for b in k2_bounds)},
    ]
    log(f"build_seconds {build_s:.2f}; encode_ms {1e3 * enc_med:.2f}; "
        f"decode_ms {1e3 * dec_med:.2f}")
    log(card)
    log(json.dumps({"kernels": kern}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
