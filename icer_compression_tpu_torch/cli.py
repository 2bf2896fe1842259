"""Command-line interface of the port.

Counterpart: ``icer_compression_tpu/cli.py``, itself the reference CLI
(example/src/icer_util.c): compress / decompress with --stages, --filter,
--segments, --size, --color/--grayscale; bitstreams interoperate with the
reference binaries at matching parameters.  Run as
``python -m icer_compression_tpu_torch.cli``.

Beyond the reference: --time for timings, --prefix for a progressive
preview, and the batch operations (batch-compress / batch-decompress: B
same-geometry images per device batch, K batches in flight through the
``defer`` collectors; mixed geometries are bucketed by shape).  --device
picks where the codec runs (``cuda``, the default, or ``cpu`` for the
kernels' plain versions).  --backend picks the compute path of compress
and decompress: ``device`` (the default, on --device), ``native`` (the
native host runtime) or ``numpy`` (the per-plane host encode; the
sequential ``python`` decode), the counterpart of the JAX CLI's
--backend.  A backend that cannot run (no CUDA device, a native runtime
that does not build) raises, so the command exits non-zero; no path
switches to another.
"""

from __future__ import annotations

import argparse
import glob as globmod
import os
import sys
import time

import numpy as np

from .core.constants import FILTER_NAMES
from .core.header import get_image_dimensions
from .models import color as color_model
from .models import grayscale as gray_model
from .models.decode import decompress_batch, decompress_yuv_batch
from .models.grayscale import CodecConfig
from .utils.colorspace import rgb_to_ycbcr, ycbcr_to_rgb
from .utils.image_io import load_image, save_image


def _parse_filter(s: str) -> int:
    s = s.upper()
    if s in FILTER_NAMES:
        return FILTER_NAMES.index(s)
    print(f"Invalid filter type: {s}. Using default filter A.",
          file=sys.stderr)
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="icer-torch",
        description="ICER progressive wavelet image codec on PyTorch/CUDA")
    p.add_argument("operation",
                   choices=["compress", "decompress",
                            "batch-compress", "batch-decompress"])
    p.add_argument("input",
                   help="input file; for batch operations a glob pattern "
                        "or directory of images/streams")
    p.add_argument("output",
                   help="output file; for batch operations an output "
                        "directory")
    p.add_argument("-s", "--stages", type=int, default=4)
    p.add_argument("-f", "--filter", default="A")
    p.add_argument("-g", "--segments", type=int, default=6)
    p.add_argument("-t", "--size", type=int, default=0,
                   help="target compressed size in bytes (0 = lossless "
                        "quota = raw byte count, like the reference CLI)")
    p.add_argument("-c", "--color", action="store_true")
    p.add_argument("-G", "--grayscale", action="store_true")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the device backend runs (default cuda; cpu "
                        "runs the kernels' plain PyTorch versions)")
    p.add_argument("--backend", choices=["device", "native", "numpy"],
                   default="device",
                   help="compress/decompress compute path: device (default; "
                        "the card, or the plain versions with --device "
                        "cpu), native (the native host runtime) or numpy "
                        "(per-plane host encode, sequential python decode). "
                        "native and numpy run on the host and ignore "
                        "--device; batch operations take only device")
    p.add_argument("--time", action="store_true", help="print timings")
    p.add_argument("--prefix", type=int, default=0, metavar="BYTES",
                   help="decompress only the first BYTES of the stream "
                        "(progressive preview: the ICER stream is "
                        "priority-ordered, so any prefix decodes to a "
                        "coarser image; 0 = whole stream)")
    p.add_argument("--batch-size", type=int, default=56, metavar="B",
                   help="batch operations: images per device batch "
                        "(default 56)")
    p.add_argument("--pipeline", type=int, default=4, metavar="K",
                   help="batch operations: device batches kept in "
                        "flight (default 4; 1 disables pipelining)")
    return p


def cmd_compress(args) -> int:
    force = True if args.color else (False if args.grayscale else None)
    arr, is_color = load_image(args.input, force)
    h, w = arr.shape[:2]
    raw = h * w * (3 if is_color else 1)
    quota = args.size if args.size > 0 else raw
    cfg = CodecConfig(stages=args.stages, filt=_parse_filter(args.filter),
                      segments=args.segments, byte_quota=quota)
    t0 = time.time()
    if is_color:
        y, u, v = (c.astype(np.uint16) for c in rgb_to_ycbcr(arr))
        stream = color_model.compress_yuv(y, u, v, cfg, device=args.device,
                                          backend=args.backend)
    else:
        stream = gray_model.compress(arr.astype(np.uint16), cfg,
                                     device=args.device,
                                     backend=args.backend)
    dt = time.time() - t0
    with open(args.output, "wb") as f:
        f.write(stream)
    mode = "color (YUV)" if is_color else "grayscale"
    print(f"compressed {args.input} ({w}x{h}, {mode}) -> "
          f"{len(stream)} bytes ({100.0 * len(stream) / raw:.1f}% of raw)")
    if args.time:
        print(f"encode time: {dt:.3f}s ({w * h / dt / 1e6:.2f} MP/s)")
    return 0


def cmd_decompress(args) -> int:
    if not args.color and not args.grayscale:
        print("error: decompression requires --color or --grayscale",
              file=sys.stderr)
        return 1
    with open(args.input, "rb") as f:
        data = f.read()
    if args.prefix > 0:
        # progressive preview: the rearranged stream is quality-ordered,
        # so truncation degrades exactly like the reference's quota drop
        # (a partial trailing segment is skipped by the CRC scan)
        data = data[:args.prefix]
    if get_image_dimensions(data) is None:
        print("error: no valid segments in stream", file=sys.stderr)
        return 1
    cfg = CodecConfig(stages=args.stages, filt=_parse_filter(args.filter),
                      segments=args.segments)
    backend = "python" if args.backend == "numpy" else args.backend
    t0 = time.time()
    if args.color:
        y, u, v = color_model.decompress_yuv(data, cfg, dtype=np.uint16,
                                             device=args.device,
                                             backend=backend)
        arr = ycbcr_to_rgb(y, u, v)
    else:
        arr = gray_model.decompress(data, cfg, dtype=np.uint16,
                                    device=args.device, backend=backend)
        arr = np.clip(arr, 0, 255).astype(np.uint8)
    dt = time.time() - t0
    save_image(args.output, arr)
    h, w = arr.shape[:2]
    print(f"decompressed {args.input} -> {args.output} ({w}x{h})")
    if args.time:
        print(f"decode time: {dt:.3f}s ({w * h / dt / 1e6:.2f} MP/s)")
    return 0


def _expand_inputs(spec: str, default_glob: str) -> list[str]:
    if os.path.isdir(spec):
        return sorted(globmod.glob(os.path.join(spec, default_glob)))
    return sorted(globmod.glob(spec))


def _pipelined(chunks, submit, finish, K: int) -> None:
    """Dispatch ``submit(chunk)`` for each chunk, keeping at most K
    collectors open, and hand each chunk's collected result to
    ``finish(result, chunk)`` in order."""
    pending: list[tuple] = []
    for chunk in chunks:
        pending.append((submit(chunk), chunk))
        if len(pending) >= K:
            hold, ch = pending.pop(0)
            finish(hold(), ch)
    for hold, ch in pending:
        finish(hold(), ch)


def cmd_batch_compress(args) -> int:
    """Encode a set of images: B same-geometry images per device batch
    with K batches in flight.  Mixed geometries group by shape, each group
    with its own encoder.  With --color the 3B YUV channel canvases of a
    batch encode together (models.color.compress_yuv_batch)."""
    paths = _expand_inputs(args.input, "*.png")
    if not paths:
        print(f"error: no inputs match {args.input}", file=sys.stderr)
        return 1
    os.makedirs(args.output, exist_ok=True)
    B = max(1, args.batch_size)
    K = max(1, args.pipeline)
    filt = _parse_filter(args.filter)
    t0 = time.time()
    groups: dict[tuple, list[tuple[str, np.ndarray]]] = {}
    for path in paths:
        arr, _ = load_image(path, force_color=bool(args.color))
        if args.color:
            planes = np.stack([c.astype(np.uint16)
                               for c in rgb_to_ycbcr(arr)])
        else:
            planes = arr.astype(np.uint16)
        groups.setdefault(planes.shape[-2:], []).append((path, planes))

    total_px = total_bytes = nimg = 0

    def finish(streams, chunk):
        nonlocal total_bytes
        for stream, (path, _im) in zip(streams, chunk):
            stem = os.path.splitext(os.path.basename(path))[0]
            with open(os.path.join(args.output, stem + ".icer"), "wb") as f:
                f.write(stream)
            total_bytes += len(stream)

    nchan = 3 if args.color else 1
    for (h, w), items in groups.items():
        quota = args.size if args.size > 0 else h * w * nchan
        cfg = CodecConfig(stages=args.stages, filt=filt,
                          segments=args.segments, byte_quota=quota)
        if args.color:
            def submit(chunk, cfg=cfg):
                return color_model.compress_yuv_batch(
                    *([im[c] for _, im in chunk] for c in range(3)), cfg,
                    device=args.device, defer=True)
        else:
            enc = gray_model.make_encoder(w, h, cfg, np.uint16,
                                          device=args.device)

            def submit(chunk, cfg=cfg, enc=enc):
                hold = enc.encode_batch([im for _, im in chunk],
                                        defer=True)
                return lambda: gray_model.allocate_streams(hold(), cfg, enc)

        _pipelined([items[i:i + B] for i in range(0, len(items), B)],
                   submit, finish, K)
        total_px += h * w * len(items)
        nimg += len(items)
    dt = time.time() - t0
    kind = "color images" if args.color else "images"
    print(f"batch-compressed {nimg} {kind} -> {args.output} "
          f"({total_bytes} bytes, "
          f"{100.0 * total_bytes / (2 * nchan * total_px):.1f}% of raw)")
    if args.time:
        print(f"encode time: {dt:.3f}s ({total_px / dt / 1e6:.2f} MP/s)")
    return 0


def cmd_batch_decompress(args) -> int:
    """Decode a set of .icer streams into PNGs: the lane-batched decoder
    with K batches in flight.  With --color all 3B channel canvases of a
    batch decode together."""
    paths = _expand_inputs(args.input, "*.icer")
    if not paths:
        print(f"error: no inputs match {args.input}", file=sys.stderr)
        return 1
    os.makedirs(args.output, exist_ok=True)
    B = max(1, args.batch_size)
    K = max(1, args.pipeline)
    cfg = CodecConfig(stages=args.stages, filt=_parse_filter(args.filter),
                      segments=args.segments)
    t0 = time.time()
    groups: dict[tuple, list[tuple[str, bytes]]] = {}
    for path in paths:
        with open(path, "rb") as f:
            data = f.read()
        if args.prefix > 0:
            data = data[:args.prefix]
        dims = get_image_dimensions(data)
        if dims is None:
            print(f"warning: no valid segments in {path}; skipped",
                  file=sys.stderr)
            continue
        groups.setdefault(dims, []).append((path, data))

    decode = decompress_yuv_batch if args.color else decompress_batch

    def submit(chunk):
        return decode([d for _, d in chunk], cfg, dtype=np.uint16,
                      device=args.device, defer=True)

    def finish(imgs, chunk):
        for img, (path, _d) in zip(imgs, chunk):
            if args.color:
                arr = ycbcr_to_rgb(*img)
            else:
                arr = np.clip(img, 0, 255).astype(np.uint8)
            stem = os.path.splitext(os.path.basename(path))[0]
            save_image(os.path.join(args.output, stem + ".png"), arr)

    nimg = total_px = 0
    for (w, h), items in groups.items():
        _pipelined([items[i:i + B] for i in range(0, len(items), B)],
                   submit, finish, K)
        nimg += len(items)
        total_px += w * h * len(items)
    dt = time.time() - t0
    print(f"batch-decompressed {nimg} streams -> {args.output}")
    if args.time:
        print(f"decode time: {dt:.3f}s ({total_px / dt / 1e6:.2f} MP/s)")
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.operation.startswith("batch-") and args.backend != "device":
        print(f"error: --backend {args.backend} runs compress and decompress "
              "only; batch operations run on the device backend",
              file=sys.stderr)
        return 2
    if args.operation == "compress":
        return cmd_compress(args)
    if args.operation == "batch-compress":
        return cmd_batch_compress(args)
    if args.operation == "batch-decompress":
        return cmd_batch_decompress(args)
    return cmd_decompress(args)


if __name__ == "__main__":
    sys.exit(main())
