"""Image file IO for the CLI: 8-bit grayscale and RGB PNG without Pillow.

Counterpart: ``icer_compression_tpu/utils/image_io.py`` (``load_image``,
``save_image``), which reads and writes every format through Pillow.  The
port's CLI must run where Pillow is not installed, so it reads and writes
8-bit grayscale and RGB non-interlaced PNG itself (``zlib``, ``struct`` and
numpy; the reader undoes all five row filters, the writer uses filter 0).
Any other format, PNG variants included, goes through Pillow, imported
where it is needed; without Pillow that raises an error naming the format.
The ``load_image`` semantics are the JAX package's: ``force_color``
True/False converts as Pillow's ``convert("RGB")`` / ``convert("L")`` do,
and auto-detection calls an image colour only when its channels differ.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_SAMPLES = {0: 1, 2: 3}     # PNG colour type -> 8-bit samples per pixel


def _png_chunks(data: bytes):
    i = len(PNG_SIGNATURE)
    while i + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[i:i + 8])
        yield kind, data[i + 8:i + 8 + n]
        if kind == b"IEND":
            return
        i += 12 + n


def _png_layout(data: bytes):
    """(w, h, samples per pixel) of a PNG this module reads itself, None
    for another PNG variant; raises ValueError for no PNG at all."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    kind, body = next(_png_chunks(data), (None, b""))
    if kind != b"IHDR" or len(body) != 13:
        raise ValueError("PNG without an IHDR chunk")
    w, h, depth, ctype, _comp, _filt, interlace = struct.unpack(">IIBBBBB",
                                                                body)
    if depth != 8 or interlace != 0 or ctype not in _SAMPLES:
        return None
    return w, h, _SAMPLES[ctype]


def _unfilter_row(f: int, line: np.ndarray, prev: np.ndarray,
                  bpp: int) -> np.ndarray:
    """One PNG scanline with its filter byte ``f`` undone (int32 bytes)."""
    if f == 0:
        return line
    if f == 1:      # Sub: a running sum per sample channel
        return (np.cumsum(line.reshape(-1, bpp), axis=0) & 255).reshape(-1)
    if f == 2:      # Up
        return (line + prev) & 255
    if f not in (3, 4):
        raise ValueError(f"PNG row filter {f} is not defined")
    # Average and Paeth depend on the byte just restored: a scalar loop
    cur = line.tolist()
    up = prev.tolist()
    for x in range(len(cur)):
        a = cur[x - bpp] if x >= bpp else 0
        b = up[x]
        if f == 3:
            pred = (a + b) >> 1
        else:
            c = up[x - bpp] if x >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[x] = (cur[x] + pred) & 255
    return np.asarray(cur, np.int32)


def decode_png(data: bytes) -> np.ndarray:
    """An 8-bit grayscale or RGB non-interlaced PNG -> (h, w) or (h, w, 3)
    uint8.  Raises ValueError for any other PNG."""
    layout = _png_layout(data)
    if layout is None:
        raise ValueError("only 8-bit grayscale or RGB non-interlaced PNGs "
                         "are read without Pillow")
    w, h, bpp = layout
    idat = b"".join(body for kind, body in _png_chunks(data)
                    if kind == b"IDAT")
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    if raw.size < h * (stride + 1):
        raise ValueError("PNG image data is truncated")
    rows = raw[:h * (stride + 1)].reshape(h, stride + 1).astype(np.int32)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        prev = _unfilter_row(int(rows[y, 0]), rows[y, 1:], prev, bpp)
        out[y] = prev
    return out.reshape(h, w) if bpp == 1 else out.reshape(h, w, bpp)


def read_png(path) -> np.ndarray:
    """``decode_png`` of a file."""
    return decode_png(Path(path).read_bytes())


def _png_chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def write_png(path, arr: np.ndarray) -> None:
    """Write (h, w) or (h, w, 3) uint8 as a PNG, every row filter 0."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype != np.uint8:
        raise ValueError(f"PNG writer takes uint8, not {arr.dtype}")
    if arr.ndim == 2:
        ctype = 0
    elif arr.ndim == 3 and arr.shape[2] == 3:
        ctype = 2
    else:
        raise ValueError(f"PNG writer takes (h, w) or (h, w, 3), not "
                         f"{arr.shape}")
    h, w = arr.shape[:2]
    raw = np.concatenate([np.zeros((h, 1), np.uint8), arr.reshape(h, -1)],
                         axis=1)
    Path(path).write_bytes(
        PNG_SIGNATURE
        + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0,
                                          0))
        + _png_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
        + _png_chunk(b"IEND", b""))


def _pillow(path, what: str):
    """The PIL.Image module, or an error naming what needed it."""
    try:
        from PIL import Image
    except ImportError:
        raise RuntimeError(
            f"{what} needs Pillow, which is not installed; without it the "
            "port reads and writes 8-bit grayscale and RGB PNG only "
            f"({path})") from None
    return Image


def _luma(rgb: np.ndarray) -> np.ndarray:
    """Pillow's ``convert("L")`` of RGB: ITU-R 601-2 luma in 16-bit fixed
    point, rounded."""
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    return ((19595 * r + 38470 * g + 7471 * b + 0x8000) >> 16).astype(
        np.uint8)


def _load_pillow(path, force_color: bool | None):
    """The JAX package's ``load_image``, for formats read through Pillow."""
    Image = _pillow(path, f"reading {_format_name(path)} images")
    im = Image.open(path)
    if force_color is True:
        return np.asarray(im.convert("RGB")), True
    if force_color is False:
        return np.asarray(im.convert("L")), False
    if im.mode in ("L", "I;16", "1"):
        return np.asarray(im.convert("L")), False
    arr = np.asarray(im.convert("RGB"))
    if not (arr[..., 0] == arr[..., 1]).all():
        return arr, True
    return arr[..., 0], False


def _format_name(path) -> str:
    suffix = Path(path).suffix.lstrip(".").upper()
    return suffix or "extension-less"


def load_image(path, force_color: bool | None = None):
    """Load an image file -> (array, is_color): (h, w) uint8 grayscale or
    (h, w, 3) uint8 RGB.  ``force_color`` True/False overrides the
    detection (the reference CLI's -c/-G flags, icer_util.c:126); auto
    treats the image as colour only when its channels differ."""
    data = Path(path).read_bytes()
    if data[:8] != PNG_SIGNATURE or _png_layout(data) is None:
        return _load_pillow(path, force_color)
    arr = decode_png(data)
    if arr.ndim == 2:
        if force_color is True:
            return np.repeat(arr[..., None], 3, axis=2), True
        return arr, False
    if force_color is True:
        return arr, True
    if force_color is False:
        return _luma(arr), False
    if not (arr[..., 0] == arr[..., 1]).all():
        return arr, True
    return np.ascontiguousarray(arr[..., 0]), False


def save_image(path, arr: np.ndarray) -> None:
    """Save (h, w) or (h, w, 3) pixels, clipped to 8 bits; PNG without
    Pillow, other formats through it."""
    arr = np.asarray(arr)
    if arr.dtype != np.uint8:
        arr = np.clip(arr, 0, 255).astype(np.uint8)
    if Path(path).suffix.lower() == ".png":
        write_png(path, arr)
        return
    Image = _pillow(path, f"writing {_format_name(path)} images")
    Image.fromarray(arr).save(path)
