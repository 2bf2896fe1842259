"""ctypes bindings for the port's native C++ host runtime
(``backend/native/icer_runtime.cpp``).

Counterpart: ``icer_compression_tpu/backend/native_backend.py``, with the
same functions and signatures over the port's own copy of the C++ source:

  * ``encode_emissions_native`` / ``encode_batch_native``: the sequential
    interleaved coder on precomputed emission streams (the encoder's exact
    re-encode of the lanes a coder backend flags, one threaded batch per
    device pass);
  * ``encode_segments_native``: fused context modelling and entropy coding
    of (subband, segment, bitplane) tasks on a transformed image;
  * ``decode_segments_native``: batched segment decoding;
  * ``dwt_native``: the multi-stage integer lifting DWT, in place.

The library builds at first use with ``g++`` into ``build/`` beside the
package, as ``kernels.py`` builds the CUDA kernels.  ``-march=native`` ties
it to the CPU that built it, so its name is a hash of the source, the
flags and the host CPU's model name and feature flags: a ``build/`` reused
on another host builds its own.  It is compiled under a per-process
temporary name and moved into place, so processes that build at once do
not load each other's partial files.  A failed build raises
``RuntimeError`` with the compiler's log; there is no Python fallback
(``backend/sequential.py`` is the plain reference the runtime is held
against).
"""

from __future__ import annotations

import ctypes as ct
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from ..core.status import IcerError, IcerStatus

SRC = Path(__file__).resolve().parent / "native" / "icer_runtime.cpp"
BUILD = Path(__file__).resolve().parents[2] / "build"
CXX = "g++"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
             "-pthread")

_lib = None
_lock = threading.Lock()


class SegTask(ct.Structure):
    _fields_ = [
        ("seg_off", ct.c_int32),
        ("h", ct.c_int32),
        ("w", ct.c_int32),
        ("rowstride", ct.c_int32),
        ("subband", ct.c_int32),
        ("mag_bits", ct.c_int32),
        ("nplanes", ct.c_int32),
        ("_pad", ct.c_int32),
        ("plane_off", ct.c_int64 * 16),
        ("plane_bits", ct.c_int64 * 16),
    ]


class EncTask(ct.Structure):
    _fields_ = [
        ("seg_off", ct.c_int32), ("h", ct.c_int32), ("w", ct.c_int32),
        ("rowstride", ct.c_int32), ("subband", ct.c_int32),
        ("mag_bits", ct.c_int32), ("nplanes", ct.c_int32),
        ("lsb0", ct.c_int32),
    ]


def host_cpu() -> str:
    """The host CPU's model name and feature flags (``/proc/cpuinfo``), which
    decide what ``-march=native`` emits; empty where the file is absent."""
    keep = []
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key = line.split(":", 1)[0].strip()
                if key in ("model name", "flags") and line not in keep:
                    keep.append(line)
                if len(keep) == 2:
                    break
    except OSError:
        pass
    return "".join(keep)


def lib_path() -> Path:
    """The library's path under ``BUILD``, named by a hash of the source,
    the compiler flags and ``host_cpu()``."""
    h = hashlib.sha256(SRC.read_bytes())
    h.update(("\0".join((CXX,) + CXX_FLAGS) + "\0" + host_cpu()).encode())
    return BUILD / f"icer_runtime-{h.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile the library if it is missing; returns its path.  Raises
    ``RuntimeError`` with the compiler's log when ``g++`` fails."""
    out = lib_path()
    if out.exists():
        return out
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [CXX, *CXX_FLAGS, "-o", str(tmp), str(SRC)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"native runtime build failed: {e}") from e
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("native runtime build failed ("
                           f"{' '.join(cmd)}):\n{res.stdout}{res.stderr}")
    os.replace(tmp, out)
    return out


def _declare(lib) -> None:
    i32p = ct.POINTER(ct.c_int32)
    i64p = ct.POINTER(ct.c_int64)
    u8p = ct.POINTER(ct.c_uint8)
    lib.icer_tpu_encode_emissions.restype = ct.c_int64
    lib.icer_tpu_encode_emissions.argtypes = [
        i32p, i32p, i32p, ct.c_int64, u8p, ct.c_int64, i32p]
    lib.icer_tpu_decode_segments.restype = None
    lib.icer_tpu_decode_segments.argtypes = [
        i32p, ct.POINTER(SegTask), ct.c_int64, u8p, ct.c_int64,
        ct.c_int32, i32p]
    lib.icer_tpu_encode_batch.restype = None
    lib.icer_tpu_encode_batch.argtypes = [
        i32p, i32p, i32p, i64p, i64p, ct.c_int64, u8p, ct.c_int64,
        i64p, ct.c_int32]
    lib.icer_tpu_encode_segments.restype = None
    lib.icer_tpu_encode_segments.argtypes = [
        i32p, ct.POINTER(EncTask), ct.c_int64, u8p, ct.c_int64, i64p,
        ct.c_int32]
    for name in ("icer_tpu_dwt_forward", "icer_tpu_dwt_inverse"):
        fn = getattr(lib, name)
        fn.restype = ct.c_int32
        fn.argtypes = [i32p] + [ct.c_int32] * 6


def get_lib():
    """The loaded library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ct.CDLL(str(build()))
            _declare(lib)
            _lib = lib
    return _lib


def _i32(a):
    return np.ascontiguousarray(np.asarray(a).ravel(), dtype=np.int32)


def _ptr(a, ctype):
    return a.ctypes.data_as(ct.POINTER(ctype))


def _threads(nthreads: int) -> int:
    return nthreads if nthreads > 0 else (os.cpu_count() or 1)


def _overflow(what: str):
    return IcerError(IcerStatus.OUTPUT_BUF_TOO_SMALL,
                     f"native {what}: output buffer overflow")


def encode_emissions_native(valid, ctx, bit):
    """Entropy-code one emission stream; returns (payload bytes, bit
    length)."""
    lib = get_lib()
    v, c, b = _i32(valid), _i32(ctx), _i32(bit)
    n = len(v)
    cap = 2 * n + 64  # at most 10 bits per emission, plus the flush
    out = np.empty(cap, dtype=np.uint8)
    fl = ct.c_int32(0)
    nbits = lib.icer_tpu_encode_emissions(
        _ptr(v, ct.c_int32), _ptr(c, ct.c_int32), _ptr(b, ct.c_int32), n,
        _ptr(out, ct.c_uint8), cap, ct.byref(fl))
    if nbits < 0:
        raise _overflow("encode")
    return out[: (nbits + 7) // 8].tobytes(), int(nbits)


def encode_batch_native(valid, ctx, bit, offsets, lengths, nthreads=0):
    """Batched entropy coding over flat emission arrays: task i codes
    ``lengths[i]`` emissions from ``offsets[i]``.  Returns (payloads uint8
    (ntasks, stride), bits int64 (ntasks,)); a task's payload is the first
    ``(bits + 7) // 8`` bytes of its row."""
    lib = get_lib()
    v, c, b = _i32(valid), _i32(ctx), _i32(bit)
    offs = np.ascontiguousarray(offsets, dtype=np.int64)
    lens = np.ascontiguousarray(lengths, dtype=np.int64)
    ntasks = len(offs)
    stride = int(2 * lens.max() + 64) if ntasks else 64
    out = np.empty((ntasks, stride), dtype=np.uint8)
    bits = np.zeros(ntasks, dtype=np.int64)
    lib.icer_tpu_encode_batch(
        _ptr(v, ct.c_int32), _ptr(c, ct.c_int32), _ptr(b, ct.c_int32),
        _ptr(offs, ct.c_int64), _ptr(lens, ct.c_int64), ntasks,
        _ptr(out, ct.c_uint8), stride, _ptr(bits, ct.c_int64),
        _threads(nthreads))
    if (bits < 0).any():
        raise _overflow("batch encode")
    return out, bits


def dwt_native(image: np.ndarray, stages: int, filt: int, mag_bits: int,
               inverse: bool = False, nthreads: int = 0) -> bool:
    """Multi-stage integer lifting DWT of an int32 C-contiguous image, in
    place, threaded over lines.  Returns the overflow flag."""
    lib = get_lib()
    if image.dtype != np.int32 or not image.flags.c_contiguous:
        raise ValueError("image must be a C-contiguous int32 array")
    h, w = image.shape
    fn = lib.icer_tpu_dwt_inverse if inverse else lib.icer_tpu_dwt_forward
    return bool(fn(_ptr(image, ct.c_int32), w, h, stages, filt, mag_bits,
                   _threads(nthreads)))


def encode_segments_native(image: np.ndarray, tasks: list[dict],
                           nplanes: int, nthreads=0):
    """Encode (subband, segment) tasks, ``nplanes`` bitplanes each from
    the task's ``lsb0`` (default 0), from the transformed sign-magnitude
    image (int32, C-contiguous).  Each task dict: seg_off, h, w,
    rowstride, subband, mag_bits[, lsb0].  Returns (payloads uint8
    (ntasks * nplanes, stride), bits (ntasks * nplanes,))."""
    lib = get_lib()
    if image.dtype != np.int32 or not image.flags.c_contiguous:
        raise ValueError("image must be a C-contiguous int32 array")
    n = len(tasks)
    arr = (EncTask * n)()
    max_px = 1
    for i, t in enumerate(tasks):
        s = arr[i]
        s.seg_off = t["seg_off"]
        s.h, s.w = t["h"], t["w"]
        s.rowstride = t["rowstride"]
        s.subband = t["subband"]
        s.mag_bits = t["mag_bits"]
        s.nplanes = nplanes
        s.lsb0 = t.get("lsb0", 0)
        max_px = max(max_px, t["h"] * t["w"])
    stride = 4 * max_px + 64  # two emission slots per pixel, <= 2 B each
    # the coder writes every byte it reports, so the rows start empty
    out = np.empty((n * nplanes, stride), dtype=np.uint8)
    bits = np.zeros(n * nplanes, dtype=np.int64)
    lib.icer_tpu_encode_segments(
        _ptr(image, ct.c_int32), arr, n, _ptr(out, ct.c_uint8), stride,
        _ptr(bits, ct.c_int64), _threads(nthreads))
    if (bits < 0).any():
        raise _overflow("segment encode")
    return out, bits


def decode_segments_native(image: np.ndarray, tasks: list[dict],
                           blob: bytes, nthreads=0) -> np.ndarray:
    """Decode independent segment tasks into ``image`` (int32, in place).
    Each task dict: seg_off, h, w, rowstride, subband, mag_bits, nplanes,
    planes: {lsb: (blob offset in bytes, bit length)}.  Returns the planes
    decoded per task."""
    lib = get_lib()
    if image.dtype != np.int32 or not image.flags.c_contiguous:
        raise ValueError("image must be a C-contiguous int32 array")
    n = len(tasks)
    arr = (SegTask * n)()
    for i, t in enumerate(tasks):
        s = arr[i]
        s.seg_off = t["seg_off"]
        s.h, s.w = t["h"], t["w"]
        s.rowstride = t["rowstride"]
        s.subband = t["subband"]
        s.mag_bits = t["mag_bits"]
        s.nplanes = t["nplanes"]
        for lsb in range(16):
            ent = t["planes"].get(lsb)
            s.plane_off[lsb] = -1 if ent is None else ent[0]
            s.plane_bits[lsb] = 0 if ent is None else ent[1]
    blob_arr = np.frombuffer(blob + b"\x00" * 8, dtype=np.uint8)
    done = np.zeros(n, dtype=np.int32)
    lib.icer_tpu_decode_segments(
        _ptr(image, ct.c_int32), arr, n, _ptr(blob_arr, ct.c_uint8),
        len(blob), _threads(nthreads), _ptr(done, ct.c_int32))
    return done
