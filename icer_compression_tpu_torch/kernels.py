"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``.  Builds
run at first use into ``build/`` beside the package (named by a hash of the
source and of the shared headers ``csrc/*.cuh``, so an edited source or
header rebuilds); ``build_all`` starts one ``nvcc`` per source, all at
once, and keeps each compiler log (``-Xptxas -v``: registers, shared
memory and spills per kernel) in ``BUILD_LOGS``.  A fresh library passes a
first-use check (``kernel_check``: every kernel it holds against its plain
version on a small fixed input) before it takes its final name, so only
checked libraries are ever found in ``build/``.  Nothing is built or
imported from CUDA when the module is imported.

Every kernel (``RUN_SLOTS``) also counts its own runs on the device:
block 0's thread 0 adds one to the kernel's slot of the device's
``run_counters`` as the kernel starts (sort and pack, three kernels a
launch, in its last).  A launch that a CUDA graph
recorded runs at each replay without any Python, so these counts, and not
the wrappers' ``launches`` (one per launch the host issues), say how often
such a kernel ran.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent.parent / "build"
KERNELS = ("slim_encode", "slim_pack", "plane_decode", "full_encode",
           "wavelet", "stage_mark", "context_model")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_LOGS: dict[str, str] = {}
GUARD: dict[str, dict] = {}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "",
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def lib_path(name: str) -> Path:
    """The library of ``csrc/<name>.cu``, named by a hash of the source and
    of every header in ``csrc/``."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.name.encode() + b"\0" + hdr.read_bytes())
    return BUILD / f"{name}-{h.hexdigest()[:12]}.so"


def _compile(name: str, out: Path) -> subprocess.Popen:
    """Start ``nvcc`` on ``csrc/<name>.cu``, writing the library to
    ``out``."""
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _open(path: Path) -> ctypes.CDLL:
    return ctypes.CDLL(str(path))


def _finish(name: str, proc: subprocess.Popen, tmp: Path) -> str | None:
    """Wait for a compile; returns its error, or None."""
    log, _ = proc.communicate()
    BUILD_LOGS[name] = log
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        return f"nvcc failed for {name}.cu:\n{log}"
    return None


def _first_use_check(name: str, tmp: Path) -> tuple[str, ...]:
    """Load a fresh build from its temporary path and hold every kernel
    instance it holds equal to its plain version (``kernel_check``).
    Returns the instances checked; on a mismatch the library is dropped
    and ``kernel_check.KernelMismatch`` raised."""
    from . import kernel_check
    _LIBS[name] = _open(tmp)
    try:
        return kernel_check.check_library(name)
    except BaseException:
        del _LIBS[name]
        raise


def _check_or_rebuild(name: str, tmp: Path, retry: Path):
    """The first-use check of the build at ``tmp``; on a mismatch, one
    rebuild into ``retry`` and its check.  Returns (instances, rebuilt)."""
    from .kernel_check import KernelMismatch
    try:
        return _first_use_check(name, tmp), False
    except KernelMismatch as first:
        tmp.unlink(missing_ok=True)
        err = _finish(name, _compile(name, retry), retry)
        if err:
            raise RuntimeError(err) from first
        try:
            return _first_use_check(name, retry), True
        except KernelMismatch as second:
            raise RuntimeError(
                f"fresh build of {name}.cu failed its first-use check twice "
                f"(rebuilt once): {second}") from first


def build_all(names=KERNELS) -> dict[str, float]:
    """Compile every missing kernel library, one nvcc per source in
    parallel, and check each fresh build before it takes its final name.

    The first-use check runs every kernel instance of the library once on
    a small fixed input against its plain version (``kernel_check``); a
    build that fails it is rebuilt once and checked again, and a second
    failure raises ``RuntimeError`` naming the kernel, the output and the
    first differing index.  So a library under its final name has always
    passed, and a cached one is not checked again.  ``GUARD`` keeps each
    check's seconds, instances and whether it rebuilt.  Returns {name:
    seconds} of the compiles."""
    todo = [n for n in names if not lib_path(n).exists()]
    if not todo:
        return {}
    BUILD.mkdir(parents=True, exist_ok=True)

    def tmp_path(name, attempt):
        return lib_path(name).with_suffix(f".{os.getpid()}.{attempt}.tmp")

    t0 = {n: time.perf_counter() for n in todo}
    procs = {n: _compile(n, tmp_path(n, 0)) for n in todo}
    secs = {}
    errors = []
    for name in todo:
        err = _finish(name, procs[name], tmp_path(name, 0))
        secs[name] = time.perf_counter() - t0[name]
        if err:
            errors.append(err)
    if errors:
        for name in todo:
            tmp_path(name, 0).unlink(missing_ok=True)
        raise RuntimeError("\n".join(errors))
    for name in todo:
        tmp, retry = tmp_path(name, 0), tmp_path(name, 1)
        t = time.perf_counter()
        try:
            instances, rebuilt = _check_or_rebuild(name, tmp, retry)
        except BaseException:
            tmp.unlink(missing_ok=True)
            retry.unlink(missing_ok=True)
            raise
        os.replace(retry if rebuilt else tmp, lib_path(name))
        GUARD[name] = {"seconds": time.perf_counter() - t,
                       "instances": instances, "rebuilt": rebuilt}
    return secs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all((name,))    # a fresh build leaves its checked handle
        lib = _LIBS[name] = _LIBS.get(name) or _open(lib_path(name))
    return lib


def check(status: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch function."""
    if status != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {status}")


# the kernels that count their runs on the device, each its slot
RUN_SLOTS = ("slim_encode", "slim_encode_two_word", "full_encode",
             "full_encode_tiled", "plane_decode", "plane_decode_seeded",
             "wavelet_inverse", "slim_pack", "slim_pack_two_word",
             "context_model")


def _device(device) -> str:
    """``device`` as the name of its counters: ``cuda`` with its index."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return str(device)


@functools.lru_cache(maxsize=None)
def _counters(device: str) -> torch.Tensor:
    return torch.zeros(len(RUN_SLOTS), dtype=torch.int64, device=device)


def run_counters(device) -> torch.Tensor:
    """The run counts of ``RUN_SLOTS`` on ``device``, int64, made at the
    first launch (an eager one: a pass is captured only after it ran
    eagerly) and kept for the process."""
    return _counters(_device(device))


def run_slot(device, name: str) -> int:
    """The device address of kernel ``name``'s run count on ``device``."""
    t = run_counters(device)
    return t.data_ptr() + RUN_SLOTS.index(name) * t.element_size()


def device_runs(device) -> dict[str, int]:
    """{kernel: runs on ``device`` since the last ``reset_runs``}; waits
    for the device."""
    return dict(zip(RUN_SLOTS, run_counters(device).tolist()))


def reset_runs(device) -> None:
    """Set ``device``'s run counts to 0 (queued on its current stream)."""
    run_counters(device).zero_()
