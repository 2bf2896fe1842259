"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``.  Builds
run at first use into ``build/`` beside the package (named by a hash of the
source and of the shared headers ``csrc/*.cuh``, so an edited source or
header rebuilds); ``build_all`` starts one ``nvcc`` per source, all at
once, and keeps each compiler log (``-Xptxas -v``: registers, shared
memory and spills per kernel) in ``BUILD_LOGS``.  Nothing is built or
imported from CUDA when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent.parent / "build"
KERNELS = ("slim_encode", "plane_decode", "full_encode")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_LOGS: dict[str, str] = {}


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


def build_all(names=KERNELS) -> dict[str, float]:
    """Compile every missing kernel library, one nvcc per source in
    parallel.  Returns {name: seconds} for the sources it compiled."""
    BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        nvcc = nvcc or _nvcc()
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    secs = {}
    errors = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        secs[name] = time.perf_counter() - t0
        BUILD_LOGS[name] = log
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return secs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all((name,))
        lib = _LIBS[name] = ctypes.CDLL(str(lib_path(name)))
    return lib


def check(status: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch function."""
    if status != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {status}")
