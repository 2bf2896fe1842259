#!/usr/bin/env python3
"""Time kernel 1's two-word instance with each of its chain levers flipped.

Run from the repository root on a machine with one NVIDIA Hopper card:

    python3 scripts/k1_levers.py [--parent DIR] [--reps N]

It builds kernel 1's source four times with ``nvcc`` (in parallel, into
``build/levers/``): ``csrc/slim_encode.cu`` as the port ships it, and
three copies of it with one chain lever of the two-word kernel changed
by a patch held below (``LEVERS``): every step of a tile visited, not
only the valid ones; no load of the next step's counters ahead; and the
counter word that carries its bin and inversion, as kernel 4 keeps it
(``counts_word`` taken from ``csrc/full_encode.cu``).  A patch that no
longer finds its text in the source stops the script.  With
``--parent`` it also builds that checkout's ``slim_encode.cu`` (an
earlier two-word instance, whose launch takes no side-buffer size and
refuses lanes of 2^17 steps or more).  Each build runs on two stage-1
buckets at the CLI's defaults (s4 fA g6): the 1024x1024 image of
chip_smoke.py phase 20 (87,552 x 162) and the 1600x1200 image of phase
25 (160,256 x 162), in turns (A B C ... then the reverse, ``--reps``
rounds), each launch timed with CUDA events.  Every build's outputs must
equal the port's build's (the parent's what both write: ``shared``),
else it exits 1.  Prints one JSON line per (block, build) with the
median, the spread and ns per step, and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

CSRC = REPO / "icer_compression_tpu_torch" / "csrc"

# (old text, new text) replacements in slim_encode.cu, one list a lever
LEVERS = {
    "without skipping empty steps": [
        ("      uint64_t todo = valid;\n",
         "      uint64_t todo = ~0ull;\n"),
        ("        uint32_t out = 0u;\n",
         "        uint32_t out = 0u;\n        if (w & 1u) {\n"),
        ("        tile[cur] = out;\n",
         "        }\n        tile[cur] = out;\n"),
    ],
    "without the prefetch": [
        ("        const uint32_t zpre = zt[cn];\n", ""),
        ("        z = cn == c ? znew : zpre;\n", "        z = zt[cn];\n"),
    ],
    "with the counter word carrying its bin": [
        ("// A valid step's word with",
         "{counts_word}\n\n// A valid step's word with"),
        ("zt[tid] = tid < 17 ? 4u | 2u << 16 : 2u | 1u << 16;",
         "zt[tid] = tid < 17 ? counts_word(cut, 4, 2)\n"
         "                                   : counts_word(cut, 2, 1);"),
        ("        const bool inv = zc < (tc >> 1);\n"
         "        const int bn = bin_of(cut, (inv ? tc - zc : zc) << 16, "
         "tc);\n"
         "        const uint32_t cb = b ^ (inv ? 1u : 0u);\n",
         "        const int bn = (z >> 25) & 31;\n"
         "        const uint32_t cb = b ^ ((z >> 30) & 1);\n"),
        ("          znew = (uint32_t)tc2 | (uint32_t)zc2 << 16;\n",
         "          znew = counts_word(cut, tc2, zc2);\n"),
    ],
}


def patched(patches) -> str:
    """slim_encode.cu with ``patches`` applied, each to exactly one place."""
    src = (CSRC / "slim_encode.cu").read_text()
    full = (CSRC / "full_encode.cu").read_text()
    start = full.index("__device__ __forceinline__ uint32_t counts_word(")
    counts_word = full[start:full.index("\n}\n", start) + 2]
    for old, new in patches:
        if src.count(old) != 1:
            raise RuntimeError(f"lever patch does not apply: {old!r}")
        src = src.replace(old, new.replace("{counts_word}", counts_word))
    return src


def build(variants: dict) -> dict:
    """{label: source path} -> {label: loaded library}, one nvcc each, all
    started together."""
    from icer_compression_tpu_torch import kernels
    out_dir = REPO / "build" / "levers"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n, (label, src) in enumerate(variants.items()):
        lib = out_dir / f"build{n}.so"
        procs[label] = (lib, subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, f"-I{CSRC}", "-o",
             str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for label, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {label}:\n{log}")
        libs[label] = ctypes.CDLL(str(lib))
    return libs


def launcher(lib, parent: bool):
    """words (L, lanes) -> the outputs of ``lib``'s two-word launch."""
    from icer_compression_tpu_torch import kernels
    from icer_compression_tpu_torch.ops import entropy_slim as ES
    fn = lib.slim_encode_two_word_launch
    fn.restype = ctypes.c_int
    nouts = 6 if parent else 7
    nsizes = 3 if parent else 4
    fn.argtypes = [ctypes.c_void_p] * (nouts + 2) \
        + [ctypes.c_int] * nsizes + [ctypes.c_void_p]

    def run(words):
        L, lanes = words.shape
        nev = ES.NEV if parent else ES.eviction_rows(L)
        rows = [L, L, 17, 8, nev, nev] + ([] if parent else [17])
        outs = [torch.empty((r, lanes), dtype=torch.int32,
                            device=words.device) for r in rows]
        luts = ES.slim_luts(str(words.device))
        sizes = (L, lanes) if parent else (L, lanes, nev)
        status = fn(words.data_ptr(), *(t.data_ptr() for t in outs),
                    luts.data_ptr(), *sizes, ES.LUT_SIZE,
                    torch.cuda.current_stream().cuda_stream)
        kernels.check(status, "slim_encode")
        return outs
    return run


def shared(outs):
    """What an earlier two-word instance writes too: the records, the final
    state, the allocation and eviction counts (not the flag: it flags lanes
    past 32 evictions) and the first 32 side-buffer rows."""
    rec1, rec2, fstate, misc, ev1, ev2 = outs[:6]
    return rec1, rec2, fstate, misc[1:], ev1[:32], ev2[:32]


def blocks(dev) -> dict:
    """The two stage-1 buckets, (L, lanes) int32 on ``dev``."""
    import chip_smoke
    from icer_compression_tpu_torch.models import grayscale as T
    from icer_compression_tpu_torch.utils.image_io import read_png
    boat = read_png(REPO / "tests" / "data" / "boat.512.png").astype(
        np.uint16)
    imgs = {"1024x1024": chip_smoke.long_lane_images(boat)["gray1024"][0],
            "1600x1200": chip_smoke.big_images(boat)["gray1600x1200"][0]}
    out = {}
    for key, img in imgs.items():
        enc = T.make_encoder(img.shape[1], img.shape[0],
                             T.CodecConfig(4, 0, 6, None), np.uint16, dev)
        x = torch.as_tensor(img.astype(np.int32)[None], device=dev)
        em = [enc.emit(g, enc.transform(x)[0]) for g in enc.groups]
        out[key] = enc.bucket_words(enc.buckets[0], em).t().contiguous()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="an earlier checkout whose two-word instance to "
                         "time beside these builds")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k1_levers: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    out_dir = REPO / "build" / "levers"
    out_dir.mkdir(parents=True, exist_ok=True)
    variants = {"port": CSRC / "slim_encode.cu"}
    for n, (label, patches) in enumerate(LEVERS.items()):
        variants[label] = out_dir / f"lever{n}.cu"
        variants[label].write_text(patched(patches))
    if args.parent:
        variants["parent"] = (args.parent / "icer_compression_tpu_torch"
                              / "csrc" / "slim_encode.cu")
    libs = build(variants)
    runs = {label: launcher(libs[label], label == "parent")
            for label in variants}
    dev = torch.device("cuda")
    rc = 0
    for key, words in blocks(dev).items():
        L = words.shape[0]
        names = [n for n in runs if n != "parent" or L < 1 << 17]
        ref = runs["port"](words)
        for n in names:
            got = runs[n](words)
            if n == "parent":
                got, want = shared(got), shared(ref)
            else:
                want = ref
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                print(f"{key}: {n} differs from the port's build",
                      file=sys.stderr)
                rc = 1
        times = {n: [] for n in names}
        for r in range(args.reps):
            for n in (names if r % 2 == 0 else names[::-1]):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                runs[n](words)
                b.record()
                torch.cuda.synchronize()
                times[n].append(a.elapsed_time(b))
        for n in names:
            t = sorted(times[n])
            print(json.dumps({
                "block": f"{key} stage 1", "shape": list(words.shape),
                "valid_share": float((words & 1).float().mean()),
                "build": n, "ms_median": statistics.median(t),
                "ms_min": t[0], "ms_max": t[-1],
                "ns_per_step": 1e6 * statistics.median(t) / L,
                "card": card}))
    print(card)
    return rc


if __name__ == "__main__":
    sys.exit(main())
