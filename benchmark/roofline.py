"""Bounds of the port's kernels: the least time the card could take for
the work these inputs need, from the bytes they move through HBM and the
int32 operations they do.

Peaks (chip_smoke.py:292-308): HBM 3.35 TB/s (NVIDIA H100 SXM data
sheet); int32 64 operations per clock per SM x 132 SMs x 1.98 GHz boost
(Hopper architecture white paper).  The operations per step are
ESTIMATES counted by hand from the kernels' sources (csrc/slim_encode.cu,
csrc/plane_decode.cu, csrc/wavelet.cu), not measured.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 64 * 132 * 1.98e9
# estimated from the source: kernel 1 does 16 cutoff compares and ~32
# operations for counters, bin state, completion and the record per valid
# emission (chip_smoke.py:296-303)
K1_OPS_PER_VALID = 48
# estimated from the source: kernel 2 ~60 per decoded pixel of a round
K2_OPS_PER_PIXEL = 60
# estimated from the source: kernel W1's operations per restored pair
# (chip_smoke.py:2595-2602)
W1_OPS_PER_STEP = 27

# the kernels by the names the profiler gives them
K1_NAMES = ("slim_encode_kernel", "slim_encode_wide_kernel")
K2_NAMES = ("plane_decode_kernel",)
W1_NAMES = ("inverse_column_pass", "inverse_row_pass")


def bound_seconds(nbytes: float, ops: float) -> float:
    """The least time for ``nbytes`` of HBM traffic and ``ops`` int32
    operations: the larger of the two."""
    return max(nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S)


def k1_bound(pixel_planes: int, nvalid: int) -> float:
    """Kernel 1 over segment planes of ``pixel_planes`` pixels in all with
    ``nvalid`` valid emissions: each of the two emission slots a pixel has
    per plane read once as a word and written once as a record
    (chip_smoke.py:666-679, fused-key mode; the two-word mode writes more,
    so this is the lesser bound), 48 operations per valid emission."""
    slots = 2 * pixel_planes
    return bound_seconds(8 * slots, K1_OPS_PER_VALID * nvalid)


def k2_bound(payload_bytes: int, pixel_planes: int, canvas_px: int) -> float:
    """Kernel 2: the payload bytes read, each decoded canvas written once
    (int32), ~60 operations per pixel per decoded plane
    (chip_smoke.py:682-691)."""
    return bound_seconds(payload_bytes + 4 * canvas_px,
                         K2_OPS_PER_PIXEL * pixel_planes)


def w1_bound(samples: int, pairs: int) -> float:
    """Kernel W1: every sample of every pass read once and written once
    (int32), 27 operations per restored pair (chip_smoke.py:2612-2619)."""
    return bound_seconds(8 * samples, W1_OPS_PER_STEP * pairs)


def inverse_dwt_work(w: int, h: int, stages: int) -> tuple[int, int]:
    """(samples, pairs) of the two passes a stage of an inverse DWT of an
    (h, w) image makes over its low block."""
    samples = pairs = 0
    for s in range(stages):
        lw = -(-w // (1 << s))
        lh = -(-h // (1 << s))
        samples += 2 * lw * lh
        pairs += lh * (lw // 2) + lw * (lh // 2)
    return samples, pairs
