"""The frames the cells encode, made from the seed.

Content: boat 512 (``data/boat.512.u8``, the image of lib_icer's
examples) tiled to the frame and given noise of +-``noise`` grey levels,
clipped to 8 bits and held in ``uint16``: rover frames are companded to
8 bits before ICER.  The recipe is chip_smoke.py's ``_tiled`` and
``long_lane_images`` (chip_smoke.py:356-389), with the generator seeded
from the run's seed instead of 0.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

BOAT = Path(__file__).resolve().parent / "data" / "boat.512.u8"


def boat() -> np.ndarray:
    return np.fromfile(BOAT, dtype=np.uint8).reshape(512, 512)


def tiled(h: int, w: int) -> np.ndarray:
    """Boat tiled to (h, w), int32."""
    b = boat()
    return np.tile(b, (-(-h // b.shape[0]), -(-w // b.shape[1])))[
        :h, :w].astype(np.int32)


def noisy(base: np.ndarray, rng: np.random.Generator,
          noise: int) -> np.ndarray:
    """One variant: ``base`` plus noise in [-noise, noise], 8-bit."""
    return np.clip(base + rng.integers(-noise, noise + 1, base.shape,
                                       dtype=np.int32),
                   0, 255).astype(np.uint16)


def pool(config: dict, seed: int, n: int) -> np.ndarray:
    """``n`` distinct frames of ``config`` from ``seed``: (n, h, w)."""
    base = tiled(config["height"], config["width"])
    rng = np.random.default_rng([seed, 0])
    out = np.empty((n, config["height"], config["width"]), np.uint16)
    for i in range(n):
        out[i] = noisy(base, rng, config["noise"])
    return out


def fresh(config: dict, seed: int, index: int,
          base: np.ndarray | None = None) -> np.ndarray:
    """Frame ``index`` of a stream of fresh frames from ``seed``."""
    if base is None:
        base = tiled(config["height"], config["width"])
    return noisy(base, np.random.default_rng([seed, 1, index]),
                 config["noise"])
