"""Megapixels decoded to host pixels in the window, over its seconds (host
clock)."""

from benchmark import readers


def read(run):
    return readers.mp_rate(run, readers.DECODE)
