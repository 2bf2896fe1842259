"""Batch encode rate: megapixels whose streams were collected to host bytes
in the window, over its seconds (host clock)."""

from benchmark import readers


def read(run):
    return readers.mp_rate(run, readers.ENCODE)
