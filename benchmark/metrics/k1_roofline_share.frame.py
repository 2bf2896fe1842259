"""Kernel 1's share of its roofline: ``roofline.k1_bound`` of the frames
encoded in the traced window over its records' device time, %."""

from benchmark import readers


def read(run):
    return readers.k1_roofline_share(run)
