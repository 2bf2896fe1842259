"""Kernel 2's share of its roofline: ``roofline.k2_bound`` of the streams
decoded in the traced window over its records' device time, %."""

from benchmark import readers


def read(run):
    return readers.k2_roofline_share(run)
