"""Kernel W1's share of its roofline: ``roofline.w1_bound`` of the inverse
DWTs of the traced window over its records' device time, %."""

from benchmark import readers


def read(run):
    return readers.w1_roofline_share(run)
