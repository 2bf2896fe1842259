"""95th percentile (nearest rank) of the wall of every decode request of
the window: a call that returns host pixels."""

from benchmark import readers


def read(run):
    return readers.p95_ms(run, readers.DECODE)
