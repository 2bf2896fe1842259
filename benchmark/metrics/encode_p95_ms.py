"""95th percentile (nearest rank) of the wall of every encode request of
the window: a call that returns host bytes."""

from benchmark import readers


def read(run):
    return readers.p95_ms(run, readers.ENCODE)
