"""% of the decode requests' time (the union of their intervals) with none
of the window's device work running."""

from benchmark import readers


def read(run):
    return readers.idle_share_of(run, "request.decode")
