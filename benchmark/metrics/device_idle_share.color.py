"""% of the traced window with no kernel, copy or set that the window
launched running on the device."""

from benchmark import readers


def read(run):
    return readers.idle_share(run)
