"""Host ms in ``models/grayscale.allocate_streams`` (rate allocation,
stream assembly) per MP encoded: the harness's span around each call."""

from benchmark import readers


def read(run):
    return readers.span_ms_per_mp(run, "allocate_streams", readers.ENCODE)
