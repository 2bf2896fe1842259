"""Host ms in ``models/decode.plan_batch`` per MP decoded: the harness's
span around each call."""

from benchmark import readers


def read(run):
    return readers.span_ms_per_mp(run, "plan_batch", readers.DECODE)
