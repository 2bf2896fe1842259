"""Mean host ms in ``models/decode.plan_batch`` per decode request: the
harness's span around each call."""

from benchmark import readers


def read(run):
    return readers.span_ms_per_request(run, "plan_batch", readers.DECODE)
