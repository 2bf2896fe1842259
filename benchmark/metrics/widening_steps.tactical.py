"""Quota-class widening steps per ``compress_batch`` call (counts
``compress.widenings`` over ``compress.requests``)."""

from benchmark import program_trace


def read(run):
    c = program_trace.counts(run)
    if not c.get("compress.requests"):
        return None
    return c.get("compress.widenings", 0) / c["compress.requests"]
