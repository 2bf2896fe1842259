"""% of the traced window's idle seconds (no device work running) under
no program span (``icer.*``)."""

from benchmark import program_trace


def read(run):
    return program_trace.idle_unattributed_share(run)
