"""% of the colour batch's traced idle seconds (no device work running)
under no program span (``icer.*``)."""

from benchmark import program_trace


def read(run):
    return program_trace.idle_unattributed_share(run)
