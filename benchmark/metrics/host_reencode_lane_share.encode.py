"""% of the real lanes coded (count ``encode.lanes``) that the collectors
re-encoded on the host (count ``encode.host_reencode_lanes``)."""

from benchmark import program_trace


def read(run):
    return program_trace.count_share(run, "encode.host_reencode_lanes",
                                     "encode.lanes")
