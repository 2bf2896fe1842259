"""% of the real lanes the colour batch coded (count ``encode.lanes``,
three canvases a frame) that its collectors re-encoded on the host (count
``encode.host_reencode_lanes``)."""

from benchmark import program_trace


def read(run):
    return program_trace.count_share(run, "encode.host_reencode_lanes",
                                     "encode.lanes")
