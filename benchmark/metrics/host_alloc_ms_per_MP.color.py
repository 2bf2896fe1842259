"""Host ms of the colour rate allocation and stream assembly
(``icer.alloc.yuv``, one span an image in
``models/color.compress_yuv_batch`` as its three canvases are collected,
outside nested program spans) per frame MP encoded: the program's own
span (``program_trace``)."""

from benchmark import program_trace, readers


def read(run):
    secs = program_trace.self_seconds(run, "alloc.yuv")
    mp = run.frame_mp(readers.ENCODE)
    if secs is None or not mp:
        return None
    return 1e3 * secs / mp
