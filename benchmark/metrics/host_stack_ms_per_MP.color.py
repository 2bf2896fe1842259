"""Host ms of checking and ordering the colour planes into the batch's
canvases (``icer.color.stack`` in ``models/color.compress_yuv_batch``,
outside nested program spans) per frame MP encoded: the program's own
span (``program_trace``)."""

from benchmark import program_trace, readers


def read(run):
    secs = program_trace.self_seconds(run, "color.stack")
    mp = run.frame_mp(readers.ENCODE)
    if secs is None or not mp:
        return None
    return 1e3 * secs / mp
