"""Device ms of the sort-and-pack stages (each from its stage mark to the
next) over the window's device passes, eager or replayed, per frame MP
encoded (a frame's three canvases together)."""

from benchmark import program_trace, readers


def read(run):
    return program_trace.stage_ms_per_mp(run, "sort_pack",
                                         run.frame_mp(readers.ENCODE))
