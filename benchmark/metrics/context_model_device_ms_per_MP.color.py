"""Device ms of the context-model stage (from its stage mark to the next)
over the colour batch's device passes, eager or replayed, per frame MP
encoded (a frame's three canvases count once, as ``encode_MPps`` does)."""

from benchmark import program_trace, readers


def read(run):
    return program_trace.stage_ms_per_mp(run, "context_model",
                                         run.frame_mp(readers.ENCODE))
