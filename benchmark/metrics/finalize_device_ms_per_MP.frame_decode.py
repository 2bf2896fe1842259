"""Device ms of the decode's finalize stage (canvas gather, LL mean,
inverse DWT, clamp and the pack8 check, from its stage mark to the pass's
end mark) over the window's device passes, per MP decoded."""

from benchmark import program_trace, readers


def read(run):
    return program_trace.stage_ms_per_mp(run, "finalize",
                                         run.frame_mp(readers.DECODE))
