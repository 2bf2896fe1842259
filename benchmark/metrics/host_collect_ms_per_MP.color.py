"""Host ms of the colour batch's encode collectors' checks and table loop
(``icer.encode.collect`` outside nested program spans) plus the host
re-encode of flagged lanes (``icer.encode.host_reencode``), per frame MP
encoded; the per-image ``alloc.yuv`` runs outside ``encode.collect``."""

from benchmark import program_trace, readers


def read(run):
    collect = program_trace.self_seconds(run, "encode.collect")
    mp = run.frame_mp(readers.ENCODE)
    if collect is None or not mp:
        return None
    redo = program_trace.self_seconds(run, "encode.host_reencode") or 0.0
    return 1e3 * (collect + redo) / mp
