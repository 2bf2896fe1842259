"""% of the colour batch's encode passes through the graph cache that
replayed a captured graph (count ``graph.replay.encode``) rather than ran
eagerly (``graph.eager.encode``)."""

from benchmark import program_trace


def read(run):
    return program_trace.count_share(
        run, "graph.replay.encode",
        ("graph.replay.encode", "graph.eager.encode"))
