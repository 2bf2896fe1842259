"""% of the decode passes through the graph cache that replayed a
captured graph (count ``graph.replay.decode``) rather than ran eagerly
(``graph.eager.decode``)."""

from benchmark import program_trace


def read(run):
    return program_trace.count_share(
        run, "graph.replay.decode",
        ("graph.replay.decode", "graph.eager.decode"))
