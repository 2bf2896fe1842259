"""Decode passes captured as CUDA graphs in the traced window
(``graph_cache.CACHE.captures``, decode keys)."""


def read(run):
    return run.counters.get("decode_captures")
