"""Device memory of the colour batch encode: the allocator's peak over the
window plus the graph pools' bytes
(``backend/graph_cache.reserved_bytes``), GB."""

from benchmark import readers


def read(run):
    return readers.peak_device_gb(run)
