"""Captured CUDA graphs of the encoder's device passes, checked on first
replay.

Counterpart: ``icer_compression_tpu/backend/aot_cache.py``.  The JAX
encoder runs each pass as one compiled program per (geometry, batch,
coder, plane windows), and before a fresh program's first output is
returned it runs the program twice on the caller's inputs and compares
the outputs bit for bit (a mismatch recompiles once, a second raises).
Here a pass is one ``torch.cuda.CUDAGraph`` per key, replayed with one
launch; the key holds every field that fixes the pass's shapes (geometry,
stages, filter, segments, mag_bits, images in the pass, the bucket coders
and their record modes and call sizes, plane windows, lane share, device).

Life of a key.  The dispatch half of a pass (``GraphCache.run``) never
waits for the card:
  - the key's first pass runs eagerly: the warm-up that capture needs (the
    kernels build and load at first use, the lru-cached device tables
    upload), and all that a one-off geometry ever pays;
  - its second pass (and any later one dispatched before the capture)
    runs eagerly too and is marked for capture;
  - once captured, every pass copies its input into the graph's static
    input and replays.
The capture itself is the collector's (``GraphCache.capture``), after the
marked pass's copies to the host are done, where the host waits anyway:
the pass's function is captured on a static copy of its input, the graph
is replayed once, and the replay's outputs must equal the eager pass's bit
for bit.  A mismatch re-captures once; a second mismatch raises
``RuntimeError``.  A capture that fails raises too: no path goes on
eagerly in its place.

Launch counts: the counted kernel wrappers (``kernel_counters``) add to
their ``launches`` in Python for each launch the host issues, which a
replay does not do.  A capture issues none that runs then, so it leaves
those counts as it found them.  How often a kernel ran, replays included,
is counted on the device by the kernel itself (``kernels.device_runs``).

Memory.  A graph keeps its allocations in a private pool for as long as
it lives.  A pass's pool is what the caching allocator reserves for it:
with the allocator's usual fixed segments that is the eager pass's
reserved peak, a fifth or more above its allocated peak (the blocks that
a pass's growing tensors free are too small for its larger ones), and with
expandable segments, whose blocks grow in place, within a few percent of
the allocated peak (chip_smoke.py phase 30 measures both on the 112-image
batch's pass of 37).  So each capture turns expandable segments on, and
then back to the process's own setting.  One pool shared by every graph
grew past one pass (no pass could reuse another's blocks), so each graph
has its own pool, whose bytes are read from the allocator's snapshot
after the capture (``pool_bytes``).  The graphs of a device hold at most
one pass budget (``ops.encode.PASS_PEAK_BYTES``) beyond their static
tensors (``bound``): before a capture the least recently used graphs are
evicted until the new pass's estimate fits beside the rest, and after it
until its measured pool does.

A graph's replay writes only its own pool, so the outputs the host reads
after the dispatch half (``hold``: the coder words a collector re-encodes
flagged lanes from) are copied out only before the next replay of the
same graph; the stream-ordered copies to the host, queued right after a
replay, read theirs first.
"""

from __future__ import annotations

import contextlib
import os
import time
import weakref
from collections import OrderedDict

import torch

CAPTURE_AT = 2            # the pass of a key that is captured


def kernel_counters():
    """The counted kernel wrappers an encode pass may run: (module, name)
    of each function whose ``launches`` it increments."""
    from ..ops import entropy_full as EF
    from ..ops import entropy_slim as ES
    return [(ES, "encode_lanes_slim"), (ES, "encode_lanes_slim_two_word"),
            (EF, "encode_lanes_full"), (EF, "encode_lanes_full_tiled")]


def pass_budget() -> int:
    """Device bytes of one full encode pass, the pass budget
    (``ops.encode.PASS_PEAK_BYTES``)."""
    from ..ops.encode import PASS_PEAK_BYTES
    return PASS_PEAK_BYTES


def _device(device) -> torch.device:
    """``device`` with its index: ``cuda`` is the current CUDA device."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _segments(device: torch.device):
    return [s for s in torch.cuda.memory_snapshot()
            if s["device"] == device.index]


def reserved_bytes(device) -> int:
    """Device bytes held by graph pools on ``device`` (the segments of
    every private pool in ``torch.cuda.memory_snapshot``)."""
    return sum(s["total_size"] for s in _segments(_device(device))
               if tuple(s["segment_pool_id"]) != (0, 0))


def pool_bytes(graph, device) -> int:
    """Device bytes of ``graph``'s private pool."""
    want = tuple(graph.pool())
    return sum(s["total_size"] for s in _segments(device)
               if tuple(s["segment_pool_id"]) == want)


def _set_allocator(settings: str) -> None:
    setter = getattr(torch._C, "_accelerator_setAllocatorSettings", None) \
        or torch.cuda.memory._set_allocator_settings
    setter(settings)


@contextlib.contextmanager
def expandable_segments():
    """The caching allocator's expandable segments inside, the process's
    own setting (``PYTORCH_CUDA_ALLOC_CONF``) after."""
    conf = os.environ.get("PYTORCH_CUDA_ALLOC_CONF", "") + "," \
        + os.environ.get("PYTORCH_ALLOC_CONF", "")
    own = "expandable_segments:true" in conf.replace(" ", "").lower()
    _set_allocator("expandable_segments:True")
    try:
        yield
    finally:
        if not own:
            _set_allocator("expandable_segments:False")


def capture_cuda(fn, static_x: torch.Tensor):
    """Capture ``fn(static_x)`` into a CUDA graph with its own pool of
    expandable segments.  Returns (graph, outputs).  A call in this thread
    that capture forbids raises; other threads (a process group's
    watchdog) are not held to it."""
    graph = torch.cuda.CUDAGraph()
    with expandable_segments(), \
            torch.cuda.graph(graph, capture_error_mode="thread_local"):
        outs = tuple(fn(static_x))
    return graph, outs


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


class Held:
    """Device outputs of a pass that the host reads after the dispatch
    half: ``tensors`` until ``release``.  Those of a replay are copied
    out before the next replay of their graph could overwrite them."""

    def __init__(self, tensors):
        self.tensors = list(tensors)

    def release(self) -> None:
        self.tensors = None


class _Entry:
    """One captured pass: the graph, its static input and outputs, the
    bytes of its pool, the outputs of its last replay still held, and the
    encoder whose device tables the graph reads (kept alive with it)."""

    def __init__(self, key, graph, static_x, outs, owner):
        self.key, self.graph = key, graph
        self.static_x, self.outs = static_x, outs
        self.owner = owner
        self.device = static_x.device
        self.nbytes = _nbytes((static_x,) + tuple(outs))
        self.pool = 0
        self.held: weakref.WeakSet = weakref.WeakSet()


class GraphCache:
    """The captured passes of every encoder, by key (least recently used
    first).  ``capture(fn, static_x) -> (graph, outputs)`` records a pass
    (``capture_cuda`` on the card), ``pool(graph, device)`` measures its
    pool (``pool_bytes``), ``counters()`` lists the counted kernel
    wrappers and ``budget`` is one pass's device bytes (None:
    ``pass_budget()``); the tests give stand-ins for all four.
    ``captures`` lists every capture with its seconds, first-replay check
    and pool bytes; ``evictions``, ``replays``, ``snapshots`` and
    ``snapshot_bytes`` count the rest."""

    def __init__(self, capture=capture_cuda, pool=pool_bytes,
                 counters=kernel_counters, budget: int | None = None):
        self._capture = capture
        self._pool = pool
        self._counters = counters
        self.budget = budget
        self._entries: OrderedDict = OrderedDict()
        self._seen: dict = {}
        self.captures: list[dict] = []
        self.evictions = 0
        self.replays = 0
        self.snapshots = 0
        self.snapshot_bytes = 0

    def __contains__(self, key) -> bool:
        return key in self._entries

    def keys(self) -> list:
        return list(self._entries)

    def pool_total(self, device) -> int:
        """Bytes of the pools of ``device``'s graphs."""
        device = _device(device)
        return sum(e.pool for e in self._entries.values()
                   if e.device == device)

    def static_bytes(self, device) -> int:
        """Bytes of the static inputs and outputs of ``device``'s
        graphs."""
        device = _device(device)
        return sum(e.nbytes for e in self._entries.values()
                   if e.device == device)

    def bound(self, device) -> int:
        """The most that ``device``'s graph pools may hold: one pass
        budget beyond their static tensors."""
        budget = pass_budget() if self.budget is None else self.budget
        return budget + self.static_bytes(device)

    def clear(self) -> None:
        """Drop every graph (once the card is done with them) and forget
        every key's passes; ``torch.cuda.empty_cache`` then returns the
        pools to the device."""
        for dev in {e.device for e in self._entries.values()
                    if e.device.type == "cuda"}:
            torch.cuda.synchronize(dev)
        self._entries.clear()
        self._seen.clear()

    def run(self, key, fn, x: torch.Tensor):
        """The dispatch half of the pass ``key`` over ``x``: a replay of
        its graph, else ``fn(x)`` (a tuple of tensors) eagerly.  Returns
        (outputs, state): ``replay`` (the graph's static outputs, valid
        until its next replay; ``hold`` keeps what the host reads later),
        ``eager``, or ``capture``: an eager pass of a key seen
        ``CAPTURE_AT`` times, whose collector calls ``capture``."""
        entry = self._entries.get(key)
        if entry is not None:
            self._entries.move_to_end(key)
            return self._replay(entry, x), "replay"
        seen = self._seen[key] = self._seen.get(key, 0) + 1
        return tuple(fn(x)), "capture" if seen >= CAPTURE_AT else "eager"

    def hold(self, key, tensors) -> Held:
        """Keep ``tensors``, outputs of the last replay of ``key``'s
        graph, readable after its later replays."""
        h = Held(tensors)
        self._entries[key].held.add(h)
        return h

    def capture(self, key, fn, x: torch.Tensor, ref, owner=None,
                estimate: int = 0) -> None:
        """The collector's half of a pass that ``run`` marked ``capture``,
        once its eager outputs ``ref`` are done: capture ``fn`` on a
        static copy of ``x`` and hold the first replay equal to ``ref``
        bit for bit; one re-capture on a mismatch, then ``RuntimeError``.
        ``estimate``: the pass's pool bytes, for the eviction before the
        capture.  Nothing to do if the key was captured since."""
        if key in self._entries:
            return
        device = x.device
        self._evict(device, self._keep(device, estimate))
        for attempt in (1, 2):
            t0 = time.perf_counter()
            entry = self._record(key, fn, x, owner)
            outs = self._replay(entry, x)
            equal = len(outs) == len(ref) and all(
                a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(a, b) for a, b in zip(outs, ref))
            entry.pool = self._pool(entry.graph, entry.device)
            self.captures.append({
                "key": key, "attempt": attempt, "equal": equal,
                "seconds": time.perf_counter() - t0,
                "static_bytes": entry.nbytes, "pool_bytes": entry.pool})
            if equal:
                self._entries[key] = entry
                self._evict(device, self._keep(device), spare=key)
                return
            del entry, outs
        raise RuntimeError(
            f"the captured encode pass {key!r} disagreed with its eager run "
            "on its first replay twice (re-captured once); refusing to "
            "return possibly wrong output")

    def _replay(self, entry: _Entry, x: torch.Tensor):
        # copy out what the host still reads of the last replay, queued
        # on the stream ahead of the one that overwrites it
        for h in list(entry.held):
            if h.tensors is not None:
                h.tensors = [t.clone() for t in h.tensors]
                self.snapshots += 1
                self.snapshot_bytes += _nbytes(h.tensors)
        entry.held = weakref.WeakSet()
        entry.static_x.copy_(x)
        entry.graph.replay()
        self.replays += 1
        return entry.outs

    def _record(self, key, fn, x, owner) -> _Entry:
        """Capture ``fn`` on a static copy of ``x``; the launch counts end
        as they began (a capture runs nothing), whether or not it
        succeeds."""
        counters = self._counters()
        before = [getattr(o, n).launches for o, n in counters]
        static_x = torch.empty_like(x)
        static_x.copy_(x)
        try:
            graph, outs = self._capture(fn, static_x)
        finally:
            for (o, n), b in zip(counters, before):
                getattr(o, n).launches = b
        return _Entry(key, graph, static_x, tuple(outs), owner)

    def _keep(self, device, extra: int = 0) -> int:
        """Pool bytes of ``device``'s graphs beyond their bound, with
        ``extra`` more."""
        device = _device(device)
        return self.pool_total(device) + extra - self.bound(device)

    def _evict(self, device, excess: int, spare=None) -> None:
        """Evict the least recently used graphs of ``device`` (never
        ``spare``) until ``excess`` pool bytes are gone; their pools go
        back to the device."""
        device = _device(device)
        drop = []
        for key, e in self._entries.items():
            if excess <= 0:
                break
            if e.device == device and key != spare:
                drop.append(key)
                excess -= e.pool - e.nbytes
        if not drop:
            return
        if device.type == "cuda":
            # a replay of an evicted graph may still be running
            torch.cuda.synchronize(device)
        for key in drop:
            del self._entries[key]
        self.evictions += len(drop)
        if device.type == "cuda":
            torch.cuda.empty_cache()


CACHE = GraphCache()
