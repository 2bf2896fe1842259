"""Captured CUDA graphs of the codec's device passes, checked on first
replay.

Counterparts: ``icer_compression_tpu/backend/aot_cache.py`` and the
jitted decode program of ``icer_compression_tpu/models/decode_jax.py``
(``_run_fused``, one per plan key ``fkey``).  The JAX encoder runs each
pass as one compiled program per (geometry, batch, coder, plane windows),
its decoder one per plan key, and before a fresh program's first output is
returned it runs the program twice on the caller's inputs and compares
the outputs bit for bit (a mismatch recompiles once, a second raises).
Here a pass is one ``torch.cuda.CUDAGraph`` per key, replayed with one
launch; the key holds every field that fixes the pass's shapes (for an
encode pass: geometry, stages, filter, segments, mag_bits, images in the
pass, the bucket coders and their record modes and call sizes, plane
windows, lane share, device; for a decode pass, ``DecodePlan.key`` of
``models/decode.py``: geometry, canvases, the units present with their
rounds, the padded blob, device).  A pass reads one tensor or a
tuple of tensors, its static inputs.

Life of a key.  The dispatch half of a pass (``GraphCache.run``) never
waits for the card:
  - the key's first pass runs eagerly: the warm-up that capture needs (the
    kernels build and load at first use, the lru-cached device tables
    upload), and all that a one-off geometry ever pays;
  - its second pass runs eagerly too and is marked for capture; a key
    has one marked pass at a time, since a marked pass keeps its eager
    outputs until its collector captures (marking every pass dispatched
    before the capture held four colour batches of 56 1600x1200 frames,
    136 eager passes in flight, past an 80 GB card).  Should the marked
    pass's outputs be freed uncaptured (its collector failed before the
    capture, or never ran), the key's next pass is marked;
  - once captured, every pass copies its inputs into the graph's static
    inputs and replays.
The capture itself is the collector's (``GraphCache.capture``), after the
marked pass's copies to the host are done, where the host waits anyway:
the pass's function is captured on a static copy of its inputs, the graph
is replayed once, and the replay's outputs must equal the eager pass's bit
for bit.  A mismatch re-captures once; a second mismatch raises
``RuntimeError``.  A capture that fails raises too: no path goes on
eagerly in its place.  The passes seen per key are kept for the
``SEEN_KEYS`` most recent keys only (decode keys are many: every quota,
fault pattern and blob size is its own), so a key forgotten there starts
again at its first pass.

Tables of a key.  What a pass reads that its key alone fixes (a decode's
canvas index and lane geometry) is made once per key (``owner``) and kept
with the cache's record of the key: with the key's count of passes until
it is captured, with its graph after.  Their device bytes count against
the bound with the pools; eviction drops those of keys not captured
first (least recently used; no sync, the caching allocator keeps them
until the card is done), then graphs, which take theirs along, and
``clear`` drops them all.

Threads.  Two threads may run passes of one key on one card (the
round-robin decode of ``parallel.sharded.decode_batch_sharded``).  Each
cache has a lock (``lock``, re-entrant): ``run``, ``owner``, ``capture``,
eviction and ``clear`` hold it.  A replay's static outputs are read only
by the copies its caller queues right after ``run``, under ``lock``, on
the replay's stream; nothing reads them later.  So the caller holds the
lock around ``run`` and those copies, and no other thread's static copy
or replay comes between; a replay on another stream than the graph's
last one waits for that stream first, and so for the copies queued
there.

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
after the capture (``pool_bytes``).  The graphs of a device, encode and
decode passes alike, hold at most one pass budget
(``ops.encode.PASS_PEAK_BYTES``) beyond their static tensors (``bound``)
in their pools and the keys' tables (``held_bytes``): before a capture
the tables of keys not captured, then the least recently used graphs,
are dropped until the new pass's estimate (from its shapes) fits beside
the rest, and after it until its measured pool does; a key's new tables
drop only the tables of other keys not captured, since the dispatch half
does not wait for the card.

Counts.  Under ``torch.profiler`` (utils/trace) each pass counts
``graph.replay.<kind>`` or ``graph.eager.<kind>``, each capture attempt
``graph.capture.<kind>`` and each eviction ``graph.evict``, ``kind``
being ``decode`` or ``encode`` (``is_decode``); a capture's first replay,
its check, counts as a replay, as ``replays`` does.

No pass holds a replay's outputs past its dispatch half: a decode copies
its pixels back once, at the caller's width, and an encode collector that
re-encodes flagged lanes runs their pass again eagerly (``ops/encode``).
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
import weakref
from collections import OrderedDict

import torch

from ..utils import trace

CAPTURE_AT = 2            # the pass of a key that is captured
SEEN_KEYS = 4096          # keys whose passes are counted, most recent


def kernel_counters():
    """The counted kernel wrappers a pass may run: (module, name) of each
    function whose ``launches`` it increments."""
    from ..ops import entropy_full as EF
    from ..ops import entropy_slim as ES
    from ..ops import plane_decode as PD
    from ..ops import wavelet as WV
    return [(ES, "encode_lanes_slim"), (ES, "encode_lanes_slim_two_word"),
            (ES, "pack_lanes_slim"), (ES, "pack_lanes_slim_two_word"),
            (EF, "encode_lanes_full"), (EF, "encode_lanes_full_tiled"),
            (PD, "decode_planes"), (WV, "inverse_pass")]


def is_decode(key) -> bool:
    """Whether ``key`` is a decode pass's (``models.decode.DecodePlan``)."""
    return type(key) is tuple and len(key) > 0 and key[0] == "decode"


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


def capture_cuda(fn, static_x):
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


def _flat(x) -> tuple:
    """The tensors of a pass's input: ``x`` itself or its members."""
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


def _owned(owner, device: torch.device) -> int:
    """Device bytes of ``owner``'s tables on ``device``: its ``nbytes``,
    where it has them and its ``device`` is ``device``."""
    if owner is None or getattr(owner, "device", None) != device:
        return 0
    return getattr(owner, "nbytes", 0)


def _current_stream(device: torch.device):
    return torch.cuda.current_stream(device) if device.type == "cuda" \
        else None


def _gone():
    return None


class _Seen:
    """A key not captured: the passes seen of it, the object whose device
    tables they read (None: not made, or dropped), and a weak reference
    to the first output of its pass marked for capture (dead: none
    marked, or its outputs freed)."""

    def __init__(self):
        self.passes = 0
        self.owner = None
        self.marked = _gone


class _Entry:
    """One captured pass: the graph, its static inputs and outputs, the
    bytes of its pool, the stream of its last replay, and the object
    whose device tables the graph reads (an encoder, a decode key's
    tables; kept alive with it)."""

    def __init__(self, key, graph, static_x, outs, owner):
        self.key, self.graph = key, graph
        self.static_x, self.outs = static_x, outs
        self.owner = owner
        self.device = _flat(static_x)[0].device
        self.nbytes = _nbytes(_flat(static_x) + tuple(outs))
        self.pool = 0
        self.stream = None


class GraphCache:
    """The captured passes of every encoder and decode plan, by key (least
    recently used first).  ``capture(fn, static_x) -> (graph, outputs)``
    records a pass (``capture_cuda`` on the card), ``pool(graph,
    device)`` measures its pool (``pool_bytes``), ``counters()`` lists
    the counted kernel wrappers and ``budget`` is one pass's device bytes
    (None: ``pass_budget()``); the tests give stand-ins for all four.
    ``captures`` lists every capture with its seconds, first-replay check
    and pool bytes; ``evictions`` and ``replays`` count the rest,
    ``tables_made`` and ``tables_dropped`` the keys' tables.
    ``seen_keys``: the most recent keys whose passes are counted
    (``SEEN_KEYS``)."""

    def __init__(self, capture=capture_cuda, pool=pool_bytes,
                 counters=kernel_counters, budget: int | None = None,
                 seen_keys: int = SEEN_KEYS):
        self._capture = capture
        self._pool = pool
        self._counters = counters
        self.budget = budget
        self.seen_keys = seen_keys
        self.lock = threading.RLock()
        self._entries: OrderedDict = OrderedDict()
        self._seen: OrderedDict = OrderedDict()
        self.captures: list[dict] = []
        self.evictions = 0
        self.replays = 0
        self.tables_made = 0
        self.tables_dropped = 0

    def __contains__(self, key) -> bool:
        return key in self._entries

    def keys(self) -> list:
        return list(self._entries)

    def pool_total(self, device, kind: str | None = None) -> int:
        """Bytes of the pools of ``device``'s graphs: every graph's, or
        only the ``"decode"`` or ``"encode"`` passes'."""
        device = _device(device)
        return sum(e.pool for k, e in list(self._entries.items())
                   if e.device == device
                   and (kind is None or is_decode(k) == (kind == "decode")))

    def static_bytes(self, device) -> int:
        """Bytes of the static inputs and outputs of ``device``'s
        graphs."""
        device = _device(device)
        return sum(e.nbytes for e in self._entries.values()
                   if e.device == device)

    def table_bytes(self, device) -> int:
        """Bytes of the keys' tables on ``device``, captured or not."""
        device = _device(device)
        return sum(_owned(o, device) for o in
                   [e.owner for e in list(self._entries.values())]
                   + [r.owner for r in list(self._seen.values())])

    def held_bytes(self, device) -> int:
        """What the bound holds on ``device``: the graphs' pools and the
        keys' tables."""
        return self.pool_total(device) + self.table_bytes(device)

    def bound(self, device) -> int:
        """The most that ``device``'s graph pools and keys' tables may
        hold: one pass budget beyond the graphs' static tensors."""
        budget = pass_budget() if self.budget is None else self.budget
        return budget + self.static_bytes(device)

    def clear(self) -> None:
        """Drop every graph (once the card is done with them) and forget
        every key's passes; ``torch.cuda.empty_cache`` then returns the
        pools to the device."""
        with self.lock:
            for dev in {e.device for e in self._entries.values()
                        if e.device.type == "cuda"}:
                torch.cuda.synchronize(dev)
            self._entries.clear()
            self._seen.clear()

    def run(self, key, fn, x):
        """The dispatch half of the pass ``key`` over ``x`` (a tensor or a
        tuple of tensors): a replay of its graph, else ``fn(x)`` (a tuple
        of tensors) eagerly.  Returns (outputs, state): ``replay`` (the
        graph's static outputs, valid until its next replay), ``eager``,
        or ``capture``: an eager pass of a key seen ``CAPTURE_AT`` times
        or more, none of whose marked passes still holds its outputs,
        whose collector calls ``capture``."""
        with self.lock:
            entry = self._entries.get(key)
            if entry is not None:
                self._entries.move_to_end(key)
                return self._replay(entry, x), "replay"
            rec = self._record_of(key)
            rec.passes += 1
            trace.count("graph.eager.decode" if is_decode(key)
                        else "graph.eager.encode")
            outs = tuple(fn(x))
            if rec.passes < CAPTURE_AT or rec.marked() is not None:
                return outs, "eager"
            rec.marked = weakref.ref(outs[0])
            return outs, "capture"

    def _record_of(self, key) -> _Seen:
        """The key's record of passes, now the most recent one."""
        rec = self._seen.pop(key, None) or _Seen()
        self._seen[key] = rec
        while len(self._seen) > self.seen_keys:
            self._seen.popitem(last=False)
        return rec

    def owner(self, key, make, device):
        """The object whose tables on ``device`` the passes of ``key``
        read, ``make()`` once per key: the captured graph's owner, else
        the one kept with the key's record (made now if it has none, then
        the tables of other keys not captured are dropped down to the
        bound)."""
        with self.lock:
            entry = self._entries.get(key)
            if entry is not None:
                return entry.owner
            rec = self._record_of(key)
            if rec.owner is None:
                rec.owner = make()
                self.tables_made += 1
                self._evict(device, self._keep(device), spare=key,
                            graphs=False)
            return rec.owner

    def capture(self, key, fn, x, ref, owner=None,
                estimate: int = 0) -> None:
        """The collector's half of a pass that ``run`` marked ``capture``,
        once its eager outputs ``ref`` are done: capture ``fn`` on a
        static copy of ``x`` and hold the first replay equal to ``ref``
        bit for bit; one re-capture on a mismatch, then ``RuntimeError``.
        ``estimate``: the pass's pool bytes, for the eviction before the
        capture.  Nothing to do if the key was captured since."""
        with self.lock:
            self._capture_locked(key, fn, x, ref, owner, estimate)

    def _capture_locked(self, key, fn, x, ref, owner, estimate) -> None:
        if key in self._entries:
            return
        device = _flat(x)[0].device
        self._evict(device, self._keep(device, estimate), spare=key)
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
            trace.count("graph.capture.decode" if is_decode(key)
                        else "graph.capture.encode")
            if equal:
                self._entries[key] = entry
                rec = self._seen.get(key)
                if rec is not None:       # the graph keeps the tables now
                    rec.owner = None
                self._evict(device, self._keep(device), spare=key)
                return
            del entry, outs
        raise RuntimeError(
            f"the captured pass {key!r} disagreed with its eager run on its "
            "first replay twice (re-captured once); refusing to return "
            "possibly wrong output")

    def _replay(self, entry: _Entry, x):
        stream = _current_stream(entry.device)
        if stream is not None and entry.stream is not None \
                and entry.stream != stream:
            # the last replay and the copies queued after it, on another
            # stream, come first
            stream.wait_stream(entry.stream)
        for s, t in zip(_flat(entry.static_x), _flat(x), strict=True):
            s.copy_(t)
        entry.graph.replay()
        entry.stream = stream
        self.replays += 1
        trace.count("graph.replay.decode" if is_decode(entry.key)
                    else "graph.replay.encode")
        return entry.outs

    def _record(self, key, fn, x, owner) -> _Entry:
        """Capture ``fn`` on a static copy of ``x``; the launch counts end
        as they began (a capture runs nothing), whether or not it
        succeeds."""
        counters = self._counters()
        before = [getattr(o, n).launches for o, n in counters]
        static = tuple(torch.empty_like(t).copy_(t) for t in _flat(x))
        static_x = static if isinstance(x, (tuple, list)) else static[0]
        try:
            graph, outs = self._capture(fn, static_x)
        finally:
            for (o, n), b in zip(counters, before):
                getattr(o, n).launches = b
        return _Entry(key, graph, static_x, tuple(outs), owner)

    def _keep(self, device, extra: int = 0) -> int:
        """Bytes of ``device``'s pools and tables beyond their bound, with
        ``extra`` more."""
        device = _device(device)
        return self.held_bytes(device) + extra - self.bound(device)

    def _evict(self, device, excess: int, spare=None,
               graphs: bool = True) -> None:
        """Drop the tables of ``device``'s keys not captured, then (with
        ``graphs``) evict its graphs, least recently used first and never
        ``spare``'s, until ``excess`` bytes are gone; the pools of evicted
        graphs go back to the device."""
        device = _device(device)
        for key, rec in self._seen.items():
            if excess <= 0:
                return
            nbytes = _owned(rec.owner, device)
            if nbytes and key != spare:
                rec.owner = None
                self.tables_dropped += 1
                excess -= nbytes
        drop = []
        for key, e in self._entries.items():
            if excess <= 0 or not graphs:
                break
            if e.device == device and key != spare:
                drop.append(key)
                excess -= e.pool - e.nbytes + _owned(e.owner, device)
        if not drop:
            return
        if device.type == "cuda":
            # a replay of an evicted graph may still be running
            torch.cuda.synchronize(device)
        for key in drop:
            del self._entries[key]
        self.evictions += len(drop)
        trace.count("graph.evict", len(drop))
        if device.type == "cuda":
            torch.cuda.empty_cache()


CACHE = GraphCache()
