"""The load generator: one general generator for every traffic mix.

A traffic file (``traffic/<name>.json``) names a ``mode`` and its
parameters; a configuration file (``configs/<name>.json``) gives the
frame and the codec.  Modes:

- ``encode_batch``: the CLI's batch compress.  Batches of ``batch``
  frames cycled over a seeded pool of ``pool`` frames, each through
  ``encode_batch(defer=True)`` then ``allocate_streams``, at most
  ``inflight`` collectors open (the CLI's ``_pipelined``), closed loop.
- ``compress``: one frame per ``compress`` call, cycled over a pool.
- ``decode_batch``: the CLI's batch decompress of a pool of streams that
  the port encodes in set-up, ``decompress_batch(defer=True,
  pack8=True)``, ``inflight`` collectors open.
- ``tactical``: one request at a time: ``compress_batch(frame[None])``
  (the quota classes) and then ``decompress`` of its stream, every frame
  fresh from (seed, request index) and made outside the timed calls.

Every mode warms the shapes it will use (each graph key captured and
replayed) before the window, runs for ``seconds``, keeps the answers of
the frames it will check, and hands them to ``check``.

A cell brings a mode of its own as a file: a traffic file whose ``mode``
is not one of the above names ``modes/<mode>.py``, whose ``run(run,
seconds, profile, dev)`` keeps the built-in modes' contract (set up and
warm before the window, measure inside ``_window(run, profile, dev)``,
fill ``run.requests``, ``run.answers``, ``run.attempted`` and
``run.answered``, set ``run.check_keys``, return the state to free).  A
mode file that defines ``reference(run, quota, workers, control)``
judges its own answers: ``check.run_check`` takes the expected results
from it instead of the grayscale ``check.reference``, and passes it each
of ``check.CONTROLS``, whose fault it must put in, so that the controls
still fail.  ``modes/__init__.py`` has the contract in full.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import importlib.util
import re
import time
from pathlib import Path

import numpy as np

from . import Failed, frames

# request kinds recorded per mode, for the metrics
ENCODE, DECODE = "encode", "decode"


class Spans:
    """The harness's own spans around calls into the program's layers:
    host-clock intervals by name, and with ``annotate`` a profiler range
    ``bench:<name>`` around each."""

    def __init__(self, annotate: bool):
        self.annotate = annotate
        self.host: dict[str, list] = collections.defaultdict(list)

    @contextlib.contextmanager
    def span(self, name: str):
        if self.annotate:
            from torch.profiler import record_function
            rf = record_function(f"bench:{name}")
        else:
            rf = contextlib.nullcontext()
        t0 = time.perf_counter()
        with rf:
            yield
        self.host[name].append((t0, time.perf_counter()))

    @contextlib.contextmanager
    def wrapped(self, owner, attr: str, name: str):
        """``owner.attr`` timed as span ``name`` inside the block."""
        fn = getattr(owner, attr)

        @functools.wraps(fn)
        def timed(*a, **k):
            with self.span(name):
                return fn(*a, **k)
        setattr(owner, attr, timed)
        try:
            yield
        finally:
            setattr(owner, attr, fn)


class Run:
    """What a run records for the metric readers and the check."""

    def __init__(self, cell, config, traffic, seed, trace):
        self.cell, self.config, self.traffic = cell, config, traffic
        self.seed, self.trace_on = seed, trace
        self.spans = Spans(trace)
        self.requests: list[tuple] = []     # (kind, start, end, MP)
        self.window = (0.0, 0.0)
        self.first_request = None           # host time of the first timed
        self.counters: dict = {}
        self.trace = None                   # tracemath.Trace of the window
        self.encoded_frames: list = []      # frames encoded in the window
        self.decoded_frames: list = []      # frames decoded in the window
        self.answers: list = []             # (frame key, kind, value)
        self.attempted = 0
        self.answered = 0
        self.reference_hook = None          # a mode file's ``reference``

    @property
    def mp(self) -> float:
        return self.config["width"] * self.config["height"] / 1e6

    def frame_mp(self, kind: str) -> float:
        return sum(r[3] for r in self.requests if r[0] == kind)


def codec_config(config: dict, traffic: dict):
    from icer_compression_tpu_torch.models.grayscale import CodecConfig
    w, h = config["width"], config["height"]
    bpp = traffic.get("quota_bpp")
    quota = w * h if bpp is None else int(bpp * w * h) // 8
    return CodecConfig(stages=config["stages"],
                       filt="ABCDEFQ".index(config["filter"]),
                       segments=config["segments"], byte_quota=quota)


def _pipelined(submit, finish, chunks, inflight: int, until=None,
               limit=None):
    """``submit`` each chunk, at most ``inflight`` collectors open, each
    collected result to ``finish`` in order (the CLI's ``_pipelined``).
    With ``until`` (a host time) or ``limit`` (a count) the chunks come
    from the endless iterator ``chunks`` until either is reached."""
    pending = collections.deque()
    n = 0
    for chunk in chunks:
        if until is not None and time.perf_counter() >= until:
            break
        if limit is not None and n >= limit:
            break
        n += 1
        t0 = time.perf_counter()
        pending.append((submit(chunk), chunk, t0))
        if len(pending) >= inflight:
            hold, ch, t0 = pending.popleft()
            finish(hold, ch, t0)
    while pending:
        hold, ch, t0 = pending.popleft()
        finish(hold, ch, t0)


def _cycle(pool_n: int, batch: int):
    """Endless batches of pool indices, cycling over the pool."""
    i = 0
    while True:
        yield [(i + j) % pool_n for j in range(batch)]
        i = (i + batch) % pool_n


def _sync(dev) -> None:
    import torch
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def device_runs(dev) -> dict:
    """The runs each kernel counted on the card (none off it)."""
    import torch
    if torch.device(dev).type != "cuda":
        return {}
    from icer_compression_tpu_torch import kernels
    return kernels.device_runs(dev)


@contextlib.contextmanager
def _window(run, profile, dev):
    """The measured window: the profiler (traced runs) and the harness's
    window range around it."""
    import torch
    _sync(dev)
    run.counters["runs_before"] = device_runs(dev)
    if torch.device(dev).type == "cuda":
        run.counters["reserved_peak_setup"] = torch.cuda.max_memory_reserved(
            dev)
        torch.cuda.reset_peak_memory_stats(dev)
    with profile():
        with run.spans.span("window"):
            t0 = time.perf_counter()
            run.first_request = time.time()
            yield
            _sync(dev)
            run.window = (t0, time.perf_counter())
    run.counters["runs_after"] = device_runs(dev)
    if torch.device(dev).type == "cuda":
        run.counters["peak_allocated_window"] = \
            torch.cuda.max_memory_allocated(dev)
        run.counters["reserved_peak_window"] = \
            torch.cuda.max_memory_reserved(dev)


def run_mode(run, seconds: float, profile, dev, modes_dir: Path):
    """Set up, warm and measure ``run``'s cell; returns the program's
    state to free before the check.  A mode not in ``MODES`` is the
    ``run`` of ``modes_dir/<mode>.py``, whose ``reference``, where it has
    one, becomes ``run.reference_hook``."""
    name = run.traffic["mode"]
    if name in MODES:
        return MODES[name](run, seconds, profile, dev)
    mod = mode_file(name, modes_dir)
    run.reference_hook = getattr(mod, "reference", None)
    return mod.run(run, seconds, profile, dev)


PLAIN_NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


def mode_file(name: str, modes_dir: Path):
    """The module ``modes_dir/<name>.py``, loaded by path (as ``run.reader``
    loads a metric); ``Failed`` for a name that is not a plain file name
    and for a file that is missing."""
    path = Path(modes_dir) / f"{name}.py"
    if not isinstance(name, str) or not PLAIN_NAME.fullmatch(name) \
            or ".." in name:
        raise Failed(f"traffic mode {name!r} is not a plain file name "
                     f"(it would be {path})")
    if not path.is_file():
        raise Failed(f"no traffic mode {name!r}: {path} is missing")
    spec = importlib.util.spec_from_file_location(
        f"benchmark.modes.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if not callable(getattr(mod, "run", None)):
        raise Failed(f"traffic mode {name!r}: {path} defines no run()")
    return mod


def _encode_batch(run, seconds, profile, dev):
    from icer_compression_tpu_torch.models import grayscale as G
    c, t = run.config, run.traffic
    cfg = codec_config(c, t)
    pool = frames.pool(c, run.seed, t["pool"])
    enc = G.make_encoder(c["width"], c["height"], cfg, np.uint16,
                         device=dev)
    B, K = t["batch"], t["inflight"]
    keep = set(_check_keys(run, range(t["pool"])))

    def submit(idx):
        return enc.encode_batch(pool[idx], defer=True)

    def finish_warm(hold, idx, t0):
        G.allocate_streams(hold(), cfg, enc)

    for idx in list(_take(_cycle(t["pool"], B), t["warm_serial"])):
        finish_warm(submit(idx), idx, 0)
    _pipelined(submit, finish_warm, _cycle(t["pool"], B), K,
               limit=t["warm_pipelined"])

    def finish(hold, idx, t0):
        streams = G.allocate_streams(hold(), cfg, enc)
        t1 = time.perf_counter()
        run.requests.append((ENCODE, t0, t1, len(idx) * run.mp))
        run.answered += len(streams)
        run.encoded_frames.extend(idx)
        for i, s in zip(idx, streams):
            run.answers.append((i, "stream", s))

    def submit_counted(idx):
        run.attempted += len(idx)
        return submit(idx)

    with _traced_layers(run, G=G):
        with _window(run, profile, dev):
            _pipelined(submit_counted, finish,
                       _cycle(t["pool"], B), K,
                       until=None if run.trace_on
                       else time.perf_counter() + seconds,
                       limit=t["trace_batches"] if run.trace_on else None)
    run.pool = pool
    run.check_keys = keep
    return [enc]


def _take(it, n):
    for _ in range(n):
        yield next(it)


def _compress(run, seconds, profile, dev):
    from icer_compression_tpu_torch.models import grayscale as G
    c, t = run.config, run.traffic
    cfg = codec_config(c, t)
    pool = frames.pool(c, run.seed, t["pool"])
    for i in range(t["warm"]):
        G.compress(pool[i % t["pool"]], cfg, device=dev)
    with _traced_layers(run, G=G):
        with _window(run, profile, dev):
            end = time.perf_counter() + seconds
            i = 0
            while (i < t["trace_requests"]) if run.trace_on \
                    else time.perf_counter() < end:
                k = i % t["pool"]
                run.attempted += 1
                with run.spans.span("request.encode"):
                    t0 = time.perf_counter()
                    s = G.compress(pool[k], cfg, device=dev)
                    t1 = time.perf_counter()
                run.requests.append((ENCODE, t0, t1, run.mp))
                run.answered += 1
                run.encoded_frames.append(k)
                run.answers.append((k, "stream", s))
                i += 1
    run.pool = pool
    run.check_keys = set(_check_keys(run, range(t["pool"])))
    return []


def _port_streams(pool, cfg, c, dev, B):
    """The pool's streams, encoded by the port (set-up of the decode)."""
    from icer_compression_tpu_torch.models import grayscale as G
    enc = G.make_encoder(c["width"], c["height"], cfg, np.uint16,
                         device=dev)
    streams = []
    for i in range(0, len(pool), B):
        streams.extend(G.allocate_streams(
            enc.encode_batch(pool[i:i + B]), cfg, enc))
    return streams, enc


def _decode_batch(run, seconds, profile, dev):
    from icer_compression_tpu_torch.backend import graph_cache
    from icer_compression_tpu_torch.models import decode as D
    from icer_compression_tpu_torch.models import grayscale as G
    c, t = run.config, run.traffic
    cfg = codec_config(c, t)
    pool = frames.pool(c, run.seed, t["pool"])
    B, K = t["batch"], t["inflight"]
    streams, enc = _port_streams(pool, cfg, c, dev, B)
    del enc
    keep = set(_check_keys(run, range(t["pool"])))

    def submit(idx):
        return D.decompress_batch([streams[i] for i in idx], cfg,
                                  dtype=np.uint16, device=dev, defer=True,
                                  pack8=True)

    def finish_warm(hold, idx, t0):
        hold()

    for idx in list(_take(_cycle(t["pool"], B), t["warm_serial"])):
        finish_warm(submit(idx), idx, 0)
    _pipelined(submit, finish_warm, _cycle(t["pool"], B), K,
               limit=t["warm_pipelined"])

    def finish(hold, idx, t0):
        imgs = hold()
        t1 = time.perf_counter()
        run.requests.append((DECODE, t0, t1, len(idx) * run.mp))
        run.answered += len(imgs)
        run.decoded_frames.extend(idx)
        for i, px in zip(idx, imgs):
            if i in keep:
                run.answers.append((i, "pixels", px))

    def submit_counted(idx):
        run.attempted += len(idx)
        return submit(idx)

    captures0 = len(graph_cache.CACHE.captures)
    with _traced_layers(run, D=D):
        with _window(run, profile, dev):
            _pipelined(submit_counted, finish,
                       _cycle(t["pool"], B), K,
                       until=None if run.trace_on
                       else time.perf_counter() + seconds,
                       limit=t["trace_batches"] if run.trace_on else None)
    run.counters["decode_captures"] = sum(
        1 for cap in graph_cache.CACHE.captures[captures0:]
        if graph_cache.is_decode(cap["key"]))
    run.pool = pool
    run.streams = streams
    run.check_keys = keep
    return []


def _tactical(run, seconds, profile, dev):
    from icer_compression_tpu_torch.backend import graph_cache
    from icer_compression_tpu_torch.models import decode as D
    from icer_compression_tpu_torch.models import grayscale as G
    c, t = run.config, run.traffic
    cfg = codec_config(c, t)
    base = frames.tiled(c["height"], c["width"])
    for i in range(t["warm"]):
        f = frames.noisy(base, np.random.default_rng([run.seed, 2, i]),
                         c["noise"])
        G.decompress(G.compress_batch(f[None], cfg, device=dev)[0], cfg,
                     dtype=np.uint16, device=dev)
    run.classes = []
    captures0 = len(graph_cache.CACHE.captures)
    with _traced_layers(run, G=G, D=D):
        with _window(run, profile, dev):
            end = time.perf_counter() + seconds
            i = 0
            while (i < t["trace_requests"]) if run.trace_on \
                    else time.perf_counter() < end:
                f = frames.fresh(c, run.seed, i, base)
                run.attempted += 1
                stats: dict = {}
                with run.spans.span("request.encode"):
                    t0 = time.perf_counter()
                    s = G.compress_batch(f[None], cfg, device=dev,
                                         stats=stats)[0]
                    t1 = time.perf_counter()
                with run.spans.span("request.decode"):
                    px = G.decompress(s, cfg, dtype=np.uint16, device=dev)
                    t2 = time.perf_counter()
                run.requests.append((ENCODE, t0, t1, run.mp))
                run.requests.append((DECODE, t1, t2, run.mp))
                run.classes.append(stats.get("last_class"))
                run.answered += 1
                run.answers.append((i, "stream", s))
                run.answers.append((i, "pixels", px))
                i += 1
    run.counters["decode_captures"] = sum(
        1 for cap in graph_cache.CACHE.captures[captures0:]
        if graph_cache.is_decode(cap["key"]))
    run.check_keys = set(_check_keys(run, range(i)))
    run.answers = [a for a in run.answers if a[0] in run.check_keys]
    return []


def _check_keys(run, keys) -> list:
    """The frames whose answers the check compares with the reference:
    ``check_frames`` of ``keys`` drawn from the seed."""
    keys = list(keys)
    n = run.traffic["check_frames"]
    if len(keys) <= n:
        return keys
    rng = np.random.default_rng([run.seed, 3])
    return sorted(keys[j] for j in rng.choice(len(keys), n, replace=False))


@contextlib.contextmanager
def _traced_layers(run, G=None, D=None):
    """In a traced run, the layers the per-layer metrics read timed by the
    harness's spans: host allocation and the decode's host plan."""
    with contextlib.ExitStack() as stack:
        if run.trace_on and G is not None:
            stack.enter_context(run.spans.wrapped(G, "allocate_streams",
                                                  "allocate_streams"))
        if run.trace_on and D is not None:
            stack.enter_context(run.spans.wrapped(D, "plan_batch",
                                                  "plan_batch"))
        yield


MODES = {"encode_batch": _encode_batch, "compress": _compress,
         "decode_batch": _decode_batch, "tactical": _tactical}
