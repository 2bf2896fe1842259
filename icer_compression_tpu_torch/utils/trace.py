"""Layer accounting of a ``torch.profiler`` trace of the codec.

``trace_layers`` names, for each layer of the encode and decode, the
functions whose launches it owns; ``annotated`` wraps each of them in a
``record_function`` range named ``layer:<layer>``; ``layer_breakdown``
reads an exported chrome trace and puts each device launch in the
innermost layer range around its host call.  ``chip_smoke.py`` (boat's
main path) and ``bench.py`` (a batch) trace the codec with them.

A captured encode or decode pass (backend/graph_cache) is one graph
launch with no host range inside it to give a layer, so the table by layer
traces an eager encoder and decode (``graph=False``) and a graph's replay
is read beside it as a whole: its device busy time, idle share, device
launches and the API calls that put work on the device
(``api_launches``).
"""

from __future__ import annotations

import collections
import contextlib
import functools

from torch.profiler import record_function


@contextlib.contextmanager
def swapped(owner, name, value):
    """``owner.name`` replaced by ``value`` inside the block."""
    old = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, old)


# the layers of the codec's trace: (module or class, attribute, layer)
# for each function whose launches a layer owns; a launch belongs to the
# innermost layer around it
def trace_layers():
    from ..models import decode as D
    from ..models import grayscale as T
    from ..ops import encode as E
    from ..ops import entropy_slim as ES
    from ..ops import wavelet as WV
    enc = E.TorchGrayscaleEncoder
    return [(enc, "_upload", "upload"),
            (enc, "transform", "LL mean and sign-magnitude"),
            (WV, "forward_stages", "forward DWT"),
            (enc, "emit", "context model"),
            (enc, "bucket_words", "coder input"),
            (ES, "code_lanes_slim", "slim tail"),
            (ES, "encode_lanes_slim", "K1"),
            (ES, "encode_lanes_slim_two_word", "K1"),
            (ES, "order_and_pack_lanes", "sort and pack"),
            (ES, "order_and_pack_lanes_two_word", "sort and pack"),
            (enc, "_collect", "host collect"),
            (T, "allocate_streams", "host allocation"),
            (D, "plan_batch", "host plan"),
            (D, "_upload", "upload"),
            (D, "unit_inputs", "upload"),
            (D, "decode_units", "K2"),
            (D, "finalize", "gather and finalize"),
            (WV, "inverse_stages", "inverse DWT")]


@contextlib.contextmanager
def annotated(layers):
    """Each function of ``layers`` wrapped in a profiler range named
    ``layer:<layer>`` inside the block."""
    with contextlib.ExitStack() as stack:
        for owner, name, layer in layers:
            fn = getattr(owner, name)

            # a counted kernel wrapper adds to its own name's ``launches``,
            # which ``functools.wraps`` copies
            @functools.wraps(fn)
            def wrapped(*a, _fn=fn, _label=f"layer:{layer}", **k):
                with record_function(_label):
                    return _fn(*a, **k)
            stack.enter_context(swapped(owner, name, wrapped))
        yield


def layer_breakdown(events, window: str) -> dict:
    """The device work launched inside the host range ``window`` of a
    chrome trace's events (one host thread), grouped by the innermost
    ``layer:`` range around each launch: per layer the device ms, the
    launches and the host ms outside nested layers; the window's wall,
    the device's busy ms (the union of its intervals) and idle share,
    the API calls that launched the work (one per graph replay), the
    kernels by name and the mean host time between launches."""
    (win,) = [e for e in events if e.get("cat") == "user_annotation"
              and e.get("name") == window]
    t0, t1 = win["ts"], win["ts"] + win["dur"]
    spans = sorted((e for e in events if e.get("cat") == "user_annotation"
                    and e.get("name", "").startswith("layer:")
                    and t0 <= e["ts"] <= t1), key=lambda e: e["ts"])
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and t0 <= e["ts"] <= t1
                and "correlation" in e.get("args", {})}
    work = [e for e in events
            if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
            and e.get("args", {}).get("correlation") in launches]
    if not work:
        raise AssertionError(f"the trace of {window} holds no device work")

    def layer_of(ts):
        inner = [s for s in spans if s["ts"] <= ts <= s["ts"] + s["dur"]]
        return min(inner, key=lambda s: s["dur"])["name"][6:] \
            if inner else "other"

    groups: dict = {}
    for e in work:
        run = launches[e["args"]["correlation"]]
        g = groups.setdefault(layer_of(run["ts"]),
                              {"device_ms": 0.0, "launches": 0,
                               "host_ms": 0.0})
        g["device_ms"] += e["dur"] / 1e3
        g["launches"] += 1
    # each range's host time outside the layers nested in it
    stack: list = []
    for s in sorted(spans, key=lambda s: (s["ts"], -s["dur"])):
        while stack and s["ts"] > stack[-1]["ts"] + stack[-1]["dur"]:
            stack.pop()
        if stack:
            stack[-1]["nested"] = stack[-1].get("nested", 0) + s["dur"]
        stack.append(s)
    for s in spans:
        g = groups.setdefault(s["name"][6:], {"device_ms": 0.0,
                                              "launches": 0, "host_ms": 0.0})
        g["host_ms"] += (s["dur"] - s.get("nested", 0)) / 1e3
    busy, end = 0.0, -1.0
    for a, b in sorted((e["ts"], e["ts"] + e["dur"]) for e in work):
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    span = max(t1, end) - t0
    ts = sorted(launches[e["args"]["correlation"]]["ts"] for e in work)
    return {"wall_ms": span / 1e3, "busy_ms": busy / 1e3,
            "idle_share": 1 - busy / span, "launches": len(work),
            "api_launches": len({e["args"]["correlation"] for e in work}),
            "kernels": dict(collections.Counter(
                e["name"] for e in work if e["cat"] == "kernel")),
            "host_gap_us": (ts[-1] - ts[0]) / max(1, len(ts) - 1),
            "layers": groups}
