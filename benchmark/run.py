"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

``--trace 0`` measures the cell's end-to-end metrics; ``--trace 1`` runs
a short traced window under ``torch.profiler`` and reads the cell's
per-layer metrics (``metrics/<name>.py``).  Either way the answers of the
window are then checked against the plain reference (``check``), each
compared number is printed beside its limit on standard error and, under
``checks``, last in the result line.  The run exits non-zero, printing no
result, when no CUDA device is present, and when ``jax``, ``jaxlib``,
``flax`` or the JAX package ``icer_compression_tpu`` is loaded once the
window has closed.
"""

from __future__ import annotations

import os
import time


def _process_start() -> float:
    """The wall-clock time this process started (Linux ``/proc``; to
    10 ms), else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        age = time.clock_gettime(time.CLOCK_BOOTTIME) \
            - ticks / os.sysconf("SC_CLK_TCK")
        return time.time() - age
    except (OSError, ValueError, IndexError):
        return time.time()


T_START = _process_start()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

from . import Failed  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "icer_compression_tpu")

# the kernels whose trace records a traced run counts against the runs
# the kernels count on the card (icer_compression_tpu_torch.kernels)
KERNEL_FAMILIES = {
    "K1": (("slim_encode_kernel", "slim_encode_wide_kernel"),
           ("slim_encode", "slim_encode_two_word")),
    "K2": (("plane_decode_kernel",), ("plane_decode", "plane_decode_seeded")),
    "W1": (("inverse_column_pass", "inverse_row_pass"), ("wavelet_inverse",)),
}


def log(msg: str) -> None:
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Top-level names in ``sys.modules`` that the run may not load,
    compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def load_spec(bench: dict, workload: str, root: Path = ROOT,
              traffic_dir: Path | None = None):
    """(cell, configuration, traffic) of ``workload``; the traffic mix from
    ``traffic_dir`` (default ``benchmark/traffic``)."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise Failed(f"unknown workload {workload!r}")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    with open(root / configs[cell["config"]]["file"]) as f:
        config = json.load(f)
    if traffic_dir is None:
        traffic_dir = root / "benchmark" / "traffic"
    with open(Path(traffic_dir) / f"{cell['traffic']}.json") as f:
        traffic = json.load(f)
    return cell, config, traffic


def metrics_for(bench: dict, cell: str, trace: bool) -> list:
    """The metric entries the cell reports in this kind of run."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if "workloads" not in m
            or cell in m["workloads"]]


def reader(name: str, root: Path = ROOT):
    """``metrics/<name>.py``'s ``read``."""
    path = root / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@contextlib.contextmanager
def _no_profile():
    yield


def _profiler(run, dev):
    """A context manager that profiles the window and leaves the trace in
    ``run.trace`` (the chrome trace is written under TMPDIR and removed)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from .tracemath import Trace

    @contextlib.contextmanager
    def cm():
        acts = [ProfilerActivity.CPU]
        if torch.device(dev).type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            yield
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            run.trace = Trace.load(path)
        finally:
            os.remove(path)
    return cm


def _read_trace(run, runs0: dict, runs1: dict) -> None:
    """The traced window's device work, checked against the runs the
    kernels counted on the card before it is trusted."""
    (win,) = run.trace.spans("bench:window")
    run.trace_window = win
    run.work = run.trace.launched(*win)
    if not runs1:
        return
    for fam, (names, slots) in KERNEL_FAMILIES.items():
        counted = sum(runs1.get(s, 0) - runs0.get(s, 0) for s in slots)
        seen = sum(1 for n, _, _ in run.work if any(k in n for k in names))
        if counted != seen:
            raise Failed(f"the trace holds {seen} {fam} records but the "
                         f"card counted {counted} runs: records were lost")
    if not run.work:
        raise Failed("the traced window holds no device work")


def execute(bench: dict, workload: str, seed: int, seconds: float,
            trace: bool, dev: str = "cuda", t_start: float = T_START,
            root: Path = ROOT, workers: int | None = None,
            traffic_dir: Path | None = None,
            control: str | None = None,
            modes_dir: Path | None = None) -> dict:
    """One run of ``workload`` on ``dev`` (no look for a chip): the result
    line's object.  ``control`` (``check.CONTROLS``) judges a faulty
    reference in the program's place instead (``benchmark.control``).
    A traffic mode that is not built in is found in ``modes_dir``
    (default ``benchmark/modes`` under ``root``)."""
    import torch

    from . import check, load
    cell, config, traffic = load_spec(bench, workload, root, traffic_dir)
    run = load.Run(cell, config, traffic, seed, trace)
    profile = _profiler(run, dev) if trace else _no_profile
    cuda = torch.device(dev).type == "cuda"
    # the program's state is created inside, measured, then freed
    if modes_dir is None:
        modes_dir = root / "benchmark" / "modes"
    state = load.run_mode(run, seconds, profile, dev, Path(modes_dir))
    log(f"set-up {run.first_request - t_start:.3f} s, window "
        f"{run.window[1] - run.window[0]:.3f} s, {run.attempted} attempted")
    counters = run.counters
    if trace:
        _read_trace(run, counters["runs_before"], counters["runs_after"])
    memory_peak = 0
    del state
    if cuda:
        from icer_compression_tpu_torch.backend import graph_cache
        counters["graph_reserved_bytes"] = graph_cache.reserved_bytes(dev)
        memory_peak = max(counters["reserved_peak_setup"],
                          counters["reserved_peak_window"])
        graph_cache.CACHE.clear()
        gc.collect()
        torch.cuda.empty_cache()

    run.setup_s = run.first_request - t_start
    t0 = time.time()
    metrics = {}
    for m in metrics_for(bench, workload, trace):
        value = reader(m["name"], root)(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    log(f"metrics read in {time.time() - t0:.3f} s")
    t0 = time.time()
    checks = check.run_check(run, load.codec_config(config, traffic)
                             .byte_quota, workers, control)
    log(f"reference check of {len(run.check_keys)} frames "
        f"{time.time() - t0:.3f} s")
    correct = all(v <= lim for _, v, lim in checks)
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
              "count": cell["chips"], "memory_peak_bytes": int(memory_peak)}
    out = {"correct": bool(correct), "attempted": run.attempted,
           "failed": run.attempted - run.answered, "metrics": metrics,
           "device": device}
    if trace:
        from .tracemath import idle_gaps, top_ops
        lo, hi = run.trace_window
        device["busy_s"] = run.trace.busy(run.work, lo, hi)
        device["window_s"] = hi - lo
        names = {e["name"] for e in run.trace.ranges
                 if e["name"].startswith("bench:")} - {"bench:window"}
        spans = {n[6:]: run.trace.spans(n) for n in names}
        out["breakdown"] = {"device_ops": top_ops(run.work),
                            "idle_gaps": idle_gaps(run.work, lo, hi, spans)}
    out["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # the program's compile caches stay inside the checkout
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    try:
        with open(ROOT / "BENCHMARK.json") as f:
            bench = json.load(f)
        cell = load_spec(bench, args.workload)[0]
        import torch
        if not torch.cuda.is_available() \
                or torch.cuda.device_count() < cell["chips"]:
            raise Failed(f"{cell['chips']} CUDA device(s) needed, "
                         f"{torch.cuda.device_count()} present")
        result = execute(bench, args.workload, args.seed, args.seconds,
                         bool(args.trace))
    except Failed as exc:
        print(f"benchmark: {exc}", file=sys.stderr)
        return 2
    found = forbidden_modules()
    if found:
        print(f"benchmark: loaded {', '.join(found)}; the run may not",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
