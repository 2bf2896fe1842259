"""Fixtures of the benchmark's tests: a tiny cell on the CPU."""

import json
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]

TINY = {"name": "tiny", "source": "test", "width": 48, "height": 40,
        "bit_depth": 8, "container": "uint16", "stages": 4, "filter": "A",
        "segments": 6, "noise": 6, "reduced": []}

TRAFFIC = {
    "enc": {"mode": "encode_batch", "batch": 2, "inflight": 2, "pool": 4,
            "quota_bpp": 1.0, "warm_serial": 1, "warm_pipelined": 1,
            "trace_batches": 2, "check_frames": 2},
    "comp": {"mode": "compress", "pool": 2, "quota_bpp": None, "warm": 1,
             "trace_requests": 2, "check_frames": 2},
    "dec": {"mode": "decode_batch", "batch": 2, "inflight": 2, "pool": 4,
            "quota_bpp": 1.0, "warm_serial": 1, "warm_pipelined": 1,
            "trace_batches": 2, "check_frames": 2},
    "tac": {"mode": "tactical", "quota_bpp": 1.0, "warm": 1,
            "trace_requests": 2, "check_frames": 2},
}

# each tiny cell reports the metrics of the cell whose traffic it shrinks
REAL = {"enc": "mer1024.batch_encode_1bpp",
        "comp": "m2020_20mp.encode_lossless",
        "dec": "mer1024.batch_decode_1bpp",
        "tac": "mer1024.tactical_1bpp"}


@pytest.fixture
def tiny(tmp_path):
    """(bench, traffic dir): BENCHMARK.json with a tiny 48x40 cell per
    traffic mode, run on the CPU."""
    import torch
    torch.set_num_threads(1)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps(TINY))
    tdir = tmp_path / "traffic"
    tdir.mkdir()
    for name, t in TRAFFIC.items():
        (tdir / f"{name}.json").write_text(json.dumps(t))
        bench["workloads"].append({"name": f"tiny.{name}", "config": "tiny",
                                   "traffic": name, "chips": 1, "why": "t"})
    bench["configs"].append({"name": "tiny", "source": "t",
                             "file": str(cfg), "reduced": []})
    for m in bench["end_to_end"] + bench["per_layer"]:
        for t, real in REAL.items():
            if real in m.get("workloads", ()):
                m["workloads"].append(f"tiny.{t}")
    return bench, tdir


@pytest.fixture
def card():
    """Skips unless a CUDA device is present (decided here, not at
    import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
