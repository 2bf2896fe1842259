"""The port's bench (``icer_compression_tpu_torch/bench.py``), its trace
accounting (``utils/trace.layer_breakdown``) and its scaling harness
(``bench_scaling.py``) on the CPU, at a small size: every mode verified,
the batch's streams byte-equal to the JAX package's host codec."""

import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from icer_compression_tpu.models import grayscale as G
from icer_compression_tpu_torch import bench
from icer_compression_tpu_torch.models import grayscale as T
from icer_compression_tpu_torch.utils.image_io import read_png, write_png
from icer_compression_tpu_torch.utils.trace import layer_breakdown
from test_torch_entropy_slim import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def boat_crop(h=40, w=48):
    boat = read_png(os.path.join(REPO, "tests", "data", "boat.512.png"))
    return boat[256 - h // 2:256 + h // 2,
                256 - w // 2:256 + w // 2].astype(np.uint16)


def test_bench_modes_verified_and_equal_to_jax_package():
    # unlimited quota: at 48x40 the segment headers alone pass the root
    # bench's lossless quota of w * h bytes
    img = boat_crop()
    h, w = img.shape
    cfg = T.CodecConfig(4, 0, 6, None)
    jcfg = G.CodecConfig(4, 0, 6, None)
    golden = hashlib.sha256(G.compress(img, jcfg)).hexdigest()
    res = bench.run(img, cfg, "cpu", reps=1, reps_card=1, batch=2,
                    batch_enc=4, pipe=2, golden=golden)
    d = res["detail"]
    assert set(res) == {"metric", "value", "unit", "vs_baseline", "detail"}
    assert d["all_verified"]
    for mode in ("native", "cpu", "cpu_batched", "cpu_pipelined"):
        assert d[mode]["verified"], mode
        assert d[mode]["MPs"] > 0
    assert d["native"]["stream_matches_reference"]
    assert d["cpu"]["stream_matches_reference"]
    assert d["cpu"]["stream_matches_native"]
    assert d["cpu"]["entropy_backend"] == "auto"
    assert d["cpu"]["k1_launches"] == {"fused-key": 0, "two-word": 0}
    b, p = d["cpu_batched"], d["cpu_pipelined"]
    assert (b["B"], b["B_enc"], b["encode_passes"]) == (2, 4, 1)
    assert p["batches_in_flight"] == 2 and p["B_enc"] == 4
    assert set(p["decode_variants_ms_per_img"]) == {"2"}
    assert d["device"] == {"type": "cpu", "name": None, "nvidia_smi": None,
                           "count": 0}
    assert d["device_time"].startswith("not measured")
    assert res["value"] == max(d[m]["MPs"] for m in
                               ("native", "cpu", "cpu_batched",
                                "cpu_pipelined"))
    # the batched mode's streams, byte for byte the JAX package's
    imgs = bench.noisy_variants(img, 4)
    assert np.array_equal(imgs[0], img)
    enc = T.make_encoder(w, h, cfg, np.uint16, device="cpu")
    streams = T.allocate_streams(enc.encode_batch(imgs), cfg, enc)
    assert streams == [G.compress(im, jcfg) for im in imgs]


def test_bench_needs_a_card_unless_asked_for_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main([]) != 0
    assert "no CUDA device" in capsys.readouterr().err


def test_bench_marks_a_failed_mode_and_exits_non_zero(monkeypatch, capsys,
                                                    tmp_path):
    path = str(tmp_path / "crop.png")
    write_png(path, boat_crop().astype(np.uint8))
    real = T.decompress

    def wrong(data, *a, **k):
        px = real(data, *a, **k)
        if k.get("backend") == "native":
            return px
        px = px.copy()
        px[0, 0] ^= 1
        return px
    monkeypatch.setattr(T, "decompress", wrong)
    run = bench.run
    monkeypatch.setattr(bench, "run", lambda image, cfg, *a: run(
        image, T.CodecConfig(4, 0, 6, None), *a))
    rc = bench.main(["--device", "cpu", "--image", path, "--reps", "1",
                     "--reps-card", "1", "--batch", "2", "--batch-enc", "2",
                     "--pipe", "1"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 1
    d = out["detail"]
    assert not d["all_verified"]
    assert not d["cpu"]["lossless_roundtrip"] and not d["cpu"]["verified"]
    assert d["native"]["verified"] and d["cpu_batched"]["verified"]
    assert out["metric"].endswith("best mode: " + max(
        (d[m]["MPs"], m) for m in ("native", "cpu_batched"))[1])


def _event(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": args}


def test_layer_breakdown_on_a_synthetic_trace():
    """Nested program spans and overlapping kernels: a launch outside a
    replay belongs to the innermost span, busy time is the union of the
    device intervals, a span's host time leaves out the spans nested in
    it, and the counts in the window are summed."""
    ev = [
        _event("user_annotation", "encode", 0, 1000),
        _event("user_annotation", "icer.outer", 100, 500),
        _event("user_annotation", "icer.inner", 200, 100),
        _event("user_annotation", "icer.inner", 400, 50),
        _event("user_annotation", "icer.other window", 2000, 10),
        _event("user_annotation", "count:encode.lanes=5", 120, 0),
        _event("user_annotation", "count:encode.lanes=3", 130, 0),
        _event("user_annotation", "count:encode.lanes=9", 2005, 0),
        _event("cuda_runtime", "cudaLaunchKernel", 150, 5, correlation=1),
        _event("cuda_runtime", "cudaLaunchKernel", 250, 5, correlation=2),
        _event("cuda_runtime", "cudaMemcpyAsync", 410, 5, correlation=3),
        _event("cuda_runtime", "cudaLaunchKernel", 800, 5, correlation=4),
        _event("cuda_runtime", "cudaLaunchKernel", 2005, 5, correlation=5),
        # device work: 1 and 2 overlap (300-500 and 400-700), 3 inside 2,
        # 4 alone (900-1100, past the window's end), 5 outside the window
        _event("kernel", "k1", 300, 200, correlation=1),
        _event("kernel", "k2", 400, 300, correlation=2),
        _event("gpu_memcpy", "Memcpy HtoD", 450, 100, correlation=3),
        _event("kernel", "k4", 900, 200, correlation=4),
        _event("kernel", "k5", 2100, 50, correlation=5),
    ]
    r = layer_breakdown(ev, "encode")
    assert r["launches"] == 4 and r["api_launches"] == 4
    assert r["busy_ms"] == pytest.approx((400 + 200) / 1e3)
    assert r["wall_ms"] == pytest.approx(1100 / 1e3)
    assert r["idle_share"] == pytest.approx(1 - 600 / 1100)
    assert r["host_gap_us"] == pytest.approx((800 - 150) / 3)
    L = r["layers"]
    assert L["outer"] == {"device_ms": pytest.approx(0.2), "launches": 1,
                          "host_ms": pytest.approx((500 - 150) / 1e3)}
    assert L["inner"] == {"device_ms": pytest.approx(0.4), "launches": 2,
                          "host_ms": pytest.approx(150 / 1e3)}
    assert L["other"] == {"device_ms": pytest.approx(0.2), "launches": 1,
                          "host_ms": 0.0}
    assert "other window" not in L
    assert r["counts"] == {"encode.lanes": 8} and r["unmarked"] == 0
    with pytest.raises(AssertionError, match="no device work"):
        layer_breakdown([e for e in ev if e["cat"] == "user_annotation"],
                        "encode")


def test_bench_scaling_worlds_on_cpu():
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run(
        [sys.executable, "-m", "icer_compression_tpu_torch.bench_scaling",
         "--devices", "1,2", "--device", "cpu", "--size", "32", "--reps",
         "1"], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    lines = [json.loads(ln) for ln in res.stdout.splitlines()]
    assert [ln["devices"] for ln in lines] == [1, 2]
    assert [ln["mesh"] for ln in lines] == [{"data": 1, "seg": 1},
                                            {"data": 1, "seg": 2}]
    for ln in lines:
        assert ln["batch"] == 2 and ln["MPs"] > 0
        assert ln["scaling_efficiency"] is None
        assert ln["cards"] == 0 and ln["ranks_per_card"] is None
        assert ln["backend"] == "gloo" and ln["streams_equal"]


def test_bench_scaling_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    from icer_compression_tpu_torch import bench_scaling
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench_scaling.main(["--devices", "1"]) != 0


def test_layer_breakdown_counts_a_graph_replay_as_one_api_launch():
    """A captured pass: one cudaGraphLaunch whose kernels share its
    correlation id, and the copies around it.  The replay's records go to
    the stage of the mark before each until its end mark; a replay
    without marks is counted as unmarked and goes by span."""
    mark = "void icer_mark<{}>(unsigned long long*)".format
    ev = [
        _event("user_annotation", "encode graph", 0, 1000),
        _event("cuda_runtime", "cudaMemcpyAsync", 10, 5, correlation=1),
        _event("cuda_runtime", "cudaGraphLaunch", 20, 30, correlation=2),
        _event("cuda_runtime", "cudaMemcpyAsync", 60, 5, correlation=3),
        _event("cuda_runtime", "cudaGraphLaunch", 600, 30, correlation=4),
        _event("gpu_memcpy", "Memcpy HtoD", 30, 10, correlation=1),
        _event("kernel", mark(1), 90, 2, correlation=2),
        _event("kernel", "k1", 100, 200, correlation=2),
        _event("kernel", "k2", 300, 100, correlation=2),
        _event("kernel", mark(4), 420, 2, correlation=2),
        _event("kernel", "k3", 450, 48, correlation=2),
        _event("kernel", mark(7), 498, 2, correlation=2),
        _event("gpu_memcpy", "Memcpy DtoH", 500, 20, correlation=3),
        _event("kernel", "k9", 700, 10, correlation=4),
    ]
    r = layer_breakdown(ev, "encode graph")
    assert r["launches"] == 9 and r["api_launches"] == 4
    assert r["kernels"] == {"k1": 1, "k2": 1, "k3": 1, "k9": 1,
                            mark(1): 1, mark(4): 1, mark(7): 1}
    assert r["busy_ms"] == pytest.approx((10 + 2 + 300 + 2 + 70 + 10)
                                         / 1e3)
    L = r["layers"]
    assert set(L) == {"other", "context model", "sort and pack", "end"}
    assert L["context model"]["device_ms"] == pytest.approx(0.302)
    assert L["sort and pack"]["device_ms"] == pytest.approx(0.050)
    assert L["other"]["launches"] == 3 and r["unmarked"] == 1
