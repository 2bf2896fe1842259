"""Whole runs of the harness on the CPU at a tiny size (the port's plain
kernels): the result line's schema, the check passing on sound runs and
failing on each fault the cells can have, the controls failing, and no
forbidden module loaded."""

import json
import subprocess
import sys

import numpy as np
import pytest

from benchmark import check, load, run
from benchmark.tests.conftest import ROOT

SEED = 2 ** 31 + 99


def _execute(tiny, name, trace=False, **kw):
    bench, tdir = tiny
    return run.execute(bench, f"tiny.{name}", SEED, 1.0, trace, dev="cpu",
                       workers=0, traffic_dir=tdir, **kw)


def _schema(out, trace):
    assert list(out)[-1] == "checks"
    for k in ("correct", "attempted", "failed", "metrics", "device"):
        assert k in out
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and np.isfinite(m["value"])
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}
    if trace:
        assert out["device"]["window_s"] > 0
        assert len(out["breakdown"]["device_ops"]) <= 10
        assert len(out["breakdown"]["idle_gaps"]) <= 10
    json.dumps(out)


@pytest.mark.parametrize("name", ["enc", "comp", "dec", "tac"])
@pytest.mark.parametrize("trace", [False, True])
def test_sound_runs_are_correct(tiny, name, trace):
    out = _execute(tiny, name, trace)
    _schema(out, trace)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    if not trace:
        assert "setup_s" in out["metrics"]


def _flip_stream(s: bytes) -> bytes:
    b = bytearray(s)
    b[-1] ^= 0x10
    return bytes(b)


def test_fault_stream_altered_where_produced(tiny, monkeypatch):
    from icer_compression_tpu_torch.models import grayscale as G
    orig = G.allocate_streams

    def altered(results, cfg, enc):
        return [_flip_stream(s) for s in orig(results, cfg, enc)]
    monkeypatch.setattr(G, "allocate_streams", altered)
    out = _execute(tiny, "enc")
    assert not out["correct"] and out["checks"]["streams_wrong"]["value"]


def test_fault_half_the_batch_left_out(tiny, monkeypatch):
    from icer_compression_tpu_torch.ops import encode as E
    orig = E.TorchGrayscaleEncoder.encode_batch

    def half(self, images, defer=False):
        if not defer:
            return orig(self, images)
        hold = orig(self, images, defer=True)
        return lambda: hold()[:max(1, len(images) // 2)]
    monkeypatch.setattr(E.TorchGrayscaleEncoder, "encode_batch", half)
    out = _execute(tiny, "enc")
    assert not out["correct"]
    assert out["checks"]["answers_missing"]["value"] > 0


def test_fault_compress_answer_altered(tiny, monkeypatch):
    from icer_compression_tpu_torch.models import grayscale as G
    orig = G.compress
    calls = []

    def altered(image, cfg, device=None):
        calls.append(1)
        s = orig(image, cfg, device=device)
        return _flip_stream(s) if len(calls) > 1 else s   # past the warm
    monkeypatch.setattr(G, "compress", altered)
    out = _execute(tiny, "comp")
    assert not out["correct"]


def _flip_pixels(px):
    px = np.array(px)
    px[0, 0] ^= 1
    return px


def test_fault_decoded_pixels_altered(tiny, monkeypatch):
    from icer_compression_tpu_torch.models import decode as D
    orig = D.decompress_batch

    def altered(streams, cfg, **kw):
        hold = orig(streams, cfg, **kw)
        if not kw.get("defer"):
            return [_flip_pixels(p) for p in hold]
        return lambda: [_flip_pixels(p) for p in hold()]
    monkeypatch.setattr(D, "decompress_batch", altered)
    out = _execute(tiny, "dec")
    assert not out["correct"] and out["checks"]["pixels_wrong"]["value"]


def test_fault_tactical_decode_altered(tiny, monkeypatch):
    from icer_compression_tpu_torch.models import grayscale as G
    orig = G.decompress
    monkeypatch.setattr(G, "decompress",
                        lambda *a, **k: _flip_pixels(orig(*a, **k)))
    out = _execute(tiny, "tac")
    assert not out["correct"] and out["checks"]["pixels_wrong"]["value"]


def _sound_run(size, quota):
    """A run of one 8-bit frame of ``size``^2 whose answers (stream and
    pixels) are the sound reference's."""
    config = {"width": size, "height": size, "stages": 4, "filter": "A",
              "segments": 6, "noise": 6, "container": "uint16"}
    r = load.Run({"name": "t"}, config, {"mode": "compress"}, SEED, False)
    r.pool = np.stack([load.frames.noisy(load.frames.tiled(size, size),
                                         np.random.default_rng(1), 6)])
    r.check_keys = {0}
    sound = check.reference(r, quota, 2)
    r.answers = [(0, "stream", sound[0]["stream"]),
                 (0, "pixels", sound[0]["pixels"])]
    r.attempted = r.answered = 1
    assert all(v <= lim for _, v, lim in check.compare(r, sound))
    return r


def test_control_unbounded_window_fails():
    """At 512x512 lossless (lanes that fill the codeword buffer): the
    reference whose coder never force-completes a codeword, in the
    program's place, fails; the sound reference there passes."""
    r = _sound_run(512, 512 * 512)
    numbers = check.run_check(r, 512 * 512, 2, control="unbounded_window")
    assert dict((n, v) for n, v, _ in numbers)["streams_wrong"] > 0


def test_control_one_plane_short_fails():
    """At 256x256 and 1 bpp: a decoder that stops one plane early, in the
    program's place, fails."""
    quota = 256 * 256 // 8
    r = _sound_run(256, quota)
    numbers = check.run_check(r, quota, 2, control="one_plane_short")
    assert dict((n, v) for n, v, _ in numbers)["pixels_wrong"] > 0


_PROBE = """
import json, sys
sys.path.insert(0, {root!r})
from benchmark.tests import conftest
from benchmark import run
import pathlib, tempfile
bench = json.loads((conftest.ROOT / "BENCHMARK.json").read_text())
d = pathlib.Path(tempfile.mkdtemp())
(d / "tiny.json").write_text(json.dumps(conftest.TINY))
for n, t in conftest.TRAFFIC.items():
    (d / (n + ".json")).write_text(json.dumps(t))
    bench["workloads"].append({{"name": "tiny." + n, "config": "tiny",
                               "traffic": n, "chips": 1, "why": "t"}})
bench["configs"].append({{"name": "tiny", "source": "t",
                         "file": str(d / "tiny.json"), "reduced": []}})
for n in ("enc", "dec"):
    run.execute(bench, "tiny." + n, 5, 0.5, False, dev="cpu", workers=1,
                traffic_dir=d)
print(json.dumps(run.forbidden_modules()))
"""


def test_no_forbidden_module_in_a_run():
    """A whole run (set-up, window, check) in a fresh process loads no
    module whose top-level name is jax, jaxlib, flax or
    icer_compression_tpu (compared whole: icer_compression_tpu_torch is
    the program)."""
    p = subprocess.run([sys.executable, "-c", _PROBE.format(root=str(ROOT))],
                       capture_output=True, text=True, timeout=600,
                       cwd=ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    assert json.loads(p.stdout.strip().splitlines()[-1]) == []


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "icer_compression_tpu_torchx", sys)
    monkeypatch.setitem(sys.modules, "jaxy", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert run.forbidden_modules() == ["jax"]


def test_reference_imports_nothing_of_the_program():
    """Every module under ``benchmark/reference/`` (found by glob, so a
    reference a later cell adds is held to it too) imported, and a
    grayscale encode run, in a fresh process."""
    code = ("import importlib, sys, numpy as np\n"
            "sys.path.insert(0, %r)\n"
            "for m in %r:\n"
            "    importlib.import_module('benchmark.reference.' + m)\n"
            "from benchmark.reference import codec\n"
            "from benchmark.reference.workers import Workers\n"
            "from benchmark import frames\n"
            "b = frames.boat()[:64, :64].astype(np.uint16)\n"
            "with Workers(1) as w: codec.encode([b], 1000, codec.Codec(), w)\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
            % (str(ROOT), sorted(p.stem for p in (ROOT / "benchmark" /
                                 "reference").glob("*.py"))))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    mods = set(json.loads(p.stdout.strip().splitlines()[-1].replace("'",
                                                                      '"')))
    assert not mods & {"icer_compression_tpu_torch", "icer_compression_tpu",
                       "jax", "torch"}


def test_tactical_cell_on_the_card(card):
    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                        "mer1024.tactical_1bpp", "--seed", str(SEED),
                        "--seconds", "3", "--trace", "0"],
                       capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"]
