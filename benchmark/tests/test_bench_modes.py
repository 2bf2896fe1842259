"""A traffic mode, and the reference that judges it, brought as files
(``benchmark/modes/<mode>.py``): a tiny cell whose mode is a file runs
end to end on the CPU, its reference hook decides ``correct``, the
controls fail through the hook, and a mode that is not a plain file name
or has no file fails the run."""

import json

import numpy as np
import pytest

from benchmark import check, frames, load, run
from benchmark.tests.conftest import TINY

SEED = 2 ** 31 + 7

# A mode a later cell could bring: ``compress_batch`` over a seeded pool,
# then ``decompress`` of every stream; its reference delegates to the
# grayscale one and records the controls it was handed.
MODE = '''
"""compress_batch over a pool, then decompress of each stream."""
import time

import numpy as np

from benchmark import check, frames, load

CALLS = []


def run(run, seconds, profile, dev):
    from icer_compression_tpu_torch.models import grayscale as G
    c, t = run.config, run.traffic
    cfg = load.codec_config(c, t)
    pool = frames.pool(c, run.seed, t["pool"])
    G.compress_batch(pool, cfg, device=dev)
    with load._window(run, profile, dev):
        for _ in range(t["rounds"]):
            run.attempted += len(pool)
            t0 = time.perf_counter()
            streams = G.compress_batch(pool, cfg, device=dev)
            run.requests.append((load.ENCODE, t0, time.perf_counter(),
                                 len(pool) * run.mp))
            for k, s in enumerate(streams):
                px = G.decompress(s, cfg, dtype=np.uint16, device=dev)
                run.answers += [(k, "stream", s), (k, "pixels", px)]
            run.answered += len(streams)
    run.pool = pool
    run.check_keys = set(load._check_keys(run, range(t["pool"])))
    return []


def reference(run, quota, workers, control):
    CALLS.append(control)
    return check.reference(run, quota, workers, control)
'''

# a quota past the lossless stream (at 48x40 the headers alone take w*h
# bytes), so that every plane is in and one plane short alters pixels
TRAFFIC = {"mode": "batch_then_decode", "pool": 2, "quota_bpp": 128.0,
           "rounds": 1, "check_frames": 2}


@pytest.fixture
def moded(tiny, tmp_path, monkeypatch):
    """(bench, traffic dir, modes dir, loaded modules): the tiny
    BENCHMARK.json with a cell ``tiny.modefile`` whose traffic names the
    mode file above, kept in a modes directory of its own; each module the
    harness loads from it is appended to the list."""
    bench, tdir = tiny
    mdir = tmp_path / "modes"
    mdir.mkdir()
    (mdir / "batch_then_decode.py").write_text(MODE)
    (tdir / "modefile.json").write_text(json.dumps(TRAFFIC))
    bench["workloads"].append({"name": "tiny.modefile", "config": "tiny",
                               "traffic": "modefile", "chips": 1,
                               "why": "t"})
    loaded = []
    orig = load.mode_file

    def spy(name, modes_dir):
        loaded.append(orig(name, modes_dir))
        return loaded[-1]
    monkeypatch.setattr(load, "mode_file", spy)
    return bench, tdir, mdir, loaded


def _execute(moded, trace=False, **kw):
    bench, tdir, mdir, _ = moded
    return run.execute(bench, "tiny.modefile", SEED, 1.0, trace, dev="cpu",
                       workers=0, traffic_dir=tdir, modes_dir=mdir, **kw)


@pytest.mark.parametrize("trace", [False, True])
def test_a_new_mode_is_a_file(moded, trace):
    """The mode file runs end to end through ``run.execute``, and its
    reference hook, not the built-in reference, judges the answers."""
    out = _execute(moded, trace)
    assert out["correct"], out["checks"]
    assert out["attempted"] == 2 and out["failed"] == 0
    assert {"streams_wrong", "pixels_wrong"} <= set(out["checks"])
    (mod,) = moded[3]
    assert mod.CALLS == [None]
    if not trace:
        assert "setup_s" in out["metrics"]


def test_a_mode_file_with_a_stream_flipped_fails(moded, monkeypatch):
    from icer_compression_tpu_torch.models import grayscale as G
    orig = G.compress_batch

    def flipped(images, cfg, **kw):
        out = orig(images, cfg, **kw)
        b = bytearray(out[0])
        b[-1] ^= 0x10
        return [bytes(b)] + out[1:]
    monkeypatch.setattr(G, "compress_batch", flipped)
    out = _execute(moded)
    assert not out["correct"]
    assert out["checks"]["streams_wrong"]["value"] >= 1


def test_a_control_fails_through_the_hook_in_a_run(moded):
    """The whole run with the mode's reference, one plane short, in the
    program's place: the hook is handed the control and the run fails."""
    out = _execute(moded, control="one_plane_short")
    assert not out["correct"]
    assert out["checks"]["pixels_wrong"]["value"] >= 1
    assert moded[3][0].CALLS == [None, "one_plane_short"]


@pytest.mark.parametrize("control,size,quota,number", [
    # lanes that fill the codeword buffer, as the built-in control's test
    ("unbounded_window", 512, 512 * 512, "streams_wrong"),
    ("one_plane_short", 256, 256 * 256 // 8, "pixels_wrong"),
])
def test_controls_fail_through_the_hook(tmp_path, control, size, quota,
                                        number):
    """Each of ``check.CONTROLS``, at a size where the built-in
    reference's control fails, fails through a mode file's hook too: the
    answers are the sound reference's and the hook puts the fault in."""
    assert control in check.CONTROLS
    (tmp_path / "batch_then_decode.py").write_text(MODE)
    mod = load.mode_file("batch_then_decode", tmp_path)
    config = dict(TINY, width=size, height=size)
    r = load.Run({"name": "t"}, config, {"mode": "batch_then_decode"},
                 SEED, False)
    r.pool = np.stack([frames.noisy(frames.tiled(size, size),
                                    np.random.default_rng(1), 6)])
    r.check_keys = {0}
    r.reference_hook = mod.reference
    sound = check.reference(r, quota, 2)
    r.answers = [(0, "stream", sound[0]["stream"]),
                 (0, "pixels", sound[0]["pixels"])]
    r.attempted = r.answered = 1
    numbers = dict((n, v) for n, v, _ in
                   check.run_check(r, quota, 2, control=control))
    assert numbers[number] > 0
    assert mod.CALLS == [None, control]


@pytest.mark.parametrize("mode", ["no_such_mode", "a/b", "../traffic",
                                  "..", "a..b", ""])
def test_a_mode_that_is_no_plain_file_fails(moded, mode):
    bench, tdir, mdir, _ = moded
    (tdir / "modefile.json").write_text(json.dumps(dict(TRAFFIC,
                                                        mode=mode)))
    with pytest.raises(run.Failed) as err:
        _execute(moded)
    if mode == "no_such_mode":
        assert str(mdir / "no_such_mode.py") in str(err.value)


def test_a_mode_file_without_run_fails(moded):
    (moded[2] / "batch_then_decode.py").write_text('"""No run."""\n')
    with pytest.raises(run.Failed, match="defines no run"):
        _execute(moded)


def _planes_run(planes):
    """A run whose one answer is ``planes``, a tuple of (h, w) planes."""
    r = load.Run({"name": "t"}, TINY, {"mode": "t"}, SEED, False)
    r.answers = [(0, "pixels", planes)]
    r.attempted = r.answered = 1
    return r


def test_a_tuple_of_planes_is_compared_plane_for_plane():
    """Colour's answer, ``(y, u, v)``, against the stacked ``(3, h, w)``
    reference: equal reads 0, one plane altered reads 1."""
    rng = np.random.default_rng(3)
    stacked = rng.integers(0, 256, (3, 40, 48)).astype(np.uint16)
    ref = {0: {"stream": b"", "pixels": stacked}}
    same = tuple(p.copy() for p in stacked)
    numbers = dict((n, v) for n, v, _ in check.compare(_planes_run(same),
                                                       ref))
    assert numbers["pixels_wrong"] == 0
    altered = list(same)
    altered[2] = altered[2].copy()
    altered[2][5, 7] ^= 1
    numbers = dict((n, v) for n, v, _ in
                   check.compare(_planes_run(tuple(altered)), ref))
    assert numbers["pixels_wrong"] == 1
