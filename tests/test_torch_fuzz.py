"""The port's differential fuzz (``utils/fuzz.py``, ``tests/fuzz_torch.py``)
on the CPU against the JAX package's host codec: a seeded run, its
sampling envelope, colour and batch trials, and what a mismatch leaves."""

import dataclasses
import json
import os
import tempfile

import numpy as np
import pytest

import fuzz_torch
from icer_compression_tpu_torch.core.subbands import dim_low
from icer_compression_tpu_torch.utils import fuzz
from test_torch_entropy_slim import one_torch_thread  # noqa: F401


def test_three_seeded_trials_against_jax():
    assert fuzz_torch.main(["--device", "cpu", "--against", "jax",
                            "--trials", "3", "--seed", "1",
                            "--max-side", "48"]) == 0


def test_sampler_stays_in_the_envelope():
    rng = np.random.default_rng(5)
    trials = [fuzz.sample(rng, i, max_side=160, big_side=1024)
              for i in range(300)]
    for t in trials:
        assert 8 <= min(t.w, t.h) and max(t.w, t.h) <= 1024
        assert 1 <= t.stages <= 6
        assert min(dim_low(t.w, t.stages), dim_low(t.h, t.stages)) >= 3
        assert 1 <= t.segments <= min(
            32, fuzz.smallest_subband(t.w, t.h, t.stages))
        assert len(t.images) == {"gray": 1, "color": 3}.get(
            t.kind, len(t.images)) and all(
            img.shape == (t.h, t.w) and img.dtype == t.dtype
            for img in t.images)
        if t.kind == "batch":
            assert 2 <= len(t.images) <= 4
        assert t.quota >= 28
        assert t.two_word_from in (None,) + fuzz.TWO_WORD_FROM
    assert {t.filt for t in trials} == set(range(7))
    assert any(t.quota < 64 for t in trials)
    assert {k for t in trials for k in t.content} == set(range(5))
    assert any(t.two_word_from for t in trials)
    assert {t.stages for t in trials} == set(range(1, 7))
    assert {t.kind for t in trials} == {"gray", "color", "batch"}
    assert {np.dtype(t.dtype).name for t in trials} == {"uint8", "uint16"}
    assert any(max(t.w, t.h) > 160 for t in trials)
    assert max(t.segments for t in trials) == 32
    small = [fuzz.sample(rng, i, max_side=48, big_side=48)
             for i in range(100)]
    assert max(max(t.w, t.h) for t in small) <= 48


@pytest.mark.parametrize("shares", [(0, 1, 0), (0, 0, 1)],
                         ids=["colour", "batch"])
def test_colour_and_batch_trials_agree(shares):
    rng = np.random.default_rng(8)
    port, ref = fuzz.port_codec("cpu"), fuzz_torch.jax_codec()
    for i in range(2):
        trial = fuzz.sample(rng, i, max_side=40, big_side=40, shares=shares)
        assert trial.kind == ("color" if shares[1] else "batch")
        problem, _streams = fuzz.compare(trial, port, ref)
        assert problem is None


def test_a_batch_with_a_refused_decode_agrees():
    """A quota of 45 bytes leaves a noisy image's stream without a
    segment: the reference refuses its decode (DECODER_OUT_OF_DATA), so
    the port's batch decode must be refused with that status, as the
    JAX package's batch decode is; a batch decode that returns pixels
    there is a mismatch."""
    noise = fuzz.content(np.random.default_rng(1), 133, 129, 4, np.uint16)
    flat = np.full((133, 129), 7, np.uint16)
    trial = fuzz.Trial(0, "batch", 129, 133, 1, 0, 30, 45, np.uint16,
                       [3, 4], [flat, noise])
    port, ref = fuzz.port_codec("cpu"), fuzz_torch.jax_codec()
    assert ref.compress(noise, trial.config) == b""
    assert fuzz.compare(trial, port, ref)[0] is None
    lenient = dataclasses.replace(port, decompress_batch=lambda ss, cfg, dt: [
        ref.decompress(s, cfg, dt) if s else np.zeros((133, 129), dt)
        for s in ss])
    problem, _streams = fuzz.compare(trial, lenient, ref)
    assert problem and "reference refusals ['DECODER_OUT_OF_DATA']" in problem


def test_a_mismatch_is_dumped_and_counted(tmp_path, monkeypatch):
    """A port whose streams differ by one byte: every trial that encodes
    is a mismatch, dumped with its configuration, images and streams."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    ref = fuzz_torch.jax_codec()

    def flip(stream):
        return stream[:-1] + bytes([stream[-1] ^ 1])

    broken = fuzz.Codec(
        "broken", lambda img, cfg: flip(ref.compress(img, cfg)),
        ref.decompress, lambda *a: flip(ref.compress_yuv(*a)),
        ref.decompress_yuv,
        lambda imgs, cfg: [flip(ref.compress(i, cfg)) for i in imgs],
        lambda ss, cfg, dt: [ref.decompress(s, cfg, dt) for s in ss])
    out = fuzz.run(broken, ref, trials=3, seed=2, max_side=24,
                   big_side=24, log=lambda msg: None)
    assert out["trials"] == 3 and out["mismatches"]
    _n, problem, where = out["mismatches"][0]
    assert os.path.dirname(where) == str(tmp_path)
    info = json.load(open(os.path.join(where, "trial.json")))
    assert info["problem"] == problem
    assert os.path.exists(os.path.join(where, "image0.npy"))
    assert any(f.endswith(".icer") for f in os.listdir(where))
    monkeypatch.setattr(fuzz, "port_codec", lambda device: broken)
    assert fuzz_torch.main(["--device", "cpu", "--against", "jax",
                            "--trials", "2", "--seed", "2",
                            "--max-side", "24"]) == 1
