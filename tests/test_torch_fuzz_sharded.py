"""The sharded trials of the port's differential fuzz (``utils/fuzz.py``,
``tests/fuzz_torch.py --sharded``) on the CPU: the sampler's envelope, a
gloo world of two running a fixed list of trials against the JAX
package's host codec, and what a broken sharded codec leaves."""

import json
import os
import tempfile

import numpy as np

import fuzz_torch
from icer_compression_tpu_torch.core.subbands import dim_low
from icer_compression_tpu_torch.utils import fuzz

# the world's trials: seed 114 draws both meshes with both grayscale
# decoders, colour batches, two quotas under 64 bytes and, on the 2 x 1
# mesh, a batch whose stream of 30 bytes holds no segment (its decode is
# refused); 7 of the 8 batches encode
WORLD_SEED, WORLD_TRIALS = 114, 8


def test_sharded_sampler_stays_in_the_envelope():
    trials = fuzz.sharded_trials(5, 300)
    for t in trials:
        assert t.kind == "sharded" and t.mesh in fuzz.SHARDED_MESHES
        assert 8 <= min(t.w, t.h) and max(t.w, t.h) <= 1024
        assert 1 <= t.stages <= 6
        assert min(dim_low(t.w, t.stages), dim_low(t.h, t.stages)) >= 3
        assert 1 <= t.segments <= min(
            32, fuzz.smallest_subband(t.w, t.h, t.stages))
        assert t.planes in (1, 3) and len(t.images) % t.planes == 0
        count = len(t.images) // t.planes
        assert 1 <= count <= 4 and count % t.mesh[0] == 0
        assert all(img.shape == (t.h, t.w) and img.dtype == t.dtype
                   for img in t.images)
        assert len(set(t.content)) == 1
        assert t.quota >= 28
        assert t.two_word_from in (None,) + fuzz.TWO_WORD_FROM
        assert t.decoder in ("mesh", "round robin")
        assert t.describe()["mesh"] == list(t.mesh)
    assert {t.mesh for t in trials} == set(fuzz.SHARDED_MESHES)
    assert {t.planes for t in trials} == {1, 3}
    assert any(t.quota < 64 for t in trials)
    assert {t.filt for t in trials} == set(range(7))
    assert {t.stages for t in trials} == set(range(1, 7))
    assert {k for t in trials for k in t.content} == set(range(5))
    assert {np.dtype(t.dtype).name for t in trials} == {"uint8", "uint16"}
    assert any(t.two_word_from for t in trials)
    assert max(t.segments for t in trials) == 32
    assert any(max(t.w, t.h) > 160 for t in trials)
    assert {len(t.images) // t.planes for t in trials} == {1, 2, 3, 4}
    small = fuzz.sharded_trials(5, 100, 40, 40, 16)
    assert all(16 <= min(t.w, t.h) and max(t.w, t.h) <= 40 for t in small)
    again = fuzz.sharded_trials(5, 3)
    assert [t.describe() for t in again] == [
        t.describe() for t in trials[:3]]
    assert all(np.array_equal(a, b) for s, t in zip(again, trials)
               for a, b in zip(s.images, t.images))


def test_a_gloo_world_of_sharded_trials_agrees_with_jax():
    """Both ranks run the fixed list through the port's sharded classes on
    the CPU while this process runs the JAX package's host codec: no
    mismatch, the segment-less batch's decode refused with the
    reference's status on both ranks."""
    trials = fuzz.sharded_trials(WORLD_SEED, WORLD_TRIALS, 40, 40, 16)
    assert {t.mesh for t in trials} == set(fuzz.SHARDED_MESHES)
    out = fuzz_torch.sharded_world(fuzz_torch.jax_codec(), WORLD_SEED,
                                   WORLD_TRIALS, 40, 40, 16)
    assert out["mismatches"] == []
    assert out["trials"] == WORLD_TRIALS
    assert out["per_mesh"] == {"1x2": 4, "2x1": 4}
    assert out["color"] >= 1 and out["tiny_quota"] == 2
    assert out["per_quota"]["28-63 B"] == 2 and len(out["per_quota"]) >= 3
    assert out["refused"] == 2


def _ranks_from(ref, trials, flip_rank=None):
    """Rank results made from the reference's own calls (the streams'
    last byte flipped on ``flip_rank``; -1: on both ranks)."""
    ranks = [[], []]
    for t in trials:
        r = fuzz.sharded_reference(t, ref)
        bad = [s for k, s in r["encode"] if k != "ok"]
        streams = [s for _k, s in r["encode"]]
        for rank in range(2):
            got = streams
            if flip_rank in (rank, -1) and not bad:
                got = [s[:-1] + bytes([s[-1] ^ 1]) if s else s
                       for s in streams]
            dec = None if bad or t.planes == 3 else ("ok", [
                px for _k, px in r["decode"]])
            ranks[rank].append({
                "trial": t.describe(),
                "encode": ("error", bad[0]) if bad else ("ok", got),
                "decode": dec})
    return ranks


def test_a_broken_sharded_codec_is_dumped_and_counted(tmp_path,
                                                      monkeypatch):
    """Streams one byte off on both ranks, or on one rank only: every
    trial that encodes is a mismatch, dumped with its mesh, images and
    streams; the honest ranks give none."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    ref = fuzz_torch.jax_codec()
    trials = fuzz.sharded_trials(2, 4, 24, 24)
    refs = [fuzz.sharded_reference(t, ref) for t in trials]
    encodes = [all(k == "ok" for k, _s in r["encode"]) for r in refs]
    assert any(encodes)
    quiet = {"log": lambda msg: None}
    assert fuzz.check_sharded(trials, _ranks_from(ref, trials), refs,
                              **quiet)["mismatches"] == []
    for flip, why in ((-1, "sharded streams differ"),
                      (1, "ranks 0 and 1 disagree on the encode")):
        out = fuzz.check_sharded(trials, _ranks_from(ref, trials, flip),
                                 refs, **quiet)
        assert [i for i, _p, _w in out["mismatches"]] == [
            t.index for t, ok in zip(trials, encodes) if ok]
        _i, problem, where = out["mismatches"][0]
        assert problem.startswith(why)
        assert os.path.dirname(where) == str(tmp_path)
        info = json.load(open(os.path.join(where, "trial.json")))
        assert info["problem"] == problem
        assert info["mesh"] in ([1, 2], [2, 1])
        assert os.path.exists(os.path.join(where, "image0.npy"))
        assert any(f.startswith("rank1_") for f in os.listdir(where))
    other = _ranks_from(ref, trials)
    other[1][0]["trial"] = dict(other[1][0]["trial"], quota=1)
    out = fuzz.check_sharded(trials, other, refs, **quiet)
    assert out["mismatches"][0][1] == "a rank drew another trial"


def test_a_disagreement_says_how_the_ranks_differ():
    ok = ("ok", [np.zeros(3, np.uint16), np.ones(2, np.uint16)])
    assert fuzz._which(ok, ("crash", "CUDA error: an illegal address")) \
        == " (ok 2 streams against crash CUDA error: an illegal address)"
    other = ("ok", [np.zeros(3, np.uint16), np.zeros(2, np.uint16)])
    assert fuzz._which(ok, other) == " (output 1 first)"
    assert fuzz._which(None, ok).startswith(" (None  against ok")
