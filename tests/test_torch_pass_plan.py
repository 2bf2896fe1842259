"""Each coder's pass and call plan (``ops/encode.CODER_DIVISORS``): the
``auto``, ``slim`` and ``pallas`` plans keep the single word budget's
passes and calls, ``sorted`` takes a third of them, and a ``sorted`` batch
gives the same streams in one pass or in several (the JAX package's
``G.compress`` of each image).  A batch split into passes runs them all
of one size, the last padded with all-zero images, with the streams of
one pass."""

import functools

import numpy as np
import pytest

from icer_compression_tpu.models import grayscale as G
from icer_compression_tpu_torch.models import grayscale as T
from icer_compression_tpu_torch.ops import encode as E
from icer_compression_tpu_torch.ops import entropy_slim as ES
from icer_compression_tpu_torch.utils import trace
from test_torch_entropy_slim import one_torch_thread  # noqa: F401

# (pass_images, every bucket's call_rows) that PASS_WORDS = CALL_WORDS =
# 2^27 gave every coder before each had its own plan, at the CLI's
# defaults (stages 4, filter A, 6 segments, uint16)
SLIM_PLANS = {(512, 512): (37, [6096, 23831, 87381, 262144]),
              (1024, 1024): (9, [1533, 6096, 23831, 87381]),
              (5120, 3840): (1, [81, 327, 1304, 5190])}
SORTED_PLANS = {(512, 512): (12, [2032, 7943, 29127, 87381]),
                (1024, 1024): (3, [511, 2032, 7943, 29127]),
                (5120, 3840): (1, [27, 109, 434, 1730])}


def plan(w, h, entropy):
    enc = E.TorchGrayscaleEncoder(w, h, 4, 0, 6, 15, "cpu", entropy=entropy)
    return enc.pass_images, [b["call_rows"] for b in enc.buckets], enc


@pytest.mark.parametrize("geometry", sorted(SLIM_PLANS),
                         ids=lambda g: "{}x{}".format(*g))
def test_auto_slim_and_pallas_keep_the_single_budget(geometry):
    """The default path's plan does not move: boat 512 (a batch of 8 is
    one pass), 1024x1024 and 5120x3840 (stage 1 in two calls)."""
    for entropy in ("auto", "slim", "pallas"):
        images, calls, enc = plan(*geometry, entropy)
        assert (images, calls) == SLIM_PLANS[geometry], entropy
        assert enc.bucket_coders == (("slim",) if entropy == "auto"
                                     else (entropy,)) * 4
    assert E.CODER_DIVISORS["slim"] == E.CODER_DIVISORS["pallas"] == 1
    assert E.PASS_WORDS == E.CALL_WORDS == 1 << 27


@pytest.mark.parametrize("geometry", sorted(SORTED_PLANS),
                         ids=lambda g: "{}x{}".format(*g))
def test_sorted_passes_and_calls_are_a_third(geometry):
    images, calls, enc = plan(*geometry, "sorted")
    assert (images, calls) == SORTED_PLANS[geometry]
    div = E.CODER_DIVISORS["sorted"]
    assert div == 3
    assert images == max(1, E.PASS_WORDS // div // enc.words_per_image)
    assert calls == [max(1, E.CALL_WORDS // div
                         // E.bucket_sizes(b["L"])[0]) for b in enc.buckets]
    # each call's coder words stay within a third of slim's
    assert all(n * E.bucket_sizes(b["L"])[0] <= E.CALL_WORDS // div
               for n, b in zip(calls, enc.buckets))


def test_sorted_streams_do_not_depend_on_the_split(monkeypatch):
    """Five images through ``sorted``, lossless (the encoder's own plane
    windows, so no cached encoder runs), as one pass, then with the budgets
    lowered (in this test) to one image a pass and a few rows a call:
    the same streams, each equal to the JAX package's ``G.compress``."""
    rng = np.random.default_rng(13)
    h, w = 20, 24
    ramp = np.add.outer(np.arange(h) * 3, np.arange(w)) % 150
    imgs = (ramp + rng.integers(0, 60, (5, h, w))).astype(np.uint16)
    cfg = T.CodecConfig(2, 1, 3, None)
    whole = T.make_encoder(w, h, cfg, np.uint16, "cpu", entropy="sorted")
    assert whole.pass_images >= len(imgs)
    assert all(b["call_rows"] >= b["rows"] for b in whole.buckets)
    one = T.compress_batch(imgs, cfg, encoder=whole)

    monkeypatch.setattr(E, "PASS_WORDS", 3 * whole.words_per_image)
    monkeypatch.setattr(E, "CALL_WORDS", 3 * 40 * E.bucket_sizes(
        whole.buckets[0]["L"])[0])
    split = T.make_encoder(w, h, cfg, np.uint16, "cpu", entropy="sorted")
    assert split.pass_images == 1
    assert split.buckets[0]["call_rows"] == 40 < split.buckets[0]["rows"]
    slim = T.make_encoder(w, h, cfg, np.uint16, "cpu", entropy="slim")
    assert slim.pass_images == 3
    passes = []
    real = split._dispatch
    monkeypatch.setattr(split, "_dispatch",
                        lambda x: passes.append(len(x)) or real(x))
    several = T.compress_batch(imgs, cfg, encoder=split)
    assert passes == [1] * len(imgs)
    assert several == one
    jcfg = G.CodecConfig(2, 1, 3, None)
    assert one == [G.compress(im, jcfg) for im in imgs]


def pad_counts(monkeypatch) -> list:
    """The ``encode.pad_images`` count of each batch encoded from now on
    (``utils/trace.count`` watched in this test)."""
    got = []
    real = trace.count

    def count(name, n=1):
        if name == "encode.pad_images":
            got.append(n)
        real(name, n)
    monkeypatch.setattr(trace, "count", count)
    return got


@functools.lru_cache(maxsize=None)
def _split_images():
    """Eight 20x24 images and the JAX package's lossless stream of each
    (stages 2, filter B, 3 segments)."""
    rng = np.random.default_rng(21)
    ramp = np.add.outer(np.arange(20) * 5, np.arange(24)) % 140
    imgs = (ramp + rng.integers(0, 70, (8, 20, 24))).astype(np.uint16)
    jcfg = G.CodecConfig(2, 1, 3, None)
    return imgs, tuple(G.compress(im, jcfg) for im in imgs)


@pytest.mark.parametrize("n_images", [1, 2, 3, 4, 5, 7, 8])
def test_passes_are_of_one_size(monkeypatch, n_images):
    """N images with passes of at most P = 3 (``PASS_WORDS`` lowered in
    this test) run as n = ceil(N / P) passes of s = ceil(N / n) each, one
    graph key, the last padded with n * s - N all-zero images that
    ``encode.pad_images`` counts; the streams equal one pass's and the
    JAX package's."""
    imgs, want = _split_images()
    imgs = imgs[:n_images]
    cfg = T.CodecConfig(2, 1, 3, None)
    whole = T.make_encoder(24, 20, cfg, np.uint16, "cpu")
    assert whole.pass_images >= len(imgs)
    one = T.compress_batch(imgs, cfg, encoder=whole)

    monkeypatch.setattr(E, "PASS_WORDS", 3 * whole.words_per_image)
    split = T.make_encoder(24, 20, cfg, np.uint16, "cpu")
    assert split.pass_images == 3
    n = -(-n_images // 3)
    s = -(-n_images // n)
    passes = []
    real = split._dispatch
    monkeypatch.setattr(split, "_dispatch",
                        lambda x: passes.append(len(x)) or real(x))
    pads = pad_counts(monkeypatch)
    got = T.compress_batch(imgs, cfg, encoder=split)
    assert passes == [s] * n
    assert pads == [n * s - n_images]
    assert got == one == list(want[:n_images])


def test_padding_is_skipped_in_a_bucket_of_several_groups(monkeypatch):
    """Every stage group in one bucket (``_plan_buckets`` replaced in this
    test; the planned buckets hold one group each at these sizes): the
    rows of the padding image sit between one group's rows and the next,
    and the 5 images, in passes of 3 padded to 6, still give the JAX
    package's streams."""
    real_plan = E._plan_buckets

    def one_bucket(groups):
        order = [gi for b in real_plan(groups) for gi in b["groups"]]
        return [{"groups": order, "L": max(g["L"] for g in groups)}]
    monkeypatch.setattr(E, "_plan_buckets", one_bucket)
    imgs, want = _split_images()
    imgs = imgs[:5]
    cfg = T.CodecConfig(2, 1, 3, None)
    whole = T.make_encoder(24, 20, cfg, np.uint16, "cpu")
    assert len(whole.buckets) == 1 and len(whole.buckets[0]["groups"]) == 2
    monkeypatch.setattr(E, "PASS_WORDS", 3 * whole.words_per_image)
    split = T.make_encoder(24, 20, cfg, np.uint16, "cpu")
    pads = pad_counts(monkeypatch)
    assert T.compress_batch(imgs, cfg, encoder=split) == list(want[:5])
    assert split.pass_images == 3 and pads == [1]


def _flag_every_third_slim_lane(monkeypatch):
    real = ES.encode_lanes_slim

    def flag_every_third(words):
        rec, fstate, misc, ev = real(words)
        misc = misc.clone()
        misc[0, ::3] = 1
        return rec, fstate, misc, ev
    monkeypatch.setattr(ES, "encode_lanes_slim", flag_every_third)


def _encoder_of_passes_of_three(monkeypatch):
    cfg = T.CodecConfig(2, 1, 3, None)
    words = T.make_encoder(24, 20, cfg, np.uint16, "cpu").words_per_image
    monkeypatch.setattr(E, "PASS_WORDS", 3 * words)
    enc = T.make_encoder(24, 20, cfg, np.uint16, "cpu")
    assert enc.pass_images == 3
    return cfg, enc


@pytest.mark.parametrize("n_images", [2, 4, 5])
def test_flagged_lanes_reencode_from_their_pass_run_again(monkeypatch,
                                                          n_images):
    """Every third slim lane flagged (the coder's output altered in this
    test), passes of at most 3 images (the last padded), and two batches
    dispatched before either collector is called: no pass keeps its
    coder words, so each pass with flagged lanes runs again, once, on its
    own input, and the streams equal the JAX package's."""
    _flag_every_third_slim_lane(monkeypatch)
    imgs, want = _split_images()
    cfg, enc = _encoder_of_passes_of_three(monkeypatch)
    inputs = []
    device_pass = enc.device_pass
    monkeypatch.setattr(enc, "device_pass",
                        lambda x: inputs.append(x) or device_pass(x))
    order = [list(range(n_images)), list(range(8 - n_images, 8))[::-1]]
    collectors = [enc.encode_batch(imgs[o], defer=True) for o in order]
    got = [T.allocate_streams(c(), cfg, enc) for c in collectors[::-1]]
    assert got[::-1] == [[want[i] for i in o] for o in order]
    assert enc.fallback_lanes > 0
    n = -(-n_images // 3)
    assert len(inputs) == 4 * n
    assert sorted(map(id, inputs)) == sorted(
        [id(x) for x in {id(x): x for x in inputs}.values()] * 2)


def test_a_dispatch_collects_the_passes_already_done(monkeypatch):
    """Between its passes a dispatch half collects the encoder's earlier
    passes whose copies are done, in dispatch order, and none whose copies
    are not (``Pending.ready`` set in this test): a deferred batch's
    results reach ``each`` during the next batch's dispatch, before its
    collector is called; the streams are the JAX package's."""
    imgs, want = _split_images()
    cfg, enc = _encoder_of_passes_of_three(monkeypatch)
    ready = [False]
    monkeypatch.setattr(E.Pending, "ready", lambda self: ready[0])
    seen = []
    first = enc.encode_batch(imgs[:5], defer=True, each=seen.append)
    assert seen == [] and len(enc._queued) == 2
    ready[0] = True
    second = enc.encode_batch(imgs[5:], defer=True)
    assert len(seen) == 5 and len(enc._queued) == 1
    assert T.allocate_streams(first(), cfg, enc) == list(want[:5])
    assert T.allocate_streams(second(), cfg, enc) == list(want[5:])
    assert len(enc._queued) == 0
