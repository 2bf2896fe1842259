"""Each coder's pass and call plan (``ops/encode.CODER_DIVISORS``): the
``auto``, ``slim`` and ``pallas`` plans keep the single word budget's
passes and calls, ``sorted`` takes a third of them, and a ``sorted`` batch
gives the same streams in one pass or in several (the JAX package's
``G.compress`` of each image)."""

import numpy as np
import pytest

from icer_compression_tpu.models import grayscale as G
from icer_compression_tpu_torch.models import grayscale as T
from icer_compression_tpu_torch.ops import encode as E
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
