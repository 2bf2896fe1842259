"""The ``auto`` coder on the CPU: kernel 1 (``slim``) on every bucket, its
fused-key instance where ``entropy_slim.fused_key_ok`` holds and its
two-word instance, with the side buffer sized by ``eviction_rows``, on
longer lanes, at any length.

Long lanes cost minutes through the plain kernels, so most tests lower
the fused-key limit (``entropy_slim.fused_key_ok``) with ``monkeypatch``:
boat crops then have buckets on both instances, and every entry point
must still give the JAX package's stream byte for byte.  The one encode
with lanes of 2^17 slots is tests/test_torch_big_images_limit.py.  The
pins of ``chip_smoke.py``'s large-image phase are recomputed here with
the JAX package's host codec."""

import os
import sys

import numpy as np
import pytest

from conftest import make_test_image
from icer_compression_tpu.core.status import IcerError as JaxIcerError
from icer_compression_tpu.models import color as CL
from icer_compression_tpu.models import grayscale as G
from icer_compression_tpu_torch import cli
from icer_compression_tpu_torch.core.status import IcerError, IcerStatus
from icer_compression_tpu_torch.models import color as TC
from icer_compression_tpu_torch.models import grayscale as T
from icer_compression_tpu_torch.ops import encode as E
from icer_compression_tpu_torch.ops import entropy_slim as ES
from icer_compression_tpu_torch.utils import image_io as IO
from icer_compression_tpu_torch.utils.colorspace import rgb_to_ycbcr
from test_torch_entropy_slim import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")
LOW = 512           # the fused-key limit, lowered: 64x64 stage 1 is past it


def _boat(dtype=np.uint16):
    return IO.read_png(os.path.join(DATA, "boat.512.png")).astype(dtype)


def _crop(side=64, dtype=np.uint16):
    return np.ascontiguousarray(_boat(dtype)[224:224 + side,
                                             224:224 + side])


def _lower_fused_key_limit(monkeypatch):
    monkeypatch.setattr(ES, "fused_key_ok", lambda L: L < LOW)


@pytest.fixture()
def low_limit(monkeypatch):
    """The fused-key limit lowered to ``LOW`` slots, a fresh encoder
    cache, and kernel 1's calls counted per instance: {"fused": ...,
    "two_word": ...}."""
    _lower_fused_key_limit(monkeypatch)
    monkeypatch.setattr(T, "_ENCODERS", {})
    calls = {"fused": 0, "two_word": 0}
    for name, key in (("encode_lanes_slim", "fused"),
                      ("encode_lanes_slim_two_word", "two_word")):
        real = getattr(ES, name)

        def counted(*a, real=real, key=key):
            calls[key] += 1
            return real(*a)

        monkeypatch.setattr(ES, name, counted)
    return calls


S4G6 = (4, 6, np.uint16)
F, W = "fused", "two-word"


@pytest.mark.parametrize("w,h,geometry,modes", [
    (512, 512, S4G6, (F, F, F, F)),
    (1024, 1024, S4G6, (W, F, F, F)),
    (1600, 1200, S4G6, (W, W, F, F)),
    (2048, 2048, S4G6, (W, W, F, F)),
    (5120, 3840, S4G6, (W, W, W, F)),
    (512, 512, (1, 1, np.uint16), (W,)),
    (512, 512, (1, 1, np.uint8), (W,)),
])
def test_auto_plans_each_bucket_from_its_length(w, h, geometry, modes):
    """Kernel 1 on every bucket at the CLI's defaults (s4 fA g6) and at
    one stage and one segment (boat 512's lanes of exactly 2^17 slots):
    the fused-key instance where ``fused_key_ok`` holds, the two-word one
    elsewhere; ``slim`` plans the same geometries the same way.  One
    5120x3840 image's stage-1 bucket passes ``CALL_WORDS`` and is coded
    in two calls."""
    stages, segments, dtype = geometry
    cfg = T.CodecConfig(stages, 0, segments, None)
    enc = T.make_encoder(w, h, cfg, dtype, "cpu")
    assert enc.entropy == "auto" and enc.bucket_coders == ("slim",) * len(
        modes)
    assert tuple(F if ES.fused_key_ok(E.bucket_sizes(b["L"])[0]) else W
                 for b in enc.buckets) == modes
    calls = [-(-b["rows"] // b["call_rows"]) for b in enc.buckets]
    assert calls == ([2, 1, 1, 1] if w == 5120 else [1] * len(calls))
    slim = T.make_encoder(w, h, cfg, dtype, "cpu", entropy="slim")
    assert slim.bucket_coders == enc.bucket_coders
    assert [b["L"] for b in slim.buckets] == [b["L"] for b in enc.buckets]


def test_auto_compress_equals_jax_package(low_limit):
    """``compress`` and its encoder at the lowered limit: stage 1 on the
    two-word instance, the rest on the fused-key one, the JAX package's
    stream."""
    crop = _crop()
    cfg = T.CodecConfig(4, 0, 6, None)
    enc = T.make_encoder(64, 64, cfg, np.uint16, "cpu")
    assert enc.bucket_coders == ("slim",) * 4
    assert T.compress(crop, cfg, device="cpu") \
        == G.compress(crop, G.CodecConfig(4, 0, 6, None))
    assert low_limit == {"fused": 3, "two_word": 1}


def test_auto_compress_batch_widening_equals_jax_package(low_limit):
    """A batch at a quota whose prefix class has to widen (the flat image
    of tests/test_torch_codec.py at one stage, whose one bucket is past
    the lowered limit): each window's encoder runs the two-word instance,
    and the streams equal the JAX package's."""
    rng = np.random.default_rng(3)
    img = (100 + (rng.random((64, 64)) < 0.01)).astype(np.uint8)
    imgs = np.stack([img, img[::-1]])
    stats = {}
    out = T.compress_batch(imgs, T.CodecConfig(1, 0, 1, 816), device="cpu",
                           stats=stats)
    assert stats["escalations"] > 0
    assert out == [G.compress(im, G.CodecConfig(1, 0, 1, 816))
                   for im in imgs]
    assert low_limit == {"fused": 0, "two_word": 1 + stats["escalations"]}


def test_auto_compress_yuv_equals_jax_package(low_limit):
    """The colour codec's three canvases through both instances."""
    rgb = np.stack([_crop(dtype=np.uint8), _crop(dtype=np.uint8).T,
                    np.roll(_crop(dtype=np.uint8), 7, axis=1)], axis=-1)
    planes = tuple(c.astype(np.uint16) for c in rgb_to_ycbcr(rgb))
    cfg = T.CodecConfig(4, 0, 6, None)
    out = TC.compress_yuv(*planes, cfg, device="cpu")
    assert out == CL.compress_yuv(*planes, G.CodecConfig(4, 0, 6, None))
    assert TC.compress_yuv_batch([planes[0]], [planes[1]], [planes[2]], cfg,
                                 device="cpu") == [out]
    assert low_limit["two_word"] > 0 and low_limit["fused"] > 0


def test_auto_cli_batch_compress_equals_jax_package(low_limit, tmp_path):
    """The CLI's batch-compress at its defaults (its encoder from
    ``make_encoder``): each stream equals the JAX host codec's at the
    CLI's default quota."""
    rng = np.random.default_rng(21)
    src = tmp_path / "in"
    src.mkdir()
    imgs = [make_test_image(64, 64, rng, dtype=np.uint8, amplitude=180,
                            noise=20) for _ in range(2)]
    for i, im in enumerate(imgs):
        IO.write_png(src / f"g{i}.png", im)
    assert cli.main(["batch-compress", str(src), str(tmp_path / "enc"),
                     "--device", "cpu"]) == 0
    cfg = G.CodecConfig(4, 0, 6, 64 * 64)
    for i, im in enumerate(imgs):
        assert (tmp_path / "enc" / f"g{i}.icer").read_bytes() \
            == G.compress(im.astype(np.uint16), cfg)
    assert low_limit["two_word"] > 0 and low_limit["fused"] > 0


def test_auto_sharded_one_by_one_equals_jax_package(low_limit, monkeypatch):
    """The single-process 1 x 1 mesh's ``ShardedGrayscaleEncoder``."""
    from icer_compression_tpu_torch.parallel import sharded
    for name in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
                 "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    mesh = sharded.make_mesh(device="cpu")
    crop = _crop()
    enc = sharded.ShardedGrayscaleEncoder(mesh, 64, 64, 4, 0, 6)
    assert enc.enc.bucket_coders == ("slim",) * 4
    cfg = G.CodecConfig(4, 0, 6, None)
    assert enc.compress_batch(np.stack([crop, crop.T]), cfg) \
        == [G.compress(crop, cfg), G.compress(np.ascontiguousarray(crop.T),
                                              cfg)]
    assert low_limit["two_word"] > 0


@pytest.mark.parametrize("entropy", ["auto", "sorted"])
def test_bucket_calls_in_runs_of_rows_give_the_same_tables(monkeypatch,
                                                           entropy):
    """A bucket past ``CALL_WORDS`` is coded in runs of rows: the tables
    equal one call's (here with both instances of kernel 1 under
    ``auto``)."""
    _lower_fused_key_limit(monkeypatch)
    crop = _crop()
    cfg = T.CodecConfig(4, 0, 6, None)
    whole = T.make_encoder(64, 64, cfg, np.uint16, "cpu", entropy=entropy)
    monkeypatch.setattr(E, "CALL_WORDS", 40 * 512)
    runs = T.make_encoder(64, 64, cfg, np.uint16, "cpu", entropy=entropy)
    assert [b["call_rows"] for b in runs.buckets][0] < whole.buckets[0][
        "rows"] <= whole.buckets[0]["call_rows"]
    imgs = np.stack([crop, crop[::-1]])
    assert runs.encode_batch(imgs) == whole.encode_batch(imgs)


def test_dwt_overflow_comes_before_the_coder(low_limit):
    """A uint8 image at one stage and one segment overflows the DWT: under
    ``auto`` that raises INTEGER_OVERFLOW, as ``compress_jax`` does, after
    the coder (here the two-word instance past the lowered limit) has
    run: the collect half reads the overflow flag."""
    crop = _crop(dtype=np.uint8)
    cfg = T.CodecConfig(1, 0, 1, None)
    with pytest.raises(JaxIcerError) as jax_err:
        G.compress_jax(crop, G.CodecConfig(1, 0, 1, None))
    assert jax_err.value.status.name == "INTEGER_OVERFLOW"
    assert T.make_encoder(64, 64, cfg, np.uint8,
                          "cpu").bucket_coders == ("slim",)
    with pytest.raises(IcerError) as err:
        T.compress(crop, cfg, device="cpu")
    assert err.value.status == IcerStatus.INTEGER_OVERFLOW
    assert low_limit == {"fused": 0, "two_word": 1}


def test_pinned_big_image_references():
    """Every entry of tests/data/golden_big_images.sha256 (chip_smoke.py
    phase 25), recomputed with the JAX package's host codec."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        import pin_big_images
    finally:
        sys.path.pop(0)
    with open(os.path.join(DATA, "golden_big_images.sha256")) as f:
        want = [tuple(ln.split(None, 1)) for ln in f.read().splitlines()]
    assert pin_big_images.pins() == want
