"""The port's CLI and image IO on the CPU (``--device cpu``).

The CLI tests mirror tests/test_cli.py.  The single-image operations also
run the JAX package's CLI (on its default host path) on the same inputs
and flags: the port's ``.icer`` streams must be byte-equal to it and its
decoded PNGs pixel-equal (the files' bytes may differ: the two PNG writers
compress differently).  The JAX CLI's batch operations have no host path
(they run the JAX device pipeline, minutes on a CPU), so the port's batch
outputs are held against the JAX package's host codec per image, as
tests/test_cli.py holds the JAX CLI's.  The image IO tests hold the port's
PNG reader and writer against Pillow."""

import io
import os
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from conftest import make_test_image
from icer_compression_tpu import cli as jax_cli
from icer_compression_tpu.models import color as CL
from icer_compression_tpu.models import grayscale as G
from icer_compression_tpu.utils.colorspace import rgb_to_ycbcr, ycbcr_to_rgb
from icer_compression_tpu.utils import image_io as JIO
from icer_compression_tpu_torch import cli
from icer_compression_tpu_torch.utils import image_io as IO
from test_torch_entropy_slim import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def port(args):
    return cli.main(args + ["--device", "cpu"])


def both(args):
    """Run the port's CLI on the CPU and the JAX package's CLI with the
    same arguments, the JAX one writing beside each output path with a
    ``jax_`` prefix; returns their exit codes."""
    def prefixed(path):
        d, f = os.path.split(path)
        return os.path.join(d, "jax_" + f)
    jargs = list(args)
    jargs[2] = prefixed(args[2])
    return port(args), jax_cli.main(jargs)


def png(path):
    return np.asarray(Image.open(path))


@pytest.fixture()
def gray_png(tmp_path):
    rng = np.random.default_rng(12345)
    img = make_test_image(40, 48, rng, dtype=np.uint8, amplitude=180,
                          noise=30)
    p = tmp_path / "in.png"
    Image.fromarray(img, mode="L").save(p)
    return p, img


def test_cli_gray_roundtrip(tmp_path, gray_png):
    src, img = gray_png
    comp, back = tmp_path / "out.icer", tmp_path / "back.png"
    assert both(["compress", str(src), str(comp), "-s", "3", "-f", "A",
                 "-g", "4", "-G", "-t", "40000"]) == (0, 0)
    assert comp.read_bytes() == (tmp_path / "jax_out.icer").read_bytes()
    assert both(["decompress", str(comp), str(back), "-s", "3", "-f", "A",
                 "-g", "4", "-G"]) == (0, 0)
    assert np.array_equal(png(back), img)
    assert np.array_equal(png(back), png(tmp_path / "jax_back.png"))


def test_cli_quota_and_prefix(tmp_path, gray_png):
    src, img = gray_png
    comp = tmp_path / "out.icer"
    assert both(["compress", str(src), str(comp), "-s", "3", "-f", "A",
                 "-g", "4", "-G", "-t", "600"]) == (0, 0)
    size = comp.stat().st_size
    assert size <= 600
    assert comp.read_bytes() == (tmp_path / "jax_out.icer").read_bytes()
    back, pref = tmp_path / "back.png", tmp_path / "pref.png"
    flags = ["-s", "3", "-f", "A", "-g", "4", "-G"]
    assert both(["decompress", str(comp), str(back)] + flags) == (0, 0)
    assert both(["decompress", str(comp), str(pref)] + flags
                + ["--prefix", str(size // 2)]) == (0, 0)
    for name in ("back.png", "pref.png"):
        assert np.array_equal(png(tmp_path / name),
                              png(tmp_path / ("jax_" + name)))
    full = png(back).astype(float)
    part = png(pref).astype(float)
    ref = img.astype(float)
    # a stream prefix decodes to an approximation no better than the whole
    assert ((part - ref) ** 2).mean() >= ((full - ref) ** 2).mean()


def test_cli_color_roundtrip(tmp_path):
    rng = np.random.default_rng(12345)
    rgb = np.stack([make_test_image(40, 48, rng, dtype=np.uint8,
                                    amplitude=200, noise=20)
                    for _ in range(3)], axis=-1)
    src = tmp_path / "in.png"
    Image.fromarray(rgb, mode="RGB").save(src)
    comp, back = tmp_path / "out.icer", tmp_path / "back.png"
    assert both(["compress", str(src), str(comp), "-s", "2", "-f", "A",
                 "-g", "3", "-c", "-t", "80000"]) == (0, 0)
    assert comp.read_bytes() == (tmp_path / "jax_out.icer").read_bytes()
    assert both(["decompress", str(comp), str(back), "-s", "2", "-f", "A",
                 "-g", "3", "-c"]) == (0, 0)
    out = png(back)
    assert np.array_equal(out, png(tmp_path / "jax_back.png"))
    # the RGB <-> YCbCr integer macros are lossy (color_util.h)
    assert np.abs(out.astype(int) - rgb.astype(int)).max() <= 4


def test_cli_compress_long_lanes_equals_the_api(tmp_path):
    """A 256x256 PNG at one stage and one segment (lanes of 32,768
    emission slots, past the slim coder's fused-key limit): the CLI's
    stream at its default quota (the raw byte count) equals the API's,
    here the JAX package's ``compress`` on the uint16 path the CLI takes
    (the port's ``compress`` equals that stream at this geometry, in
    test_torch_codec.py)."""
    img = make_test_image(256, 256, np.random.default_rng(7),
                          dtype=np.uint8, amplitude=180, noise=30)
    src, comp = tmp_path / "in.png", tmp_path / "out.icer"
    IO.write_png(src, img)
    assert port(["compress", str(src), str(comp), "-s", "1", "-g", "1",
                 "-G"]) == 0
    assert comp.read_bytes() == G.compress(
        img.astype(np.uint16), G.CodecConfig(1, 0, 1, 256 * 256))


def test_cli_decompress_requires_mode(tmp_path, gray_png):
    src, _ = gray_png
    comp = tmp_path / "out.icer"
    assert cli.main(["compress", str(src), str(comp), "-G", "-s", "3",
                     "--device", "cpu"]) == 0
    assert cli.main(["decompress", str(comp), str(tmp_path / "x.png"),
                     "--device", "cpu"]) == 1


def test_cli_raises_without_its_device(tmp_path, gray_png):
    """No fallback: without CUDA the default device fails the command."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    src, _ = gray_png
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["compress", str(src), str(tmp_path / "o.icer"), "-G",
                  "-s", "3"])
    assert not (tmp_path / "o.icer").exists()


def test_cli_runs_as_a_module(tmp_path, gray_png):
    src, img = gray_png
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run(
        [sys.executable, "-m", "icer_compression_tpu_torch.cli", "compress",
         str(src), str(tmp_path / "m.icer"), "-G", "-s", "3", "-t", "40000",
         "--device", "cpu", "--time"], env=env, capture_output=True,
        text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "encode time" in res.stdout
    cfg = G.CodecConfig(3, 0, 6, 40000)
    assert (tmp_path / "m.icer").read_bytes() == G.compress(
        img.astype(np.uint16), cfg)


def _dirs(tmp_path):
    ind = tmp_path / "in"
    ind.mkdir()
    return ind, tmp_path / "enc", tmp_path / "dec"


def test_cli_batch_serving_roundtrip(tmp_path):
    rng = np.random.default_rng(12345)
    ind, outd, decd = _dirs(tmp_path)
    imgs = {}
    for i in range(2):
        a = make_test_image(40, 48, rng, dtype=np.uint8, amplitude=180,
                            noise=30)
        imgs[f"img{i}"] = a
        Image.fromarray(a, "L").save(ind / f"img{i}.png")
    assert cli.build_parser().get_default("batch_size") \
        == jax_cli.build_parser().get_default("batch_size") == 56
    assert port(["batch-compress", str(ind), str(outd), "-s", "2",
                 "-g", "2"]) == 0
    cfg = G.CodecConfig(stages=2, filt=0, segments=2, byte_quota=40 * 48)
    for k, a in imgs.items():
        assert (outd / f"{k}.icer").read_bytes() \
            == G.compress(a.astype(np.uint16), cfg)
    assert port(["batch-decompress", str(outd), str(decd), "-s", "2",
                 "-g", "2", "--batch-size", "2"]) == 0
    for k in imgs:
        want = np.clip(G.decompress((outd / f"{k}.icer").read_bytes(), cfg,
                                    dtype=np.uint16), 0, 255)
        assert np.array_equal(png(decd / f"{k}.png"), want.astype(np.uint8))


def test_cli_batch_serving_mixed_geometry(tmp_path):
    """Mixed sizes bucket by geometry; --pipeline 2 keeps two collectors
    open."""
    rng = np.random.default_rng(12345)
    ind, outd, decd = _dirs(tmp_path)
    shapes = [(40, 48), (40, 48), (32, 32), (24, 40), (32, 32)]
    imgs = {}
    for i, (h, w) in enumerate(shapes):
        a = make_test_image(h, w, rng, dtype=np.uint8, amplitude=180,
                            noise=30)
        imgs[f"m{i}"] = a
        Image.fromarray(a, "L").save(ind / f"m{i}.png")
    flags = ["-s", "2", "-g", "2", "--batch-size", "2", "--pipeline", "2"]
    assert port(["batch-compress", str(ind), str(outd)] + flags) == 0
    assert port(["batch-decompress", str(outd), str(decd)] + flags) == 0
    for k, a in imgs.items():
        cfg = G.CodecConfig(2, 0, 2, a.size)
        s = (outd / f"{k}.icer").read_bytes()
        assert s == G.compress(a.astype(np.uint16), cfg)
        want = np.clip(G.decompress(s, cfg, dtype=np.uint16), 0, 255)
        assert np.array_equal(png(decd / f"{k}.png"), want.astype(np.uint8))


def test_cli_batch_serving_color(tmp_path):
    rng = np.random.default_rng(12345)
    ind, outd, decd = _dirs(tmp_path)
    rgbs = {}
    for i in range(2):
        a = np.stack([make_test_image(32, 40, rng, dtype=np.uint8,
                                      amplitude=150, noise=40)
                      for _ in range(3)], axis=-1)
        rgbs[f"c{i}"] = a
        Image.fromarray(a, "RGB").save(ind / f"c{i}.png")
    flags = ["-c", "-s", "2", "-g", "2", "--batch-size", "2"]
    assert port(["batch-compress", str(ind), str(outd)] + flags) == 0
    assert port(["batch-decompress", str(outd), str(decd)] + flags) == 0
    cfg = G.CodecConfig(2, 0, 2, 32 * 40 * 3)
    for k, a in rgbs.items():
        y, u, v = (c.astype(np.uint16) for c in rgb_to_ycbcr(a))
        s = (outd / f"{k}.icer").read_bytes()
        assert s == CL.compress_yuv(y, u, v, cfg)
        want = ycbcr_to_rgb(*CL.decompress_yuv(s, cfg, dtype=np.uint16))
        assert np.array_equal(png(decd / f"{k}.png"), want)


# ---- image IO ----------------------------------------------------------

def _images():
    """A seeded noisy image and a gradient, each gray and RGB."""
    rng = np.random.default_rng(31)
    noisy = rng.integers(0, 256, (23, 37, 3)).astype(np.uint8)
    grad = (np.add.outer(np.arange(23) * 5, np.arange(37) * 3)[..., None]
            + np.array([0, 40, 90])).astype(np.uint8)
    return [noisy, grad, noisy[..., 0].copy(), grad[..., 1].copy()]


def _filters_of(data, arr):
    raw = zlib.decompress(b"".join(body for kind, body in IO._png_chunks(data)
                                   if kind == b"IDAT"))
    stride = arr.shape[1] * (arr.shape[2] if arr.ndim == 3 else 1)
    return set(np.frombuffer(raw, np.uint8).reshape(arr.shape[0],
                                                    stride + 1)[:, 0].tolist())


def _png_with_filters(arr):
    """PNG bytes with row y filtered by filter y % 5 (None, Sub, Up,
    Average, Paeth)."""
    bpp = arr.shape[2] if arr.ndim == 3 else 1
    rows = arr.reshape(arr.shape[0], -1).astype(np.int64)
    prev = np.zeros(rows.shape[1], np.int64)
    out = []
    for y, cur in enumerate(rows):
        a = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        b = prev
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = [0, a, b, (a + b) // 2, paeth][y % 5]
        out.append(np.concatenate([[y % 5], (cur - pred) & 255]))
        prev = cur
    h, w = arr.shape[:2]
    raw = np.asarray(out, np.uint8).tobytes()
    ihdr = np.array([w, h], ">u4").tobytes() + bytes(
        [8, 2 if bpp == 3 else 0, 0, 0, 0])
    return (IO.PNG_SIGNATURE + IO._png_chunk(b"IHDR", ihdr)
            + IO._png_chunk(b"IDAT", zlib.compress(raw))
            + IO._png_chunk(b"IEND", b""))


@pytest.mark.parametrize("which", range(4))
def test_png_reader_matches_pillow(which):
    arr = _images()[which]
    mode = "RGB" if arr.ndim == 3 else "L"
    buf = io.BytesIO()
    Image.fromarray(arr, mode).save(buf, format="PNG")
    data = buf.getvalue()
    got = IO.decode_png(data)
    assert got.dtype == np.uint8
    assert np.array_equal(got, np.asarray(Image.open(io.BytesIO(data))))
    assert np.array_equal(got, arr)
    assert _filters_of(data, arr) - {0}     # Pillow filtered some rows
    mixed = _png_with_filters(arr)
    assert _filters_of(mixed, arr) == {0, 1, 2, 3, 4}
    assert np.array_equal(IO.decode_png(mixed), arr)
    assert np.array_equal(np.asarray(Image.open(io.BytesIO(mixed))), arr)


@pytest.mark.parametrize("which", range(4))
def test_png_writer_round_trips(tmp_path, which):
    arr = _images()[which]
    IO.write_png(tmp_path / "a.png", arr)
    assert _filters_of((tmp_path / "a.png").read_bytes(), arr) == {0}
    assert np.array_equal(IO.read_png(tmp_path / "a.png"), arr)
    assert np.array_equal(np.asarray(Image.open(tmp_path / "a.png")), arr)


def test_load_image_matches_jax_package(tmp_path):
    noisy, grad, gray, _ = _images()
    same = np.repeat(gray[..., None], 3, axis=2)   # RGB, equal channels
    for name, arr in (("rgb", noisy), ("grad", grad), ("gray", gray),
                      ("same", same)):
        path = tmp_path / f"{name}.png"
        IO.write_png(path, arr)
        for force in (None, True, False):
            got, got_c = IO.load_image(path, force)
            want, want_c = JIO.load_image(str(path), force)
            assert got_c == want_c, (name, force)
            assert got.dtype == np.uint8 and np.array_equal(got, want), \
                (name, force)


def test_other_formats_need_pillow(tmp_path, monkeypatch):
    gray = _images()[2]
    Image.fromarray(gray, "L").save(tmp_path / "g.bmp")
    got, is_c = IO.load_image(tmp_path / "g.bmp")
    assert not is_c and np.array_equal(got, gray)
    IO.save_image(tmp_path / "h.bmp", gray.astype(np.int32) * 2)
    assert np.array_equal(np.asarray(Image.open(tmp_path / "h.bmp")),
                          np.clip(gray.astype(np.int32) * 2, 0, 255))
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(RuntimeError, match="BMP.*Pillow"):
        IO.load_image(tmp_path / "g.bmp")
    with pytest.raises(RuntimeError, match="BMP.*Pillow"):
        IO.save_image(tmp_path / "i.bmp", gray)
    IO.save_image(tmp_path / "g.png", gray)        # PNG needs no Pillow
    assert np.array_equal(IO.load_image(tmp_path / "g.png")[0], gray)


@pytest.mark.parametrize("backend", ["native", "numpy"])
def test_cli_host_backends_match_jax_cli(tmp_path, gray_png, backend):
    """--backend native / numpy against the JAX CLI with the same flags:
    streams byte-equal (and equal to the device path's), decodes
    pixel-equal (numpy decodes through the sequential python path)."""
    src, img = gray_png
    flags = ["-s", "3", "-f", "A", "-g", "4", "-G"]
    comp, back = tmp_path / "out.icer", tmp_path / "back.png"
    assert both(["compress", str(src), str(comp)] + flags
                + ["-t", "1500", "--backend", backend]) == (0, 0)
    assert comp.read_bytes() == (tmp_path / "jax_out.icer").read_bytes()
    dev = tmp_path / "dev.icer"
    assert port(["compress", str(src), str(dev)] + flags
                + ["-t", "1500"]) == 0
    assert dev.read_bytes() == comp.read_bytes()
    assert both(["decompress", str(comp), str(back)] + flags
                + ["--backend", backend]) == (0, 0)
    assert np.array_equal(png(back), png(tmp_path / "jax_back.png"))


def test_cli_color_native_backend_matches_jax_cli(tmp_path):
    rng = np.random.default_rng(7)
    rgb = np.stack([make_test_image(40, 48, rng, dtype=np.uint8,
                                    amplitude=200, noise=20)
                    for _ in range(3)], axis=-1)
    src = tmp_path / "in.png"
    Image.fromarray(rgb, mode="RGB").save(src)
    comp, back = tmp_path / "out.icer", tmp_path / "back.png"
    flags = ["-s", "2", "-f", "A", "-g", "3", "-c", "--backend", "native"]
    assert both(["compress", str(src), str(comp)] + flags) == (0, 0)
    assert comp.read_bytes() == (tmp_path / "jax_out.icer").read_bytes()
    assert both(["decompress", str(comp), str(back)] + flags) == (0, 0)
    assert np.array_equal(png(back), png(tmp_path / "jax_back.png"))


def test_cli_unavailable_backend_exits_nonzero(tmp_path, gray_png,
                                               monkeypatch):
    """No fallback to another path: a native runtime that does not build
    raises, the module exits non-zero without CUDA on the device backend,
    and batch operations refuse a host backend."""
    from icer_compression_tpu_torch.backend import native_backend as NB
    src, _ = gray_png
    out = tmp_path / "o.icer"
    assert cli.main(["batch-compress", str(src), str(tmp_path / "d"), "-G",
                     "--backend", "native", "--device", "cpu"]) == 2
    if not torch.cuda.is_available():
        env = dict(os.environ, PYTHONPATH=REPO)
        res = subprocess.run(
            [sys.executable, "-m", "icer_compression_tpu_torch.cli",
             "compress", str(src), str(out), "-G", "-s", "3",
             "--backend", "device"], env=env, capture_output=True,
            text=True, timeout=300)
        assert res.returncode != 0 and "CUDA" in res.stderr
    bad = tmp_path / "icer_runtime.cpp"
    bad.write_text("int broken( {\n")
    monkeypatch.setattr(NB, "SRC", bad)
    monkeypatch.setattr(NB, "BUILD", tmp_path / "build")
    monkeypatch.setattr(NB, "_lib", None)
    with pytest.raises(RuntimeError, match="native runtime build failed"):
        cli.main(["compress", str(src), str(out), "-G", "-s", "3",
                  "--backend", "native"])
    assert not out.exists()
