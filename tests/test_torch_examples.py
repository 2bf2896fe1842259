"""The port's example programs (``icer_compression_tpu_torch/examples``)
on the CPU, against the JAX package's host codec at the examples'
configurations, and the pins that ``chip_smoke.py`` holds them to on the
card (``tests/data/golden_examples.sha256``), recomputed."""

import hashlib
import os
import sys

import numpy as np
import pytest
import torch

from icer_compression_tpu_torch.examples import (compress_color,
                                                 compress_gray,
                                                 decompress_color,
                                                 decompress_gray)
from icer_compression_tpu_torch.utils.image_io import read_png, write_png
from test_torch_entropy_slim import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

import pin_examples  # noqa: E402
from chip_smoke import pixels_sha  # noqa: E402


def boat():
    return read_png(os.path.join(REPO, "tests", "data", "boat.512.png"))


def crop(h, w):
    return boat()[256 - h // 2:256 + h // 2, 256 - w // 2:256 + w // 2]


def sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def test_gray_examples_equal_jax_package(tmp_path, capsys):
    img = crop(40, 48)
    src, bin_, png = (str(tmp_path / n) for n in ("in.png", "c.bin",
                                                  "d.png"))
    write_png(src, img)
    assert compress_gray.main([src, bin_, "--device", "cpu"]) == 0
    assert decompress_gray.main([bin_, png, "--device", "cpu"]) == 0
    want = pin_examples.pin_gray(img)
    assert sha(bin_) == want[0]
    assert pixels_sha(read_png(png)) == want[2]
    assert "compressed size" in capsys.readouterr().out


def test_color_examples_equal_jax_package(tmp_path):
    # 48x64: ten segments need ten LL pixels at four stages (48x40 has 9)
    c = crop(48, 64)
    rgb = np.stack([c, np.roll(c, 7, axis=1), c[::-1]], axis=-1)
    src, bin_, png = (str(tmp_path / n) for n in ("in.png", "c.bin",
                                                  "d.png"))
    write_png(src, rgb)
    assert compress_color.main([src, bin_, "--device", "cpu"]) == 0
    assert decompress_color.main([bin_, png, "--device", "cpu"]) == 0
    want = pin_examples.pin_color(rgb)
    assert sha(bin_) == want[0]
    out = read_png(png)
    assert out.shape == rgb.shape
    assert pixels_sha(out) == want[2]


@pytest.mark.parametrize("module", [compress_gray, decompress_gray,
                                    compress_color, decompress_color])
def test_examples_need_a_card_unless_asked_for_the_cpu(module, monkeypatch,
                                                       tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    src = str(tmp_path / "in")
    if module in (compress_gray, compress_color):
        write_png(src, crop(48, 64))
    else:
        with open(src, "wb") as f:
            f.write(b"\0" * 64)
    with pytest.raises(RuntimeError, match="CUDA"):
        module.main([src, str(tmp_path / "out")])


def test_pinned_example_references():
    """The pins chip_smoke.py holds the examples to, recomputed with the
    JAX package's host codec."""
    with open(os.path.join(REPO, "tests", "data",
                           "golden_examples.sha256")) as f:
        pinned = [ln.split(None, 3) for ln in f.read().splitlines()]
    assert [(" ".join(p[:3]), p[3]) for p in pinned] == pin_examples.pins()
