"""The context model's CUDA source (``csrc/context_model.cu``) against its
plain version, ``Encoder.emit`` and ``Encoder.bucket_words`` over
``plane_emissions_words``, and against the JAX package's
``plane_emissions_words``, on the CPU: the source compiled with g++
against the host emulation of ``tests/cuda_host.h`` (blocks one after
another, a block's threads as threads, the source's LAUNCH macro as a host
launch) and launched through the encoder's own path on the card
(``_kernel_words``, one ``context_model.context_words`` a coded group) on
CPU tensors.  Every word of every coded bucket must be equal: the valid
ones, the words of pixels outside a lane's rectangle and of dummy lanes,
and the zero tail of each row."""

import contextlib
import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from icer_compression_tpu.ops import context_model as JCM
from icer_compression_tpu_torch import kernel_check as K
from icer_compression_tpu_torch import kernels
from icer_compression_tpu_torch.core import constants as C
from icer_compression_tpu_torch.ops import context_model as CM
from icer_compression_tpu_torch.ops import encode as E
from test_torch_entropy_slim import one_torch_thread  # noqa: F401

HERE = Path(__file__).resolve().parent


@pytest.fixture(scope="module")
def host_words(tmp_path_factory):
    """``enc._kernel_words`` with the library built for the host: (call,
    runs) where ``call(enc, img)`` returns every coded bucket's words and
    ``runs`` is the run count the kernel adds to."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    src = (kernels.CSRC / "context_model.cu").read_text()
    assert src.count("#include <cuda_runtime.h>") == 1
    src = src.replace("#include <cuda_runtime.h>", '#include "cuda_host.h"')
    out = tmp_path_factory.mktemp("context_model")
    (out / "context_model_host.cpp").write_text(src)
    lib_path = out / "context_model_host.so"
    r = subprocess.run(["g++", "-std=c++20", "-O1", "-shared", "-fPIC",
                        "-pthread", f"-I{HERE}", "-o", str(lib_path),
                        str(out / "context_model_host.cpp")],
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    lib = ctypes.CDLL(str(lib_path))
    runs = torch.zeros(1, dtype=torch.int64)

    class Stream:
        cuda_stream = None

    def call(enc, img):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(kernels, "load", lambda name: lib)
            mp.setattr(kernels, "run_slot", lambda dev, name: runs.data_ptr())
            mp.setattr(torch.cuda, "device",
                       lambda dev: contextlib.nullcontext())
            mp.setattr(torch.cuda, "current_stream", lambda dev: Stream())
            return [enc._kernel_words(enc.buckets[bi], gis, img)
                    for bi, gis in enc._coded]
    return call, runs


def _jax_words(enc, g, img, lsb):
    """The JAX package's (w0, w1) of group g's lanes at plane lsb, each
    (B, N, mh * mw), and the pixel mask (N, mh * mw)."""
    x = img.numpy()
    N, mh, mw = len(g["lanes"]), g["mh"], g["mw"]
    seg = np.zeros((x.shape[0], N, mh, mw), np.int32)
    for i, l in enumerate(g["lanes"]):
        if not l.dummy:
            seg[:, i, :l.h, :l.w] = x[:, l.row:l.row + l.h, l.col:l.col + l.w]
    pv = g["pv_t"].numpy()      # the plain version's tables, made by then
    sub = g["sub_t"].numpy()
    w0, w1 = JCM.plane_emissions_words(
        seg.reshape(-1, mh, mw), np.tile(sub, x.shape[0]),
        np.tile(pv, (x.shape[0], 1, 1)), lsb, enc.mag_bits, np)
    shape = (x.shape[0], N, mh * mw)
    return (np.asarray(w0).reshape(shape), np.asarray(w1).reshape(shape),
            pv.reshape(N, -1) != 0)


# (w, h, stages, segments, mag_bits, plane_cuts, lane_share, images)
CASES = [
    (67, 45, 3, 5, 15, None, (1, 0), 2),
    (67, 45, 3, 7, 7, None, (1, 0), 2),
    (128, 96, 4, 6, 15, (1, (2, 5), 3, (0, 9)), (1, 0), 1),
    (129, 129, 6, 3, 7, None, (1, 0), 1),
    (67, 45, 3, 5, 15, ((2, 5), (2, 5), (4, 4)), (1, 0), 2),
    (67, 45, 3, 5, 7, None, (2, 1), 2),
    (44, 40, 2, 5, 15, ((0, 9), (6, 9)), (2, 1), 3),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_host_build_equals_the_plain_words(host_words, case):
    call, runs = host_words
    w, h, stages, segments, mag_bits, cuts, share, B = case
    enc = E.TorchGrayscaleEncoder(w, h, stages, 0, segments, mag_bits, "cpu",
                                  plane_cuts=cuts, lane_share=share,
                                  graph=False)
    img = K.cm_coefficients(np.random.default_rng(w * h + mag_bits), B, h, w,
                            mag_bits)
    launches, before = CM.context_words.launches, int(runs)
    got = call(enc, img)
    groups = sum(len(gis) for _bi, gis in enc._coded)
    assert CM.context_words.launches - launches == groups
    assert int(runs) - before == groups
    want = [enc.coder_words(enc.buckets[bi], gis, img)
            for bi, gis in enc._coded]
    assert len(got) == len(want) == len(enc._coded)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == torch.int32 and a.shape == b.shape
        assert torch.equal(a, b)
    if share[0] > 1:
        assert any(l.dummy for g in enc.groups for l in g["lanes"])
    else:
        assert {l.subband for g in enc.groups for l in g["lanes"]} == {
            C.SUBBAND_LL, C.SUBBAND_HL, C.SUBBAND_LH, C.SUBBAND_HH}
    # the valid pixels' words, against the JAX package
    for (bi, gis), words in zip(enc._coded, got):
        r = 0
        for gi in gis:
            g = enc.groups[gi]
            lo, hi = g["cut"]
            N, n = len(g["lanes"]), g["mh"] * g["mw"]
            part = words[r:r + B * (hi - lo) * N].reshape(B, hi - lo, N, -1)
            r += B * (hi - lo) * N
            for k, lsb in enumerate(range(lo, hi)):
                j0, j1, pv = _jax_words(enc, g, img, lsb)
                k0 = part[:, k, :, 0:2 * n:2].numpy()
                k1 = part[:, k, :, 1:2 * n:2].numpy()
                assert np.array_equal(k0[:, pv], j0[:, pv]), (gi, lsb)
                assert np.array_equal(k1[:, pv], j1[:, pv]), (gi, lsb)
        assert r == words.shape[0]


def test_context_words_rejects_a_bad_output():
    lanes = torch.zeros((2, 5), dtype=torch.int32)
    img = torch.zeros((1, 8, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="does not hold"):
        CM.context_words(img, lanes, 4, 4, 0, 3, 15,
                         torch.empty((5, 32), dtype=torch.int32))
    with pytest.raises(ValueError, match="does not hold"):
        CM.context_words(img, lanes, 4, 4, 0, 3, 15,
                         torch.empty((6, 30), dtype=torch.int32))
    with pytest.raises(ValueError, match="does not hold"):
        CM.context_words(img, lanes.to(torch.int64), 4, 4, 0, 3, 15,
                         torch.empty((6, 32), dtype=torch.int32))
    with pytest.raises(ValueError, match="on meta"):
        CM.context_words(img, lanes, 4, 4, 0, 3, 15,
                         torch.empty((6, 32), dtype=torch.int32,
                                     device="meta"))
