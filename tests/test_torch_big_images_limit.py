"""Boat 512 at one stage and one segment: lanes of 2^17 emission slots,
past the 17-bit ordinals of the JAX package's slim coder, through kernel
1's two-word instance.  Alone in its file (about a minute through the
plain kernel 1 on a CPU), so that test workers that split by file run it
beside the others."""

import os

import numpy as np

from icer_compression_tpu.models import grayscale as G
from icer_compression_tpu_torch.models import grayscale as T
from icer_compression_tpu_torch.utils import image_io as IO
from test_torch_entropy_slim import one_torch_thread  # noqa: F401

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def test_boat_at_kernel_1s_limit_equals_jax_package():
    """``compress`` on the CPU equals the JAX package's stream (its host
    codec, equal there to ``compress_jax`` on its default ``sorted``
    coder) and decodes to boat on the JAX side."""
    boat = IO.read_png(os.path.join(DATA, "boat.512.png")).astype(np.uint16)
    cfg = T.CodecConfig(1, 0, 1, None)
    assert T.make_encoder(512, 512, cfg, np.uint16,
                          "cpu").bucket_coders == ("slim",)
    stream = T.compress(boat, cfg, device="cpu")
    jcfg = G.CodecConfig(1, 0, 1, None)
    assert stream == G.compress(boat, jcfg)
    assert np.array_equal(G.decompress(stream, jcfg, dtype=np.uint16), boat)
