"""Sort and pack (``csrc/slim_pack.cu``) against its plain version, the
sort-based tail of ``ops/entropy_slim.py``, and against the JAX package's
tail of the same records (``slim_sort_operand_packed`` /
``order_and_pack_lane_packed``, ``slim_sort_operands`` /
``order_and_pack_lane_slim``), on the CPU: the CUDA source compiled with
g++ against a host emulation of the few CUDA features it uses
(``tests/cuda_host.h``: blocks one after another, a block's threads as
threads, the source's LAUNCH macro as a host launch), and launched through
the port's own launch wrapper on CPU tensors.  This holds the kernels'
arithmetic, their placement of each record at its ordinal and their
chunked packing to both; concurrency between blocks, timing and the
compiler for the card are for the first-use check and chip_smoke.py."""

import contextlib
import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from icer_compression_tpu_torch import kernel_check as K
from icer_compression_tpu_torch import kernels
from icer_compression_tpu_torch.ops import entropy_slim as ES
from test_torch_entropy_slim import PE, jax, jnp  # noqa: F401
from test_torch_entropy_slim import one_torch_thread  # noqa: F401

HERE = Path(__file__).resolve().parent


@pytest.fixture(scope="module")
def host_pack(tmp_path_factory):
    """``_pack_launch`` with the library built for the host: (call, runs)
    where ``call(recs, misc, max_bits, slice_to)`` returns its outputs
    and ``runs`` is the run count the kernel adds to."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    src = (kernels.CSRC / "slim_pack.cu").read_text()
    assert src.count("#include <cuda_runtime.h>") == 1
    src = src.replace("#include <cuda_runtime.h>", '#include "cuda_host.h"')
    out = tmp_path_factory.mktemp("slim_pack")
    (out / "slim_pack_host.cpp").write_text(src)
    lib_path = out / "slim_pack_host.so"
    r = subprocess.run(["g++", "-std=c++20", "-O1", "-shared", "-fPIC",
                        "-pthread", f"-I{HERE}", "-o", str(lib_path),
                        str(out / "slim_pack_host.cpp")],
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    lib = ctypes.CDLL(str(lib_path))
    runs = torch.zeros(1, dtype=torch.int64)

    class Stream:
        cuda_stream = None

    def call(*args):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(kernels, "load", lambda name: lib)
            mp.setattr(kernels, "run_slot", lambda dev, name: runs.data_ptr())
            mp.setattr(torch.cuda, "device",
                       lambda dev: contextlib.nullcontext())
            mp.setattr(torch.cuda, "current_stream", lambda dev: Stream())
            return ES._pack_launch(*args)
    return call, runs


def _jax_tail(recs, max_bits, slice_to):
    """The JAX package's tail on the same kernel 1 records, lane by lane in
    numpy: (payload, total, over) as the port's wrappers give them."""
    with jax.default_device(jax.devices("cpu")[0]):
        j = [jnp.asarray(t.numpy()) for t in recs]
        if len(recs) == 6:     # two-word: its 17-bit open ordinals
            rec1, rec2, fstate, _fopen, ev1, ev2 = j
            ops, keys = (np.asarray(x) for x in PE.slim_sort_operands(
                rec1, rec2, fstate, jnp, ev1, ev2))
        else:
            ops, keys = np.asarray(PE.slim_sort_operand_packed(*j, jnp)), None
    lanes = [PE.order_and_pack_lane_packed(ops[:, i], np, max_bits, slice_to)
             if keys is None else
             PE.order_and_pack_lane_slim(ops[:, i], keys[:, i], np, max_bits,
                                         slice_to)
             for i in range(ops.shape[1])]
    return (torch.from_numpy(np.stack([np.asarray(p) for p, _t, _o in lanes])),
            torch.tensor([int(t) for _p, t, _o in lanes]),
            torch.tensor([bool(o) for _p, _t, o in lanes]))


def _held_equal(got, want, misc):
    """Payload and total equal on the lanes whose misc[0] is clear, and
    the flags with misc[0] ORed in equal on all."""
    ok = misc[0] == 0
    assert torch.equal(got[0][ok], want[0][ok])
    assert torch.equal(got[1][ok], want[1][ok])
    assert torch.equal(got[2] | ~ok, want[2] | ~ok)


# (payload cap bits, slice): the first-use check's two, a slice of 1,000
# and a cap of 4,096 bits, a cap of one word, a slice past every record
CUTS = K.PACK_CUTS + ((4096, 1000), (32, 64), (1 << 20, 5000))


@pytest.mark.parametrize("two_word", [False, True])
def test_host_build_equals_the_plain_tail(host_pack, two_word):
    call, runs = host_pack
    outs = K._pack_records(two_word)
    if two_word:
        rec1, rec2, fstate, misc, ev1, ev2, fopen = outs
        recs = (rec1, rec2, fstate, fopen, ev1, ev2)
        plain = ES.pack_lanes_slim_two_word
    else:
        rec, fstate, misc, ev = outs
        recs, plain = (rec, fstate, ev), ES.pack_lanes_slim
    assert int(misc[2].max()) > 0 and int(misc[1].max()) > ES.PACK_CHUNK
    if two_word:   # the JAX package's tail reads 17-bit open ordinals
        assert torch.equal(fopen, fstate & 0x1FFFF)
    before = int(runs)
    for max_bits, slice_to in CUTS:
        got = call(recs, misc, max_bits, slice_to)
        want = plain(*recs, misc, max_bits, slice_to)
        assert got[0].shape == want[0].shape and got[0].dtype == torch.uint8
        _held_equal(got, want, misc)
        _held_equal(got, _jax_tail(recs, max_bits, slice_to), misc)
    assert int(runs) - before == len(CUTS)


def test_host_build_flags_lanes_past_the_side_buffer(host_pack):
    """Fused-key lanes past their 32 eviction rows lose records: their
    flag comes from misc[0], and the lanes beside them stay exact (three
    noisy lanes of 16,384 steps and one that evicts a few times)."""
    from test_torch_entropy_slim import (_noisy_overflow_lanes,
                                         _zero_context_lanes)
    call, _runs = host_pack
    valid, ctx, bit = _noisy_overflow_lanes(np.random.default_rng(7),
                                            16384, 3)
    words = torch.cat([torch.from_numpy((valid | (ctx << 1) | (bit << 6))
                                        .astype(np.int32)),
                       _zero_context_lanes()[:, :1]], dim=1)
    rec, fstate, misc, ev = ES.encode_lanes_slim_plain(words)
    assert misc[0].any() and not misc[0, 3] and int(misc[2, 3]) > 0
    L = words.shape[0]
    for max_bits, slice_to in ((1 << 16, L + 49), (16640, 12288)):
        got = call((rec, fstate, ev), misc, max_bits, slice_to)
        _held_equal(got, ES.pack_lanes_slim(rec, fstate, ev, misc, max_bits,
                                            slice_to), misc)
        _held_equal(got, _jax_tail((rec, fstate, ev), max_bits, slice_to),
                    misc)


def test_pack_wrappers_reject_a_bad_cap():
    rec, fstate, misc, ev = K._pack_records(False)
    with pytest.raises(ValueError, match="multiple of 32"):
        ES.pack_lanes_slim(rec, fstate, ev, misc, 100, 64)
    with pytest.raises(ValueError, match="negative"):
        ES.pack_lanes_slim(rec, fstate, ev, misc, 128, -1)
