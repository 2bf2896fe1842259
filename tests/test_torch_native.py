"""The port's native host runtime (``backend/native_backend.py`` over its own
copy of ``icer_runtime.cpp``) against the JAX package's bindings and the
sequential coder, and the encoder's flagged lanes through it: one batched
native call per device pass, streams equal to the JAX package's."""

import numpy as np
import pytest

from conftest import make_test_image
from icer_compression_tpu.backend import native_backend as JNB
from icer_compression_tpu.models import grayscale as G
from icer_compression_tpu_torch.backend import native_backend as NB
from icer_compression_tpu_torch.backend import sequential as S
from icer_compression_tpu_torch.core.status import IcerError
from icer_compression_tpu_torch.models import grayscale as T
from test_torch_entropy_slim import one_torch_thread  # noqa: F401


def _random_lane(rng, L):
    ctx = rng.integers(0, 18, L).astype(np.int32)
    p = rng.random(18)
    bit = (rng.random(L) < p[ctx]).astype(np.int32)
    valid = (rng.random(L) < 0.9).astype(np.int32)
    return valid, ctx, bit


def _flush_lane():
    """A lane that fills the 2048-codeword reorder window, so the coder
    force-completes its oldest codeword (tests/test_native.py)."""
    blk_ctx = np.tile(np.array([0] + [17] * 8), 1200)
    blk_bit = np.tile(np.array([0, 1, 0, 1, 1, 0, 1, 0, 1]), 1200)
    ctx = np.concatenate([np.zeros(600, np.int64), blk_ctx])
    bit = np.concatenate([np.zeros(600, np.int64), blk_bit])
    return np.ones(len(ctx), np.int32), ctx, bit


def _random_lanes():
    rng = np.random.default_rng(0)
    return [_random_lane(rng, int(rng.integers(1, 4000))) for _ in range(12)]


LANES = {"random": _random_lanes, "flush": lambda: [_flush_lane()]}


@pytest.mark.parametrize("lanes", sorted(LANES))
def test_encode_emissions_matches_jax_binding_and_sequential(lanes):
    for valid, ctx, bit in LANES[lanes]():
        pl, nb, flushes = S.encode_emissions(valid, ctx, bit)
        got = NB.encode_emissions_native(valid, ctx, bit)
        assert got == (pl, nb)
        assert got == JNB.encode_emissions_native(valid, ctx, bit)
        if lanes == "flush":
            assert flushes > 0


@pytest.mark.parametrize("lanes", sorted(LANES))
def test_encode_batch_matches_jax_binding_and_sequential(lanes):
    streams = LANES[lanes]() + [_random_lane(np.random.default_rng(99), 50)]
    lens = np.array([len(v) for v, _c, _b in streams])
    offs = np.cumsum(lens) - lens
    flat = [np.concatenate([s[i] for s in streams]) for i in range(3)]
    out, bits = NB.encode_batch_native(*flat, offs, lens, nthreads=3)
    jout, jbits = JNB.encode_batch_native(*flat, offs, lens, nthreads=3)
    assert np.array_equal(bits, jbits)
    for i, (v, c, b) in enumerate(streams):
        pl, nb, _ = S.encode_emissions(v, c, b)
        assert int(bits[i]) == nb
        assert out[i, :(nb + 7) // 8].tobytes() == pl \
            == jout[i, :(nb + 7) // 8].tobytes()


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("filt", [0, 2, 6])
def test_dwt_matches_jax_binding(filt, inverse):
    rng = np.random.default_rng(filt)
    img = np.ascontiguousarray(rng.integers(0, 4096, (37, 52)), np.int32)
    a, b = img.copy(), img.copy()
    ov = NB.dwt_native(a, 3, filt, 15, inverse=inverse, nthreads=2)
    jov = JNB.dwt_native(b, 3, filt, 15, inverse=inverse, nthreads=2)
    assert ov == jov
    assert np.array_equal(a, b)
    assert not np.array_equal(a, img)


def _transformed(h, w, seed):
    img = make_test_image(h, w, np.random.default_rng(seed))
    t, _ll = G.transform_for_encode(img, 2, 0, 15)
    return np.ascontiguousarray(t, np.int32)


def _tasks(h, w, lsb0=None):
    from icer_compression_tpu.core.partition import partition_segments
    from icer_compression_tpu.core.subbands import subband_view
    tasks = []
    for stage, subband in G.all_subbands(2):
        view = subband_view(w, h, stage, subband)
        for rect in partition_segments(view.w, view.h, 3):
            t = {"seg_off": (view.row + rect.row) * w + view.col + rect.col,
                 "h": rect.h, "w": rect.w, "rowstride": w,
                 "subband": subband, "mag_bits": 15}
            if lsb0 is not None:
                t["lsb0"] = lsb0
            tasks.append(t)
    return tasks


@pytest.mark.parametrize("nplanes,lsb0", [(9, None), (1, 4)])
def test_encode_segments_matches_jax_binding(nplanes, lsb0):
    img = _transformed(48, 40, 3)
    tasks = _tasks(48, 40, lsb0)
    out, bits = NB.encode_segments_native(img, tasks, nplanes, nthreads=2)
    jout, jbits = JNB.encode_segments_native(img, tasks, nplanes, nthreads=2)
    assert np.array_equal(bits, jbits) and (bits > 0).any()
    for r, nb in enumerate(bits):
        assert out[r, :(nb + 7) // 8].tobytes() \
            == jout[r, :(nb + 7) // 8].tobytes()


def test_decode_segments_matches_jax_binding():
    img = _transformed(48, 40, 4)
    tasks = _tasks(48, 40)
    out, bits = NB.encode_segments_native(img, tasks, 9)
    blob, dtasks = b"", []
    for i, t in enumerate(tasks):
        planes = {}
        for lsb in range(9):
            nb = int(bits[i * 9 + lsb])
            planes[lsb] = (len(blob), nb)
            blob += out[i * 9 + lsb, :(nb + 7) // 8].tobytes()
        dtasks.append(dict(t, nplanes=9, planes=planes))
    dtasks[2]["planes"].pop(5)       # a missing middle plane stops a task
    a = np.zeros_like(img)
    b = np.zeros_like(img)
    done = NB.decode_segments_native(a, dtasks, blob, nthreads=2)
    jdone = JNB.decode_segments_native(b, dtasks, blob, nthreads=2)
    assert np.array_equal(done, jdone) and done[2] == 3
    assert np.array_equal(a, b)
    keep = np.ones(len(tasks), bool)
    keep[2] = False
    assert (done[keep] == 9).all()


def _flag_every_third(monkeypatch):
    """Flag every third lane of kernel 1 (the plain version here), so
    those lanes take the host re-encode."""
    from icer_compression_tpu_torch.ops import entropy_slim as ES
    real = ES.encode_lanes_slim

    def flag_every_third(words):
        rec, fstate, misc, ev = real(words)
        misc = misc.clone()
        misc[0, ::3] = 1
        return rec, fstate, misc, ev

    monkeypatch.setattr(ES, "encode_lanes_slim", flag_every_third)


@pytest.mark.parametrize("pass_words", [None, 1])
def test_flagged_lanes_take_one_native_batch_per_pass(monkeypatch,
                                                      pass_words):
    """Every flagged lane of a device pass goes through one
    ``encode_batch_native`` call (``PASS_WORDS`` = 1 runs each image as a
    pass of its own); its payload equals the sequential coder's and the
    streams equal the JAX package's."""
    from icer_compression_tpu_torch.ops import encode as E
    _flag_every_third(monkeypatch)
    if pass_words is not None:
        monkeypatch.setattr(E, "PASS_WORDS", pass_words)
    calls = []
    real = NB.encode_batch_native

    def counting(valid, ctx, bit, offsets, lengths, nthreads=0):
        out, bits = real(valid, ctx, bit, offsets, lengths, nthreads)
        for i, (o, n) in enumerate(zip(offsets, lengths)):
            pl, nb, _ = S.encode_emissions(valid[o:o + n], ctx[o:o + n],
                                           bit[o:o + n])
            assert int(bits[i]) == nb
            assert out[i, :(nb + 7) // 8].tobytes() == pl
        calls.append(len(offsets))
        return out, bits

    monkeypatch.setattr(NB, "encode_batch_native", counting)
    imgs = np.stack([make_test_image(48, 40, np.random.default_rng(s))
                     for s in (4, 5)])
    cfg = T.CodecConfig(2, 0, 6, None)
    enc = T.make_encoder(40, 48, cfg, np.uint16, "cpu")
    out = T.compress_batch(imgs, cfg, encoder=enc)
    for img, s in zip(imgs, out):
        assert s == G.compress(img, G.CodecConfig(2, 0, 6, None))
    assert len(calls) == -(-len(imgs) // enc.pass_images) \
        == (2 if pass_words else 1)
    assert sum(calls) == enc.fallback_lanes > 0
    assert enc.fallback_seconds > 0


def test_overflow_raises_icer_error(monkeypatch):
    class Lib:
        @staticmethod
        def icer_tpu_encode_emissions(*args):
            return -1

        @staticmethod
        def icer_tpu_encode_batch(v, c, b, o, n, ntasks, out, stride, bits,
                                  nt):
            bits[0] = -1

    monkeypatch.setattr(NB, "get_lib", lambda: Lib)
    lane = _random_lane(np.random.default_rng(0), 100)
    with pytest.raises(IcerError):
        NB.encode_emissions_native(*lane)
    with pytest.raises(IcerError):
        NB.encode_batch_native(*lane, [0], [100])


def test_library_named_by_source_flags_and_cpu(tmp_path, monkeypatch):
    first = NB.lib_path()
    assert first.parent == NB.BUILD and first.name.startswith("icer_runtime-")
    monkeypatch.setattr(NB, "host_cpu", lambda: "model name\t: another CPU\n")
    assert NB.lib_path() != first
    monkeypatch.undo()
    monkeypatch.setattr(NB, "CXX_FLAGS", NB.CXX_FLAGS + ("-g",))
    assert NB.lib_path() != first
    monkeypatch.undo()
    src = tmp_path / "icer_runtime.cpp"
    src.write_bytes(NB.SRC.read_bytes() + b"\n// edited\n")
    monkeypatch.setattr(NB, "SRC", src)
    assert NB.lib_path() != first


def test_build_failure_raises_with_the_compiler_log(tmp_path, monkeypatch):
    """No silent fallback: a source that does not compile raises
    RuntimeError carrying g++'s log, leaves no library behind, and an
    encode whose lanes need the runtime raises too."""
    src = tmp_path / "icer_runtime.cpp"
    src.write_text("int broken( {\n")
    monkeypatch.setattr(NB, "SRC", src)
    monkeypatch.setattr(NB, "BUILD", tmp_path / "build")
    monkeypatch.setattr(NB, "_lib", None)
    with pytest.raises(RuntimeError, match="native runtime build failed"
                       "(.|\n)*error"):
        NB.get_lib()
    assert not list((tmp_path / "build").iterdir())
    _flag_every_third(monkeypatch)
    img = make_test_image(48, 40, np.random.default_rng(4))
    with pytest.raises(RuntimeError, match="native runtime build failed"):
        T.compress(img, T.CodecConfig(2, 0, 6, None), device="cpu")


def test_built_library_is_reused(monkeypatch):
    NB.get_lib()
    path = NB.lib_path()
    assert path.exists()

    def no_compiler(*a, **k):
        raise AssertionError("the library was built again")

    monkeypatch.setattr(NB.subprocess, "run", no_compiler)
    assert NB.build() == path
