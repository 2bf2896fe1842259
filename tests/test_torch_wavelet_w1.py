"""Kernel W1 (one axis of one inverse DWT stage, ``ops/wavelet.inverse_pass``):
its plain version (``inverse_pass_plain`` -> ``inverse_1d`` ->
``inverse_recurrence_plain``), the plain ``inverse_stages`` and W1's stage
loop (``stage_passes``) against the JAX package's ``inverse_1d`` /
``inverse_stages`` with ``xp=jnp`` under ``jit``, which run the recurrence as
a ``lax.scan`` (exact, tolerance 0), its first-use check, and its dispatch:
the plain version for CPU tensors only."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icer_compression_tpu.ops import wavelet as JW
from icer_compression_tpu_torch import kernel_check, kernels
from icer_compression_tpu_torch.ops import wavelet as TW
from test_torch_entropy_slim import one_torch_thread  # noqa: F401

# filters whose inverse runs the recurrence (beta != 0): B-F and Q
RECURRENCE = [1, 2, 3, 4, 5, 6]
# (h, w, stages): every stage count 1-6, odd and even sides
GEOMETRIES = [(24, 30, 1), (37, 29, 2), (51, 46, 3), (49, 67, 4),
              (97, 101, 5), (130, 129, 6)]


def _jax_defined(filt, n):
    """Whether the JAX ``inverse_1d`` takes lines of ``n`` samples at
    ``filt``: it raises at filter C's 4 (its n = 1 term reads r[2] of a
    2-entry r) and filter A's 2 (r[1] of a 1-entry r), and no codec forms
    lines shorter than 5 (an LL of at least 3 pixels a side)."""
    return not ((filt == 2 and n == 4) or (filt == 0 and n == 2))


def _lengths(filt):
    """Line lengths 2-9 and two random ones up to 300 that the JAX
    package takes."""
    rng = np.random.default_rng(filt)
    short = [n for n in range(2, 10) if _jax_defined(filt, n)]
    return short + [int(n) for n in rng.integers(10, 301, 2)]


def _scan_only_overflow(x, filt, mag_bits):
    """Whether the JAX ``lax.scan``'s discarded filter-C value at n = 1
    (computed with d2 = 0, then replaced) leaves the sample range: the
    scan ORs its check into the overflow flag, the reference's recurrence
    (and the JAX package's numpy path) never computes it."""
    N = x.shape[-1]
    half, nL = N // 2, N // 2 + (N & 1)
    if filt != 2 or half < 2:
        return False
    lows = x[..., :nL].astype(np.int64)
    r1 = lows[..., 0] - lows[..., 1]
    r2 = lows[..., 1] - lows[..., 2] if nL > 2 else 0
    v = x[..., nL + 1] + np.floor_divide(2 * r1 + 3 * r2 + 4, 8)
    return bool(((v < -(1 << mag_bits)) | (v > (1 << mag_bits) - 1)).any())


@functools.lru_cache(maxsize=None)
def _jax_inverse_1d():
    """The JAX package's ``inverse_1d`` with ``xp=jnp`` under one ``jit``
    per shape (eagerly each of its ops would compile on its own)."""
    return jax.jit(JW.inverse_1d, static_argnums=(1, 2, 3))


@functools.lru_cache(maxsize=None)
def _jax_inverse_stages():
    return jax.jit(JW.inverse_stages, static_argnums=(1, 2, 3, 4))


@pytest.mark.parametrize("filt", RECURRENCE)
@pytest.mark.parametrize("mag_bits", [7, 15])
def test_inverse_1d_matches_the_lax_scan(filt, mag_bits):
    """Lines with two leading axes, values across the whole signed range
    (most lines overflow) and across an eighth of it."""
    rng = np.random.default_rng(10 * filt + mag_bits)
    for n in _lengths(filt):
        for amp in (1 << mag_bits, 1 << (mag_bits - 3)):
            x = rng.integers(-amp, amp, (2, 3, n)).astype(np.int32)
            y, ov = TW.inverse_1d(torch.from_numpy(x), filt, mag_bits)
            y_ref, ov_ref = _jax_inverse_1d()(jnp.asarray(x), filt,
                                              mag_bits, jnp)
            assert np.array_equal(y.numpy(), np.asarray(y_ref)), (n, amp)
            assert bool(ov_ref) == (bool(ov) or _scan_only_overflow(
                x, filt, mag_bits)), (n, amp)
            if n >= 3:
                # the recurrence as the reference runs it (numpy path)
                _y, ov_np = JW.inverse_1d(x, filt, mag_bits, np)
                assert bool(ov) == bool(ov_np), (n, amp)


@pytest.mark.parametrize("filt", range(7))
@pytest.mark.parametrize("mag_bits", [7, 15])
def test_inverse_stages_match_the_jax_package(filt, mag_bits):
    """The plain ``inverse_stages`` and W1's stage loop on CPU tensors (each
    pass through the plain version) against the JAX ``inverse_stages``
    with ``xp=jnp`` under jit: a batch of two canvases, stage blocks inside
    the canvas at 1-6 stages (the geometry picked per filter and width),
    odd and even sides (uint8's skewed odd-length interleave at
    mag_bits 7); the inverse of the forward transform, and noise across
    the signed range (wraps and the overflow flag).  The flag equals the
    JAX numpy path's (the reference's recurrence), and the jit's up to its
    scan's extra filter-C check."""
    h, w, stages = GEOMETRIES[(filt + 3 * (mag_bits == 15)) % 6]
    rng = np.random.default_rng(1000 + 10 * filt + mag_bits)
    img = rng.integers(0, 1 << (mag_bits + 1), (2, h, w)).astype(np.int32)
    fwd, _ov = TW.forward_stages(torch.from_numpy(img), stages, filt,
                                 mag_bits)
    noise = rng.integers(-(1 << mag_bits), 1 << mag_bits,
                         (2, h, w)).astype(np.int32)
    for src in (fwd.numpy(), noise):
        out, ov = TW.inverse_stages(torch.from_numpy(src), stages, filt,
                                    mag_bits)
        out_w1, ov_w1 = TW.stage_passes(torch.from_numpy(src), stages, filt,
                                        mag_bits)
        ref, ov_ref = _jax_inverse_stages()(jnp.asarray(src), stages, filt,
                                            mag_bits, jnp)
        _ref_np, ov_np = JW.inverse_stages(src, stages, filt, mag_bits, np)
        assert np.array_equal(out.numpy(), np.asarray(ref))
        assert torch.equal(out_w1, out)
        assert bool(ov) == bool(ov_w1) == bool(ov_np)
        assert bool(ov_ref) == bool(ov) or (filt == 2 and bool(ov_ref))


@pytest.mark.parametrize("filt", range(7))
@pytest.mark.parametrize("mag_bits", [7, 15])
def test_first_use_check_inputs_match_the_jax_package(filt, mag_bits):
    """W1's plain version on the first-use check's cases of one filter and
    width (both axes, lines of 2-9 samples, stage blocks inside two
    canvases): the rest of the canvas kept, the block's lines equal to the
    JAX ``inverse_1d`` under jit (one call for both axes' lines of one
    length; its flag up to the scan's extra filter-C check), and each
    pass's overflow word equal to the JAX numpy path's (the reference's
    recurrence)."""
    cases = [c for c in kernel_check.w1_cases() if c[:2] == (filt, mag_bits)]
    assert sorted((axis, lh if axis == 0 else lw)
                  for _f, _m, axis, lh, lw, _x in cases) \
        == [(a, n) for a in (0, 1) for n in range(2, 10)]
    by_length: dict = {}
    for _f, _m, axis, lh, lw, x in cases:
        out, ov = TW.inverse_pass(x, lh, lw, axis, filt, mag_bits)
        keep = torch.ones_like(x, dtype=torch.bool)
        keep[:, :lh, :lw] = False
        assert torch.equal(out[keep], x[keep])
        block = x[:, :lh, :lw].numpy()
        lines = block.transpose(0, 2, 1) if axis == 0 else block
        got = out[:, :lh, :lw].numpy()
        n = lines.shape[-1]
        if _jax_defined(filt, n) and n >= 3:
            assert bool(ov) == bool(JW.inverse_1d(lines, filt, mag_bits,
                                                  np)[1])
        by_length.setdefault(n, []).append(
            (lines, got.transpose(0, 2, 1) if axis == 0 else got, bool(ov)))
    for n, parts in by_length.items():
        if not _jax_defined(filt, n):
            continue
        lines = np.concatenate([p[0] for p in parts], axis=1)
        y, ov_ref = _jax_inverse_1d()(jnp.asarray(lines), filt, mag_bits,
                                      jnp)
        assert np.array_equal(np.asarray(y),
                              np.concatenate([p[1] for p in parts], axis=1))
        assert bool(ov_ref) == (any(p[2] for p in parts)
                                or _scan_only_overflow(lines, filt, mag_bits))


def test_first_use_check_runs_w1_on_every_filter():
    before = [fn.launches for fn in kernel_check._COUNTED]
    assert kernel_check.check_library("wavelet", device="cpu") == ("W1",)
    assert [fn.launches for fn in kernel_check._COUNTED] == before
    cases = kernel_check.w1_cases()
    assert {(f, m, a) for f, m, a, *_ in cases} \
        == {(f, m, a) for f in range(7) for m in (7, 15) for a in (0, 1)}
    for _f, _m, axis, lh, lw, x in cases:
        assert x.shape == kernel_check.W1_CANVAS
        assert lh < x.shape[1] and lw < x.shape[2]      # a block inside
    canvases, ov = kernel_check._w1(torch.device("cpu"))
    assert canvases.shape == (len(cases),) + kernel_check.W1_CANVAS
    assert 0 < int(ov.sum()) < len(cases)      # some passes overflow


class _CudaLooking(torch.Tensor):
    """A CPU tensor that reports a CUDA device, to follow the wrapper's
    dispatch on a machine without CUDA."""

    @property
    def device(self):
        return torch.device("cuda", 0)


# where each plain function takes the filter
_FILT_ARG = {"inverse_pass_plain": 4, "inverse_2d": 1,
             "inverse_recurrence_plain": 2}


def _spy(monkeypatch, name="inverse_pass_plain"):
    """Record the filter of each call of the plain ``name``."""
    calls = []
    plain = getattr(TW, name)

    def spy(*args):
        calls.append(args[_FILT_ARG[name]])
        return plain(*args)
    monkeypatch.setattr(TW, name, spy)
    return calls


def _canvas():
    return (torch.arange(2 * 11 * 12, dtype=torch.int32).reshape(2, 11, 12)
            * 7 - 400)


def test_cpu_tensors_run_the_plain_version(monkeypatch):
    calls = _spy(monkeypatch)

    def no_build(name):
        raise AssertionError(f"built {name} for a CPU tensor")
    monkeypatch.setattr(kernels, "load", no_build)
    before = TW.inverse_pass.launches
    TW.inverse_pass(_canvas(), 9, 7, 0, 1, 15)
    TW.inverse_stages(_canvas(), 2, 0, 15)
    assert calls == [1]                         # inverse_stages: the chain
    assert TW.inverse_pass.launches == before


def test_cuda_tensors_never_run_the_plain_version(monkeypatch):
    """A CUDA tensor goes to the kernel's build, from ``inverse_pass`` and
    from ``inverse_stages`` at every filter; a failed build raises, and
    nothing falls back to the plain chain."""
    calls = _spy(monkeypatch)
    chain = _spy(monkeypatch, "inverse_2d")

    def failed_build(name):
        raise RuntimeError(f"nvcc failed for {name}.cu")
    monkeypatch.setattr(kernels, "load", failed_build)
    before = TW.inverse_pass.launches
    x = _canvas().as_subclass(_CudaLooking)
    with pytest.raises(RuntimeError, match="nvcc failed for wavelet.cu"):
        TW.inverse_pass(x, 9, 7, 1, 1, 15)
    for filt in range(7):
        with pytest.raises(RuntimeError, match="nvcc failed for wavelet.cu"):
            TW.inverse_stages(x, 2, filt, 15)
    assert calls == [] and chain == []
    assert TW.inverse_pass.launches == before


def test_other_devices_and_bad_inputs_are_refused(monkeypatch):
    calls = _spy(monkeypatch)
    x = _canvas()
    with pytest.raises(ValueError, match="unsupported device"):
        TW.inverse_pass(x.to("meta"), 9, 7, 0, 1, 15)
    cuda = x.as_subclass(_CudaLooking)
    with pytest.raises(ValueError, match="block 12x7 on axis 0"):
        TW.inverse_pass(cuda, 12, 7, 0, 1, 15)
    with pytest.raises(ValueError, match="block 9x1"):
        TW.inverse_pass(cuda, 9, 1, 1, 1, 15)
    with pytest.raises(ValueError, match="axis 2"):
        TW.inverse_pass(cuda, 9, 7, 2, 1, 15)
    with pytest.raises(ValueError, match="int32"):
        TW.inverse_pass(x.long().as_subclass(_CudaLooking), 9, 7, 0, 1, 15)
    with pytest.raises(ValueError, match=r"expected \(NC, H, W\)"):
        TW.inverse_pass(cuda[0], 9, 7, 0, 1, 15)
    with pytest.raises(ValueError, match="contiguous"):
        TW.inverse_pass(x.transpose(1, 2).contiguous().transpose(1, 2)
                        .as_subclass(_CudaLooking), 9, 7, 0, 1, 15)
    with pytest.raises(ValueError, match="another buffer"):
        TW.inverse_pass(cuda, 9, 7, 0, 1, 15, cuda)
    assert calls == []


def test_filter_a_needs_no_recurrence(monkeypatch):
    calls = _spy(monkeypatch, "inverse_recurrence_plain")
    x = torch.arange(2 * 9, dtype=torch.int32).reshape(2, 9)
    TW.inverse_1d(x, 0, 15)
    assert calls == []
    TW.inverse_1d(x, 6, 15)
    assert calls == [6]
    # filter A's lines of 2 samples: r read as 0 past its end, as the
    # recurrence reads it, so both give the same line
    two = torch.tensor([[5, -3], [100, 7]], dtype=torch.int32)
    assert torch.equal(TW.inverse_1d(two, 0, 7)[0],
                       TW.inverse_1d(two, 6, 7)[0])
