"""Kernel W1 (the inverse DWT's backward recurrence,
``ops/wavelet.inverse_recurrence``): its plain version against the JAX
package's ``inverse_1d`` with ``xp=jnp``, which runs the recurrence as a
``lax.scan`` (exact, tolerance 0), its first-use check, and its dispatch:
the plain version for CPU tensors only."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icer_compression_tpu.ops import wavelet as JW
from icer_compression_tpu_torch import kernel_check, kernels
from icer_compression_tpu_torch.core import constants as C
from icer_compression_tpu_torch.ops import wavelet as TW
from test_torch_entropy_slim import one_torch_thread  # noqa: F401

# filters whose inverse runs the recurrence (beta != 0): B-F and Q
RECURRENCE = [1, 2, 3, 4, 5, 6]


def _lengths(filt):
    """Line lengths 2-9 and two random ones up to 300.  Filter C at 4
    samples is left out: the JAX package raises there (its n = 1 term
    reads r[2] of a 2-entry r), and no codec line is shorter than 5 (an
    LL of at least 3 pixels a side)."""
    rng = np.random.default_rng(filt)
    short = [n for n in range(2, 10) if not (filt == 2 and n == 4)]
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


def test_first_use_check_runs_w1_on_every_filter():
    before = [fn.launches for fn in kernel_check._COUNTED]
    assert kernel_check.check_library("wavelet", device="cpu") == ("W1",)
    assert [fn.launches for fn in kernel_check._COUNTED] == before
    lines = kernel_check.recurrence_lines()
    assert {(f, m) for f, m, *_ in lines} \
        == {(f, m) for f in RECURRENCE for m in (7, 15)}
    _d, ov = kernel_check._w1(torch.device("cpu"))
    assert 0 < int(ov.sum()) < len(lines)      # some lines overflow
    for filt, *_ in lines:
        a_n1, _a0, _a1, beta = C.WAVELET_FILTER_PARAMETERS[filt]
        assert beta != 0 or a_n1 != 0


class _CudaLooking(torch.Tensor):
    """A CPU tensor that reports a CUDA device, to follow the wrapper's
    dispatch on a machine without CUDA."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _spy(monkeypatch):
    calls = []
    plain = TW.inverse_recurrence_plain

    def spy(*args):
        calls.append(args[2])
        return plain(*args)
    monkeypatch.setattr(TW, "inverse_recurrence_plain", spy)
    return calls


def _line(n=9):
    x = torch.arange(2 * n, dtype=torch.int32).reshape(2, n) * 7 - 40
    half = n // 2
    lows = x[:, :half + 1]
    r = torch.cat([torch.ones((2, 1), dtype=torch.int32),
                   lows[:, :-1] - lows[:, 1:]], dim=1)
    return x[:, half + 1:].contiguous(), r


def test_cpu_tensors_run_the_plain_version(monkeypatch):
    calls = _spy(monkeypatch)

    def no_build(name):
        raise AssertionError(f"built {name} for a CPU tensor")
    monkeypatch.setattr(kernels, "load", no_build)
    before = TW.inverse_recurrence.launches
    highs, r = _line()
    TW.inverse_recurrence(highs, r, 1, 15)
    assert calls == [1]
    assert TW.inverse_recurrence.launches == before


def test_cuda_tensors_never_run_the_plain_version(monkeypatch):
    """A CUDA tensor goes to the kernel's build; a failed build raises,
    and nothing falls back to the plain loop."""
    calls = _spy(monkeypatch)

    def failed_build(name):
        raise RuntimeError(f"nvcc failed for {name}.cu")
    monkeypatch.setattr(kernels, "load", failed_build)
    highs, r = _line()
    before = TW.inverse_recurrence.launches
    with pytest.raises(RuntimeError, match="nvcc failed for wavelet.cu"):
        TW.inverse_recurrence(highs.as_subclass(_CudaLooking),
                              r.as_subclass(_CudaLooking), 1, 15)
    assert calls == []
    assert TW.inverse_recurrence.launches == before


def test_other_devices_and_bad_inputs_are_refused(monkeypatch):
    calls = _spy(monkeypatch)
    highs, r = _line()
    with pytest.raises(ValueError, match="unsupported device"):
        TW.inverse_recurrence(highs.to("meta"), r.to("meta"), 1, 15)
    with pytest.raises(ValueError, match="do not form lines"):
        TW.inverse_recurrence(highs.as_subclass(_CudaLooking),
                              r[:, :-2].as_subclass(_CudaLooking), 1, 15)
    with pytest.raises(ValueError, match="int32"):
        TW.inverse_recurrence(highs.long().as_subclass(_CudaLooking),
                              r.as_subclass(_CudaLooking), 1, 15)
    assert calls == []


def test_filter_a_needs_no_recurrence(monkeypatch):
    calls = _spy(monkeypatch)
    x = torch.arange(2 * 9, dtype=torch.int32).reshape(2, 9)
    TW.inverse_1d(x, 0, 15)
    assert calls == []
    TW.inverse_1d(x, 6, 15)
    assert calls == [6]
