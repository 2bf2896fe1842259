"""The kernel build cache of the port (``kernels.lib_path``): a library is
named by its source and by the shared headers under ``csrc/``, so an edited
header rebuilds every source instead of loading a stale library; and the
first-use check of a fresh build (``kernels.build_all`` with
``kernel_check``), its rebuild-once rule and its fixed inputs.  No compiler
or card is needed: the names are computed, and the compiler, the loader
and the on-card check are stubbed."""

import re

import pytest

from icer_compression_tpu_torch import kernels
from test_torch_entropy_slim import one_torch_thread  # noqa: F401


def test_lib_path_follows_source_and_headers(tmp_path, monkeypatch):
    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    monkeypatch.setattr(kernels, "CSRC", csrc)
    monkeypatch.setattr(kernels, "BUILD", build)
    (csrc / "k.cu").write_text('#include "common.cuh"\n')
    (csrc / "common.cuh").write_text("// v1\n")
    first = kernels.lib_path("k")
    assert first.parent == build and first.name.startswith("k-")
    assert kernels.lib_path("k") == first

    (csrc / "common.cuh").write_text("// v2\n")
    second = kernels.lib_path("k")
    assert second != first

    (csrc / "other.cuh").write_text("// a new header\n")
    third = kernels.lib_path("k")
    assert third not in (first, second)

    (csrc / "k.cu").write_text('#include "common.cuh"\n// edited\n')
    assert kernels.lib_path("k") not in (first, second, third)


def test_every_kernel_source_is_named():
    """Each source in ``csrc/`` is one kernel library of ``KERNELS``, and
    the shared header is there for them to include."""
    sources = sorted(p.stem for p in kernels.CSRC.glob("*.cu"))
    assert sources == sorted(kernels.KERNELS)
    assert (kernels.CSRC / "coder_common.cuh").is_file()
    for name in ("slim_encode", "full_encode", "plane_decode"):
        src = (kernels.CSRC / f"{name}.cu").read_text()
        assert '#include "coder_common.cuh"' in src
        assert "int bin_of(" not in src


@pytest.mark.parametrize("source,module", [
    ("slim_encode", "entropy_slim"), ("full_encode", "entropy_full"),
    ("plane_decode", "plane_decode"), ("slim_pack", "entropy_slim")])
def test_lut_layouts_match_the_cuda_sources(source, module):
    """Every ``constexpr int kLut<Name> = <offset>;`` of a kernel source
    equals the wrapper's ``LUT_<NAME>`` (the launch refuses a LUT of
    another size, and a shifted table is read wrong without a word)."""
    import importlib
    mod = importlib.import_module(f"icer_compression_tpu_torch.ops.{module}")
    consts = re.findall(r"constexpr int kLut(\w+) = (\d+);",
                        (kernels.CSRC / f"{source}.cu").read_text())
    assert ("Size", str(mod.LUT_SIZE)) in consts
    for name, value in consts:
        attr = "LUT_" + name.upper()
        if hasattr(mod, attr):
            assert getattr(mod, attr) == int(value), attr
    assert len(mod._LUT_NP if hasattr(mod, "_LUT_NP")
               else mod.full_luts("cpu")) == mod.LUT_SIZE


# ---- the first-use check of a fresh build (``kernels.build_all``), with the
# compiler, the loader and the on-card check stubbed -----------------------

class _Proc:
    """A finished compile: ``_compile``'s stub writes the library itself."""
    returncode = 0

    def communicate(self):
        return "ptxas info: stub", None


@pytest.fixture
def stub_build(tmp_path, monkeypatch):
    """kernels.build_all into ``tmp_path`` with a compiler stub that counts
    its runs, a loader stub and a scripted first-use check: each entry of
    ``script`` is the result of one check (True passes, False mismatches).
    Returns (compiles, script, opened)."""
    from icer_compression_tpu_torch import kernel_check
    monkeypatch.setattr(kernels, "BUILD", tmp_path)
    monkeypatch.setattr(kernels, "_LIBS", {})
    monkeypatch.setattr(kernels, "GUARD", {})
    compiles, script, opened = [], [], []

    def compile_stub(name, out):
        out.write_bytes(b"library")
        compiles.append((name, out.name))
        return _Proc()

    def open_stub(path):
        opened.append(path.name)
        return f"lib@{path.name}"

    def check_stub(name):
        assert kernels._LIBS[name] == f"lib@{opened[-1]}"
        assert not kernels.lib_path(name).exists()
        if not script.pop(0):
            raise kernel_check.KernelMismatch(
                f"{name}: output rec differs from the plain version first "
                "at index (3, 1)")
        return ("instance",)

    monkeypatch.setattr(kernels, "_compile", compile_stub)
    monkeypatch.setattr(kernels, "_open", open_stub)
    monkeypatch.setattr(kernel_check, "check_library", check_stub)
    return compiles, script, opened


def test_guard_passing_check_keeps_one_build(stub_build, tmp_path):
    compiles, script, opened = stub_build
    script += [True]
    kernels.build_all(("slim_encode",))
    assert len(compiles) == 1 and len(opened) == 1
    final = kernels.lib_path("slim_encode")
    assert final.exists() and sorted(tmp_path.iterdir()) == [final]
    assert kernels.GUARD["slim_encode"]["instances"] == ("instance",)
    assert kernels.GUARD["slim_encode"]["rebuilt"] is False
    assert kernels.load("slim_encode") == f"lib@{opened[0]}"
    kernels.build_all(("slim_encode",))      # cached: neither built
    assert len(compiles) == 1 and not script  # nor checked again


def test_guard_failing_once_rebuilds_once(stub_build, tmp_path):
    compiles, script, opened = stub_build
    script += [False, True]
    kernels.build_all(("plane_decode",))
    assert len(compiles) == 2 and len(opened) == 2 and not script
    assert compiles[0][1] != compiles[1][1]
    final = kernels.lib_path("plane_decode")
    assert sorted(tmp_path.iterdir()) == [final]
    assert kernels.GUARD["plane_decode"]["rebuilt"] is True
    assert kernels._LIBS["plane_decode"] == f"lib@{opened[1]}"


def test_guard_failing_twice_raises_and_keeps_nothing(stub_build, tmp_path):
    compiles, script, _opened = stub_build
    script += [False, False]
    with pytest.raises(RuntimeError, match=r"full_encode\.cu failed its "
                       r"first-use check twice(.|\n)*output rec differs "
                       r"from the plain version first at index \(3, 1\)"):
        kernels.build_all(("full_encode",))
    assert len(compiles) == 2
    assert not list(tmp_path.iterdir())
    assert "full_encode" not in kernels._LIBS
    assert "full_encode" not in kernels.GUARD


def test_guard_covers_every_kernel_instance():
    """The first-use check has an instance for every launch function that
    each library of ``KERNELS`` exports, and no other (kernel 1's two-word
    launch has two: the small block and the block past 2**17)."""
    from icer_compression_tpu_torch import kernel_check
    assert sorted(kernel_check.CHECKS) == sorted(kernels.KERNELS)
    for name in kernels.KERNELS:
        exported = re.findall(r'extern "C" int (\w+)\(',
                              (kernels.CSRC / f"{name}.cu").read_text())
        assert sorted({i.symbol for i in kernel_check.CHECKS[name]}) \
            == sorted(exported)


@pytest.fixture(scope="module")
def wide_plain():
    """The plain version's outputs on the first-use check's block past
    2**17 ordinals (about a minute), once for the module."""
    import torch
    from icer_compression_tpu_torch import kernel_check as K
    return K._k1_wide(torch.device("cpu"))


@pytest.mark.parametrize("name", ["slim_encode", "plane_decode",
                                  "full_encode", "slim_pack"])
def test_guard_inputs_run_through_every_wrapper(name, request, monkeypatch):
    """The check's fixed inputs are valid for each instance's wrapper (here
    the plain versions on both sides; the block past 2**17 ordinals, run
    once for the module, against its pinned digests) and leave the launch
    counts alone."""
    import torch
    from icer_compression_tpu_torch import kernel_check as K
    if name == "slim_encode":
        out = request.getfixturevalue("wide_plain")
        monkeypatch.setattr(K, "_k1_wide", lambda dev: out)
    before = [fn.launches for fn in K._COUNTED]
    assert K.check_library(name, device="cpu") \
        == tuple(i.label for i in K.CHECKS[name])
    assert [fn.launches for fn in K._COUNTED] == before
    words = K.coder_words()
    assert words.shape == (K.L, K.LANES)
    assert int((words & 1).sum()) > 0 and not bool((words[:, 0] != 0).any())
    assert bool((((words >> 1) & 31)[(words & 1) == 1] == 17).any())
    _blob, unit = K.decode_unit()
    assert unit["offs"].shape == (9, 4) and (unit["hmax"], unit["wmax"]) \
        == (16, 11)
    err = K._k2(torch.device("cpu"))[1]
    assert 0 < int(err.sum()) < 4          # the cut retires some lanes


def test_wide_check_block_passes_2_17_ordinals_and_32_evictions(
        wide_plain):
    """The first-use check's pinned block: the plain version's digests are
    the pinned ones; its ordinals pass 2**17 (records, evictions and open
    ordinals, whose 17-bit field in fstate wraps), its evictions pass 32
    and sit within the sized buffer unflagged, and its packed payloads
    equal the sequential coder's."""
    import torch
    from icer_compression_tpu_torch import kernel_check as K
    from icer_compression_tpu_torch.backend import sequential as TS
    from icer_compression_tpu_torch.ops import entropy_slim as ES
    rec1, rec2, fstate, misc, ev1, ev2, fopen = wide_plain
    assert {n: K.digest(t) for n, t in zip(K._TWO_WORD, wide_plain)} \
        == K.WIDE_DIGESTS
    assert int(torch.where(rec1 != 0, rec2, 0).max()) > 1 << 17
    assert int(torch.where(ev1 != 0, ev2, 0).max()) > 1 << 16
    assert int(fopen.max()) > 1 << 17
    assert torch.equal(fstate & 0x1FFFF, fopen & 0x1FFFF)
    assert bool((misc[2] > ES.NEV).all()) and not misc[0].any()
    ops, keys = ES.slim_sort_operands(rec1, rec2, fstate, fopen, ev1, ev2)
    L = K.WIDE_L
    payload, total, over = ES.order_and_pack_lanes_two_word(
        ops, keys, ((2 * L + 170 + 255) // 256) * 256, ops.shape[0])
    w = K.wide_words().numpy()
    for lane in range(w.shape[1]):
        seq = TS.encode_emissions(w[:, lane] & 1, (w[:, lane] >> 1) & 31,
                                  (w[:, lane] >> 6) & 1)
        assert int(misc[2, lane]) == seq[2] and not bool(over[lane])
        nb = int(total[lane])
        assert (bytes(payload[lane, :(nb + 7) // 8].numpy()), nb) \
            == seq[:2], lane


def test_first_difference_names_the_index():
    import torch
    from icer_compression_tpu_torch.kernel_check import first_difference
    a = torch.zeros((4, 3), dtype=torch.int32)
    b = a.clone()
    assert first_difference("K2", "out", a, b) is None
    b[2, 1] = 7
    b[3, 0] = 1
    msg = first_difference("K2", "out", a, b)
    assert "K2: output out" in msg and "index (2, 1)" in msg \
        and "2 elements" in msg
    assert "int32 (4, 3)" in first_difference("K2", "pos", a, b[:2])


def _device_functions(src: str) -> list:
    """Names of the ``__global__`` and ``__device__`` functions that a CUDA
    source defines."""
    src = re.sub(r"__launch_bounds__\([^)]*\)", "", src)
    return re.findall(r"__(?:global|device)__[^(;{]*?(\w+)\s*\(", src)


def test_sort_pack_source_names_and_wiring():
    """``csrc/slim_pack.cu``: no kernel or device function name holds a
    name the benchmark counts as kernel 1 or kernel 2 (its K1 and K2
    records and roofline shares match names by fragment); the source is a
    library of ``KERNELS``; each launch function has its run slot, which
    the launch wrapper passes, and an instance of the first-use check."""
    from benchmark.roofline import K1_NAMES, K2_NAMES
    from icer_compression_tpu_torch import kernel_check
    from icer_compression_tpu_torch.ops import entropy_slim as ES
    src = (kernels.CSRC / "slim_pack.cu").read_text()
    names = _device_functions(src)
    assert {"slim_pack_place_kernel", "slim_pack_sums_kernel",
            "slim_pack_bits_kernel", "codeword"} <= set(names)
    for name in names:
        for fragment in K1_NAMES + K2_NAMES:
            assert fragment not in name, (name, fragment)
    assert "slim_pack" in kernels.KERNELS
    exported = re.findall(r'extern "C" int (\w+)\(', src)
    assert sorted(exported) == ["slim_pack_launch",
                                "slim_pack_two_word_launch"]
    checked = {i.symbol for i in kernel_check.CHECKS["slim_pack"]}
    assert checked == set(exported)
    for symbol in exported:
        slot = symbol[:-len("_launch")]
        assert slot in kernels.RUN_SLOTS
    launch = (kernels.CSRC.parent / "ops" / "entropy_slim.py").read_text()
    assert '"slim_pack_two_word" if two_word' in launch
    assert ES.pack_lanes_slim in kernel_check._COUNTED
    assert ES.pack_lanes_slim_two_word in kernel_check._COUNTED


def test_sort_pack_blocks_match_the_wrapper():
    """The wrapper sizes the scratch rows and the per-block sums by the
    source's ordinals a thread holds and a block takes."""
    from icer_compression_tpu_torch.ops import entropy_slim as ES
    src = (kernels.CSRC / "slim_pack.cu").read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert int(consts["kPer"]) == ES.PACK_ALIGN
    assert int(consts["kThreads"]) * int(consts["kPer"]) == ES.PACK_CHUNK
    assert "kChunk = kThreads * kPer" in src
