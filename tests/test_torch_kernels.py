"""The kernel build cache of the port (``kernels.lib_path``): a library is
named by its source and by the shared headers under ``csrc/``, so an edited
header rebuilds every source instead of loading a stale library.  No
compiler is needed: only the names are computed."""

import re

import pytest

from icer_compression_tpu_torch import kernels


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
    ("plane_decode", "plane_decode")])
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
