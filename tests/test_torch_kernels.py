"""PyTorch port: the kernel sources and their build, checked on the CPU.

No compiler is needed: these tests read ``das3r_tpu_torch/csrc`` and the
library names that ``ops/splat/kernels.py`` derives from it. A library's
name must change with its source, with every shared header and with the
flags, or a build directory would load a stale library.
"""
import re
import shutil

import pytest

from das3r_tpu_torch.ops.splat import kernels

SOURCES = sorted(p.name for p in kernels.CSRC.iterdir()
                 if p.suffix in (".cu", ".cuh"))
HEADERS = [s for s in SOURCES if s.endswith(".cuh")]
KERNELS = sorted(kernels.SIGNATURES)


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    """A copy of csrc/ that ``kernels`` reads, and a build directory."""
    src = tmp_path / "csrc"
    shutil.copytree(kernels.CSRC, src)
    monkeypatch.setattr(kernels, "CSRC", src)
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    return src


def test_sources_name_the_signed_kernels():
    cu = sorted(s[:-3] for s in SOURCES if s.endswith(".cu"))
    assert cu == KERNELS
    assert HEADERS, "the backward kernels share a header"


@pytest.mark.parametrize("name", KERNELS)
def test_launch_function_takes_the_signed_arguments(name):
    """Each source defines ``extern "C" int <name>_launch(...)`` with as
    many parameters as its ctypes signature (the stream last)."""
    text = (kernels.CSRC / f"{name}.cu").read_text()
    m = re.search(r'extern "C" int ' + name + r"_launch\(([^)]*)\)", text)
    assert m, f"{name}.cu defines no {name}_launch"
    params = [p.strip() for p in m.group(1).split(",")]
    assert len(params) == len(kernels.SIGNATURES[name])
    assert params[-1] == "void* stream"


@pytest.mark.parametrize("source", SOURCES)
def test_includes_name_files_in_csrc(source):
    text = (kernels.CSRC / source).read_text()
    for inc in re.findall(r'#include "([^"]+)"', text):
        assert (kernels.CSRC / inc).is_file(), f"{source} includes {inc}"


@pytest.mark.parametrize("header", HEADERS)
def test_editing_a_header_renames_every_library(csrc_copy, header):
    before = {name: kernels._lib_path(name) for name in KERNELS}
    with open(csrc_copy / header, "a") as f:
        f.write("\n// edited\n")
    after = {name: kernels._lib_path(name) for name in KERNELS}
    for name in KERNELS:
        assert after[name] != before[name], name
        assert after[name].parent == kernels.BUILD_DIR


@pytest.mark.parametrize("name", KERNELS)
def test_editing_a_source_renames_only_its_library(csrc_copy, name):
    before = {k: kernels._lib_path(k) for k in KERNELS}
    with open(csrc_copy / f"{name}.cu", "a") as f:
        f.write("\n// edited\n")
    for k in KERNELS:
        assert (kernels._lib_path(k) != before[k]) == (k == name), k


# the four blend kernels: D and E on the window path, B and C on the entry
# stream
BLEND_KERNELS = ["window_blend_forward", "window_blend_backward",
                 "blend_forward", "blend_backward"]
FORWARD_KERNELS = ["window_blend_forward", "blend_forward"]
STEP_HEADER = "blend_step.cuh"


def code(source: str) -> str:
    """``source`` without its comments."""
    return re.sub(r"//[^\n]*|/\*.*?\*/", "", (kernels.CSRC / source)
                  .read_text(), flags=re.S)


@pytest.mark.parametrize("name", BLEND_KERNELS)
def test_blend_kernels_run_the_one_forward_step(name):
    """Kernels B, C, D and E include the header that defines the forward's
    step and evaluate no exp of their own, so that the backward kernels'
    replays make their forward kernels' contribute decisions."""
    assert f'#include "{STEP_HEADER}"' in code(f"{name}.cu")
    assert "expf" not in code(f"{name}.cu")
    assert "evaluate(" in code(f"{name}.cu")


def test_forward_step_is_built_without_fast_math():
    """The step's exp is the IEEE expf, and nothing lets the compiler fuse
    or approximate: the forward kernels' sources (B, D), the header and the
    flags."""
    step = code(STEP_HEADER)
    assert re.search(r"\bexpf\(", step)
    for source in (STEP_HEADER, *(f"{k}.cu" for k in FORWARD_KERNELS)):
        for word in ("__expf", "fast-math", "fast_math", "__fmaf", "fmaf("):
            assert word not in code(source), (source, word)
    assert "--fmad=false" in kernels.NVCC_FLAGS
    assert not any("fast" in f for f in kernels.NVCC_FLAGS)


def test_library_name_is_stable_and_carries_the_flags(csrc_copy,
                                                      monkeypatch):
    name = KERNELS[0]
    path = kernels._lib_path(name)
    assert kernels._lib_path(name) == path
    assert path.name.startswith(f"lib{name}_") and path.suffix == ".so"
    monkeypatch.setattr(kernels, "NVCC_FLAGS", kernels.NVCC_FLAGS + ("-G",))
    assert kernels._lib_path(name) != path
