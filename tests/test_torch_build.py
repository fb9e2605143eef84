"""The kernel build's cache key: a library is reused only while its source,
the shared headers it may include and the flags are unchanged.  Needs no
nvcc: only the library paths are computed."""
import shutil

import pytest

from repro_torch.kernels import _build


@pytest.fixture
def sources(tmp_path, monkeypatch):
    """A copy of every source and of the shared include directory, with
    ``_build`` pointed at it."""
    inc = tmp_path / "csrc"
    shutil.copytree(_build.INCLUDE_DIR, inc)
    copies = {}
    for name, src in _build.SOURCES.items():
        copies[name] = tmp_path / name / src.name
        copies[name].parent.mkdir()
        shutil.copy(src, copies[name])
    monkeypatch.setattr(_build, "SOURCES", copies)
    monkeypatch.setattr(_build, "INCLUDE_DIR", inc)
    return copies, inc


def test_flags_pass_the_shared_include_directory():
    i = _build.NVCC_FLAGS.index("-I")
    assert _build.NVCC_FLAGS[i + 1] == str(_build.INCLUDE_DIR)
    assert (_build.INCLUDE_DIR / "mma.cuh").is_file()


@pytest.mark.parametrize("name", sorted(_build.SOURCES))
def test_edited_header_rebuilds_every_library(sources, name):
    copies, inc = sources
    before = _build.library_path(name)
    assert _build.library_path(name) == before
    header = inc / "mma.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert _build.library_path(name) != before


def test_new_header_rebuilds(sources):
    _, inc = sources
    before = _build.library_path("flash_mask")
    (inc / "extra.cuh").write_text("#pragma once\n")
    assert _build.library_path("flash_mask") != before


def test_edited_source_rebuilds_only_its_library(sources):
    copies, _ = sources
    before = {name: _build.library_path(name) for name in copies}
    src = copies["masked_matmul"]
    src.write_text(src.read_text() + "\n// edited\n")
    after = {name: _build.library_path(name) for name in copies}
    assert after["masked_matmul"] != before["masked_matmul"]
    assert all(after[n] == before[n] for n in copies if n != "masked_matmul")
