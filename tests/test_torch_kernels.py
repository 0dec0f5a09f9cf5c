"""The kernel build's cache key: a library is named by a hash of its source,
every local header it includes (``#include "..."``, recursively) and the
nvcc flags, so an edited header gives a new library path and a stale one is
never loaded. Computed without running nvcc."""

import shutil

import pytest

from cosmology_gnn_simulation_tpu_torch import kernels


def _copy_package(tmp_path, monkeypatch):
    shutil.copytree(kernels.PACKAGE_DIR / "csrc", tmp_path / "csrc")
    monkeypatch.setattr(kernels, "PACKAGE_DIR", tmp_path)
    monkeypatch.setattr(kernels, "_nvcc", lambda: (_ for _ in ()).throw(
        AssertionError("the library path must not run nvcc")))
    return tmp_path / "csrc"


def test_both_tails_hash_their_shared_header():
    for name in ("fused_tail", "fused_tail_bwd"):
        names = [p.name for p in kernels._sources(kernels.PACKAGE_DIR / "csrc" / f"{name}.cu")]
        assert names == [f"{name}.cu", "tail_common.cuh", "sm90.cuh"]
    for name in ("fused_tail_wide", "fused_tail_wide_bwd"):
        names = [p.name for p in kernels._sources(kernels.PACKAGE_DIR / "csrc" / f"{name}.cu")]
        assert names == [f"{name}.cu", "tail_wide.cuh", "tail_common.cuh", "sm90.cuh"]


def test_window_matmul_hashes_the_hopper_header():
    names = [p.name for p in kernels._sources(kernels.PACKAGE_DIR / "csrc" / "window_matmul.cu")]
    assert names == ["window_matmul.cu", "sm90.cuh"]


_TAILS = {"fused_tail", "fused_tail_bwd", "fused_tail_wide", "fused_tail_wide_bwd"}


@pytest.mark.parametrize("header, changed", [
    ("tail_common.cuh", _TAILS),
    ("sm90.cuh", _TAILS | {"window_matmul"}),
    ("tail_wide.cuh", {"fused_tail_wide", "fused_tail_wide_bwd"}),
])
def test_editing_an_included_header_changes_the_library_path(tmp_path, monkeypatch, header,
                                                             changed):
    csrc = _copy_package(tmp_path, monkeypatch)
    before = {name: kernels._library_path(name) for name in kernels.SOURCES}
    path = csrc / header
    path.write_text(path.read_text() + "\n// edited\n")
    after = {name: kernels._library_path(name) for name in kernels.SOURCES}
    for name in kernels.SOURCES:
        includes = header in [p.name for p in kernels._sources(csrc / f"{name}.cu")]
        assert (after[name] != before[name]) == includes, name
    assert {name for name in kernels.SOURCES if after[name] != before[name]} == changed


def test_nested_includes_are_hashed(tmp_path, monkeypatch):
    csrc = _copy_package(tmp_path, monkeypatch)
    (csrc / "inner.cuh").write_text("#pragma once\n")
    (csrc / "outer.cuh").write_text('#pragma once\n#include "inner.cuh"\n')
    (csrc / "probe.cu").write_text('#include "outer.cuh"\n#include <stdint.h>\n')
    assert [p.name for p in kernels._sources(csrc / "probe.cu")] == [
        "probe.cu", "outer.cuh", "inner.cuh"]
    before = kernels._library_path("probe")
    (csrc / "inner.cuh").write_text("#pragma once\n// edited\n")
    assert kernels._library_path("probe") != before


def test_a_library_s_own_flags_change_only_its_path(monkeypatch):
    before = {name: kernels._library_path(name) for name in kernels.SOURCES}
    monkeypatch.setitem(kernels.EXTRA_FLAGS, "fused_tail", ["-lineinfo"])
    after = {name: kernels._library_path(name) for name in kernels.SOURCES}
    assert {name for name in kernels.SOURCES if after[name] != before[name]} == {"fused_tail"}
