"""repro_torch.kernels._build: what a kernel library is built from and keyed on.

No compiler runs here: the build command is captured, not started."""

from __future__ import annotations

import shutil

import pytest

from repro_torch.kernels import _build

#: the libraries whose kernels include the shared b1 tile header
B1_LIBRARIES = ("cim_popcount", "cim_matmul_packed", "cim_matmul")
#: the libraries whose kernels build weight planes from int8 weights with
#: the shared plane header
PLANE_LIBRARIES = ("cim_matmul_packed", "cim_matmul")


def test_shared_header_is_in_the_include_directory():
    """The b1 product's helpers and the plane build live once, in the
    shared include directory, and in no library's own csrc/."""
    for header, users in (("mma.cuh", B1_LIBRARIES),
                          ("planes.cuh", PLANE_LIBRARIES)):
        assert (_build.SHARED_INCLUDE / header).is_file()
        for name in _build.LIBRARIES:
            assert not (_build.KERNELS / name / "csrc" / header).exists()
        for name in users:
            src = "".join(p.read_text() for p in _build._sources(name))
            assert f'#include "{header}"' in src


@pytest.mark.parametrize("name", B1_LIBRARIES)
def test_library_key_covers_the_shared_headers(name, tmp_path, monkeypatch):
    """An edit to a shared header gives every library a new cache key, so
    no stale library is loaded; the same header gives the same key."""
    shared = tmp_path / "csrc"
    shutil.copytree(_build.SHARED_INCLUDE, shared)
    monkeypatch.setattr(_build, "SHARED_INCLUDE", shared)
    before = _build._paths(name)
    assert _build._paths(name) == before
    header = shared / "mma.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = _build._paths(name)
    assert after[0] != before[0] and after[1] != before[1]
    assert after[0].parent == before[0].parent == _build.build_dir()


@pytest.mark.parametrize("name", PLANE_LIBRARIES)
def test_library_key_covers_the_plane_header(name, tmp_path, monkeypatch):
    """An edit to the shared plane build rebuilds both libraries that
    include it."""
    shared = tmp_path / "csrc"
    shutil.copytree(_build.SHARED_INCLUDE, shared)
    monkeypatch.setattr(_build, "SHARED_INCLUDE", shared)
    before = _build._paths(name)
    header = shared / "planes.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert _build._paths(name)[0] != before[0]


def test_nvcc_gets_the_shared_include_directory(tmp_path, monkeypatch):
    """Every library's nvcc command passes -I for the shared directory."""
    calls = []

    class Captured:
        returncode = 1

        def __init__(self, args, **kwargs):
            calls.append(args)

        def communicate(self):
            return "not run", None

    monkeypatch.setattr(_build, "build_dir", lambda: tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "Popen", Captured)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _build.build_all()
    assert len(calls) == len(_build.LIBRARIES)
    for args in calls:
        assert f"-I{_build.SHARED_INCLUDE}" in args
