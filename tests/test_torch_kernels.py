"""The port's kernel build bookkeeping (ray_lightning_tpu_torch/kernels/) on
the CPU: when a library counts as stale. Nothing here needs nvcc."""
import os
import shutil

import pytest

from ray_lightning_tpu_torch import kernels


@pytest.fixture
def tree(tmp_path, monkeypatch):
    """A temp copy of csrc/ with a library for each source, all built after
    every source and header was last written."""
    csrc = tmp_path / "csrc"
    shutil.copytree(kernels.CSRC_DIR, csrc)
    build = tmp_path / "build"
    build.mkdir()
    monkeypatch.setattr(kernels, "CSRC_DIR", csrc)
    monkeypatch.setattr(kernels, "BUILD_DIR", build)
    sources = sorted(p.name for p in csrc.glob("*.cu"))
    for p in csrc.iterdir():
        os.utime(p, (1000, 1000))
    for name in sources:
        lib = kernels.library_path(name)
        lib.write_bytes(b"")
        os.utime(lib, (2000, 2000))
    return csrc, sources


def test_built_libraries_are_fresh(tree):
    _, sources = tree
    assert sources and not any(kernels._stale(n) for n in sources)


def test_missing_library_is_stale(tree):
    _, sources = tree
    kernels.library_path(sources[0]).unlink()
    assert kernels._stale(sources[0])
    assert not any(kernels._stale(n) for n in sources[1:])


def test_newer_source_makes_only_its_library_stale(tree):
    csrc, sources = tree
    os.utime(csrc / "flash_fwd.cu", (3000, 3000))
    assert [n for n in sources if kernels._stale(n)] == ["flash_fwd.cu"]


def test_newer_header_makes_every_library_stale(tree):
    """An edit to the shared tile header rebuilds both flash libraries (and,
    conservatively, every other one)."""
    csrc, sources = tree
    assert (csrc / "hopper_tile.cuh").exists()
    os.utime(csrc / "hopper_tile.cuh", (3000, 3000))
    stale = {n for n in sources if kernels._stale(n)}
    assert {"flash_fwd.cu", "flash_bwd.cu"} <= stale
    assert stale == set(sources)
