"""Packaging and the build directory of the port's CUDA kernels, on the CPU.

An installed port must hold every file ``ops/cuda_build.py`` compiles
(each ``csrc/*.cu`` and the headers they include), the native JPEG
decoder's source and Makefile (``data/native.py``) and every subpackage, and
must build where its own ``csrc/build/`` cannot be written (a read-only
``site-packages``): there the libraries go to the user's cache under the
same hashed names. The build runs here through a stand-in ``nvcc`` that
writes an empty library, since there is no CUDA compiler on this machine.
"""

import os
import re
import stat
import tomllib
from pathlib import Path

import pytest

from multimodal_active_ai_tpu_torch.ops import cuda_build

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "multimodal_active_ai_tpu_torch"


def _setuptools():
    with open(ROOT / "pyproject.toml", "rb") as f:
        return tomllib.load(f)["tool"]["setuptools"]


def test_package_data_ships_every_kernel_source_and_header():
    globs = _setuptools()["package-data"]["multimodal_active_ai_tpu_torch"]
    shipped = {p.relative_to(PACKAGE).as_posix() for g in globs for p in PACKAGE.glob(g)}
    csrc = PACKAGE / "csrc"
    sources = {f"csrc/{p.name}" for p in csrc.iterdir() if p.suffix in (".cu", ".cuh")}
    includes = {f"csrc/{name}" for p in csrc.iterdir() if p.suffix in (".cu", ".cuh")
                for name in re.findall(r'#include\s+"([^"]+)"', p.read_text())}
    assert "csrc/stat_finish.cuh" in includes          # read by B2 and B3
    assert all((PACKAGE / f).is_file() for f in includes), includes
    assert sources | includes <= shipped, (sources | includes) - shipped


def test_package_data_ships_the_native_decoder_sources():
    """``data/native.py`` runs ``make -C runtime`` at first use: an
    installed port needs the Makefile and every source it compiles."""
    globs = _setuptools()["package-data"]["multimodal_active_ai_tpu_torch"]
    shipped = {p.relative_to(PACKAGE).as_posix() for g in globs for p in PACKAGE.glob(g)}
    makefile = (PACKAGE / "runtime" / "Makefile").read_text()
    sources = {f"runtime/{name}" for name in re.findall(r"\b(\w+\.cc)\b", makefile)}
    assert sources == {"runtime/loader.cc"}
    assert sources | {"runtime/Makefile"} <= shipped, shipped


def test_every_port_subpackage_is_packaged():
    packages = set(_setuptools()["packages"])
    found = {".".join(p.parent.relative_to(ROOT).parts) for p in PACKAGE.rglob("__init__.py")}
    assert "multimodal_active_ai_tpu_torch.rl" in found
    assert found <= packages, found - packages


def test_build_dir_falls_back_to_the_user_cache(tmp_path, monkeypatch):
    """A build directory under a regular file cannot be created (a
    permission bit would not stop a test that runs as root)."""
    blocker = tmp_path / "package"
    blocker.write_text("")
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    cache = tmp_path / "cache" / "multimodal_active_ai_tpu_torch" / "csrc-build"
    assert cuda_build.user_cache_dir() == cache
    assert cuda_build.build_dir(blocker / "build") == cache and cache.is_dir()
    assert cuda_build.build_dir(tmp_path / "writable") == tmp_path / "writable"
    monkeypatch.delenv("XDG_CACHE_HOME")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    assert cuda_build.user_cache_dir() == (tmp_path / "home" / ".cache"
                                           / "multimodal_active_ai_tpu_torch" / "csrc-build")


def test_build_lands_in_the_user_cache_with_the_same_name(tmp_path, monkeypatch):
    """``build`` where ``csrc/build`` cannot be created: the library is
    written to the cache, named by the same hash as in ``csrc/build``."""
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text('#!/bin/sh\nwhile [ $# -gt 0 ]; do\n  if [ "$1" = "-o" ]; then out="$2"; fi\n'
                    '  shift\ndone\necho "ptxas info: stand-in"\n: > "$out"\n')
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    (tmp_path / "package").write_text("")
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "package" / "build")
    monkeypatch.setattr(cuda_build, "_built", {})
    built = cuda_build.build(["stat_sums"])["stat_sums"]
    cache = cuda_build.user_cache_dir()
    assert built.path.parent == cache and built.path.is_file()
    assert "stand-in" in built.log and built.path.with_suffix(".log").is_file()
    _, in_tree = cuda_build._target("stat_sums", str(nvcc), tmp_path / "package" / "build")
    assert built.path.name == in_tree.name
    assert not any(p.suffix == ".tmp" for p in cache.iterdir())


def test_build_dir_raises_when_nothing_is_writable(tmp_path, monkeypatch):
    (tmp_path / "a").write_text("")
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "a" / "cache"))
    with pytest.raises(RuntimeError, match="no writable build directory"):
        cuda_build.build_dir(tmp_path / "a" / "build")
    assert not os.path.exists(tmp_path / "a" / "build")
