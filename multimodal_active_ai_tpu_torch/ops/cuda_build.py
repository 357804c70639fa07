"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``)
into a shared library with a plain C interface, loaded with ``ctypes``. A
build happens at first use, into ``csrc/build/`` (listed in ``.gitignore``),
and is reused while the source, the shared ``csrc/*.cuh`` headers, the flags
and the compiler are unchanged: the library's file name carries a hash of
all four. Where ``csrc/build/`` cannot be created or written (an installed
package in a read-only ``site-packages``), the libraries go to the user's
cache, ``$XDG_CACHE_HOME`` or ``~/.cache``, under
``multimodal_active_ai_tpu_torch/csrc-build/``, with the same file names.

Nothing here runs at import time, so modules that launch kernels import
cleanly on machines without ``nvcc`` or a GPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from dataclasses import dataclass
from pathlib import Path
from typing import Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclass(frozen=True)
class Built:
    """One compiled kernel library and what ``nvcc`` reported for it
    (``-Xptxas -v``: registers, shared memory and spills per kernel)."""

    name: str
    path: Path
    log: str


_loaded: dict[str, ctypes.CDLL] = {}
_built: dict[str, Built] = {}


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``, else
    ``/usr/local/cuda/bin/nvcc``; raises if none exists."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's CUDA kernels are built from source at first use")


def user_cache_dir() -> Path:
    """The per-user build directory: ``$XDG_CACHE_HOME`` (else
    ``~/.cache``) ``/multimodal_active_ai_tpu_torch/csrc-build``."""
    base = os.environ.get("XDG_CACHE_HOME") or os.path.join(os.path.expanduser("~"), ".cache")
    return Path(base) / "multimodal_active_ai_tpu_torch" / "csrc-build"


def build_dir(preferred: Path) -> Path:
    """``preferred`` (``csrc/build/``), created if needed, or the per-user
    cache directory where ``preferred`` cannot be created or written."""
    for directory in (preferred, user_cache_dir()):
        try:
            directory.mkdir(parents=True, exist_ok=True)
        except OSError:
            continue
        if os.access(directory, os.W_OK | os.X_OK):
            return directory
    raise RuntimeError(f"no writable build directory: neither {preferred} nor "
                       f"{user_cache_dir()} can be created and written")


def _target(name: str, nvcc: str, directory: Path) -> tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):   # shared device code
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(os.path.realpath(nvcc).encode())
    return src, directory / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Sequence[str]) -> dict[str, Built]:
    """Compile the named kernels, one ``nvcc`` process per source, all
    started together; returns each library with its compiler log. Sources
    already built with the same hash are not rebuilt. Raises with the
    compiler's output if any build fails."""
    nvcc = find_nvcc()
    directory = build_dir(BUILD_DIR)
    procs = {}
    for name in names:
        if name in _built:
            continue
        src, lib = _target(name, nvcc, directory)
        log = lib.with_suffix(".log")
        if lib.exists() and log.exists():
            _built[name] = Built(name, lib, log.read_text())
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, lib, log)
    failed = []
    for name, (proc, tmp, lib, log) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{out}")
            continue
        log.write_text(out)
        os.replace(tmp, lib)
        _built[name] = Built(name, lib, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return {n: _built[n] for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building it first if needed."""
    if name not in _loaded:
        _loaded[name] = ctypes.CDLL(str(build([name])[name].path))
    return _loaded[name]
