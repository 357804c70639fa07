"""ctypes bindings to the native JPEG decoder.

The port's counterpart of ``multimodal_active_ai_tpu/data/native.py``: the
same C ABI (``runtime/loader.cc``: libjpeg decode with DCT-domain
prescaling, a bilinear resample to the canvas, a thread pool for batches),
so both packages decode a JPEG to the same pixels. The library is built at
first use with ``make -C runtime OUT=...`` (``g++ ... -ljpeg``) into the
port's git-ignored build directory, ``csrc/build/`` or the user's cache
where that cannot be written (``ops/cuda_build.build_dir``), under a name
that carries a hash of the source and the Makefile. Where it does not build
(no ``g++``, ``make`` or libjpeg), :func:`available` is false and
:class:`~multimodal_active_ai_tpu_torch.data.loader.HostLoader` decodes
with PIL. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

from multimodal_active_ai_tpu_torch.ops import cuda_build

RUNTIME = Path(__file__).resolve().parents[1] / "runtime"
_lib = None
_tried = False


def library_path(directory: Path) -> Path:
    """Where the library built from this checkout's sources lives."""
    h = hashlib.sha256((RUNTIME / "loader.cc").read_bytes())
    h.update((RUNTIME / "Makefile").read_bytes())
    return directory / f"libmaai_runtime-{h.hexdigest()[:16]}.so"


def _build() -> Path | None:
    try:
        lib = library_path(cuda_build.build_dir(cuda_build.BUILD_DIR))
    except RuntimeError:        # no writable build directory
        return None
    if lib.exists():
        return lib
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(["make", "-C", str(RUNTIME), f"OUT={tmp}"], check=True,
                       capture_output=True, timeout=300)
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, lib)
    return lib


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    path = _build()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        return None
    lib.maai_decode_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int), ctypes.c_int]
    lib.maai_decode_batch.restype = None
    _lib = lib
    return _lib


def available() -> bool:
    """Whether the native decoder builds and loads on this machine."""
    return _load() is not None


def decode_batch(paths: list[str], canvas: int, out: np.ndarray,
                 num_threads: int = 0) -> np.ndarray:
    """Decode ``paths`` with ``num_threads`` threads (all cores up to 16
    when 0) into the C-contiguous ``(N, canvas, canvas, 3)`` uint8 ``out``;
    returns a bool array marking the files decoded."""
    lib = _load()
    n = len(paths)
    if out.shape != (n, canvas, canvas, 3) or out.dtype != np.uint8 \
            or not out.flags.c_contiguous:
        raise ValueError(f"out must be a C-contiguous uint8 array of shape "
                         f"{(n, canvas, canvas, 3)}, not {out.dtype} {out.shape}")
    if lib is None:
        return np.zeros((n,), bool)
    if num_threads <= 0:
        num_threads = min(max(os.cpu_count() or 1, 1), 16)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    ok = np.zeros((n,), np.int32)
    lib.maai_decode_batch(arr, n, canvas, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                          ok.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), num_threads)
    return ok.astype(bool)
