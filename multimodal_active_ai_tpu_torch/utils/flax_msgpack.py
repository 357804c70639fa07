"""A reader of the msgpack bytes that flax checkpoints are made of.

The JAX package writes its checkpoints with
``flax.serialization.msgpack_serialize``; this module reads them back in
pure Python and numpy, without the ``msgpack`` or ``flax`` packages, and
returns the tree that ``flax.serialization.msgpack_restore`` returns:

* msgpack maps as dicts, arrays as lists, str as str, bin as bytes, nil,
  bools, integers (to 64 bits, either sign) and floats (32 and 64 bits);
* flax's ext types: 1, an ndarray, whose payload is itself msgpack of
  ``(shape, dtype name, C-order bytes)``; 2, a complex number packed as
  ``(real, imag)``; 3, a numpy scalar packed as a 0-d ndarray. Other ext
  codes come back as :class:`ExtType`;
* ``'bfloat16'`` arrays, which numpy cannot name, as ``torch.bfloat16``
  tensors (the bytes read as uint16 and viewed as bfloat16); every other
  array is a read-only numpy array over the file's bytes, as flax's are;
* arrays over flax's chunk limit, which flax splits into a
  ``'__msgpack_chunked_array__'`` dict of flat chunks, joined again.
"""

from __future__ import annotations

import struct
from typing import Any, NamedTuple

import numpy as np
import torch

_CHUNKED = "__msgpack_chunked_array__"
_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3


class ExtType(NamedTuple):
    """An ext value of a code flax does not write."""

    code: int
    data: bytes


# lead byte → (struct format of the length or value, what follows)
_FIXED = {
    0xc4: (">B", "bin"), 0xc5: (">H", "bin"), 0xc6: (">I", "bin"),
    0xc7: (">B", "ext"), 0xc8: (">H", "ext"), 0xc9: (">I", "ext"),
    0xca: (">f", "value"), 0xcb: (">d", "value"),
    0xcc: (">B", "value"), 0xcd: (">H", "value"), 0xce: (">I", "value"), 0xcf: (">Q", "value"),
    0xd0: (">b", "value"), 0xd1: (">h", "value"), 0xd2: (">i", "value"), 0xd3: (">q", "value"),
    0xd9: (">B", "str"), 0xda: (">H", "str"), 0xdb: (">I", "str"),
    0xdc: (">H", "array"), 0xdd: (">I", "array"),
    0xde: (">H", "map"), 0xdf: (">I", "map"),
}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}
_CONSTANTS = {0xc0: None, 0xc2: False, 0xc3: True}


class _Reader:
    """One msgpack value at a time from ``buf``; with ``raw`` str values
    stay bytes (how flax reads an ndarray payload)."""

    def __init__(self, buf, raw: bool = False):
        self.buf = memoryview(buf)
        self.pos = 0
        self.raw = raw

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos:end]
        self.pos = end
        return out

    def number(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self) -> Any:
        lead = self.take(1)[0]
        if lead <= 0x7f:
            return lead
        if lead >= 0xe0:
            return lead - 0x100
        if lead <= 0x8f:
            return self.map(lead & 0x0f)
        if lead <= 0x9f:
            return [self.read() for _ in range(lead & 0x0f)]
        if lead <= 0xbf:
            return self.str(lead & 0x1f)
        if lead in _CONSTANTS:
            return _CONSTANTS[lead]
        if lead in _FIXEXT:
            code = self.number(">b")
            return _ext(code, self.take(_FIXEXT[lead]))
        if lead not in _FIXED:
            raise ValueError(f"unknown msgpack lead byte 0x{lead:02x}")
        fmt, kind = _FIXED[lead]
        n = self.number(fmt)
        if kind == "value":
            return n
        if kind == "bin":
            return bytes(self.take(n))
        if kind == "str":
            return self.str(n)
        if kind == "array":
            return [self.read() for _ in range(n)]
        if kind == "map":
            return self.map(n)
        code = self.number(">b")
        return _ext(code, self.take(n))

    def str(self, n: int):
        data = bytes(self.take(n))
        return data if self.raw else data.decode("utf-8")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out


def _unpack_all(buf, raw: bool = False) -> Any:
    reader = _Reader(buf, raw)
    value = reader.read()
    if reader.pos != len(reader.buf):
        raise ValueError(f"{len(reader.buf) - reader.pos} bytes after the msgpack value")
    return value


def _ndarray(payload: memoryview):
    shape, dtype_name, data = _unpack_all(payload, raw=True)
    name = dtype_name.decode("utf-8")
    if name == "bfloat16":
        bits = np.frombuffer(data, dtype=np.uint16).reshape(shape)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return np.frombuffer(data, dtype=np.dtype(name)).reshape(shape, order="C")


def _ext(code: int, payload: memoryview):
    if code == _EXT_NDARRAY:
        return _ndarray(payload)
    if code == _EXT_COMPLEX:
        real, imag = _unpack_all(payload)
        return complex(real, imag)
    if code == _EXT_NPSCALAR:
        arr = _ndarray(payload)
        return arr.reshape(()) if isinstance(arr, torch.Tensor) else arr[()]
    return ExtType(code, bytes(payload))


def _unchunk(d: dict):
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    flat = torch.cat(chunks) if isinstance(chunks[0], torch.Tensor) else np.concatenate(chunks)
    return flat.reshape(shape)


def _unchunk_in_place(d):
    """flax's ``_unchunk_array_leaves_in_place``: chunked dicts at the top
    or anywhere under dicts become arrays again."""
    if isinstance(d, dict):
        if _CHUNKED in d:
            return _unchunk(d)
        for k, v in d.items():
            if isinstance(v, dict):
                d[k] = _unchunk(v) if _CHUNKED in v else _unchunk_in_place(v)
    return d


def msgpack_restore(data: bytes) -> Any:
    """The tree ``flax.serialization.msgpack_restore(data)`` returns."""
    return _unchunk_in_place(_unpack_all(data))


def read_file(path: str) -> Any:
    """:func:`msgpack_restore` of a file's bytes."""
    with open(path, "rb") as f:
        return msgpack_restore(f.read())
