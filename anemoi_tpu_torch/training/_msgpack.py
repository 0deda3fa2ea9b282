"""A small msgpack reader for the JAX package's ``params.msgpack``.

Decodes what ``flax.serialization.msgpack_serialize`` writes: maps, arrays,
str and bin, nil and booleans, ints and floats, and flax's ext types --
code 1, an ndarray packed as the msgpack triple ``(shape, dtype name,
C-order bytes)``; code 3, a numpy scalar in the same form -- and flax's
chunked arrays (``__msgpack_chunked_array__``), which it writes for leaves
above 1 GiB.  bfloat16 leaves come back as float32.  Nothing is written.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np
import torch

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3


class _Reader:
    def __init__(self, data: bytes) -> None:
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack: truncated input")
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str) -> Any:
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self.take(size))[0]

    def obj(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return bytes(self.take(b & 0x1F)).decode()
        if b == 0xC0:
            return None
        if b == 0xC2:
            return False
        if b == 0xC3:
            return True
        if b in (0xC4, 0xC5, 0xC6):
            return bytes(self.take(self.unpack({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[b])))
        if b in (0xC7, 0xC8, 0xC9):
            n = self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
            return self.ext(n)
        if b == 0xCA:
            return self.unpack(">f")
        if b == 0xCB:
            return self.unpack(">d")
        if 0xCC <= b <= 0xD3:
            return self.unpack({0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}[b])
        if 0xD4 <= b <= 0xD8:
            return self.ext(1 << (b - 0xD4))
        if b in (0xD9, 0xDA, 0xDB):
            n = self.unpack({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[b])
            return bytes(self.take(n)).decode()
        if b in (0xDC, 0xDD):
            return self.array(self.unpack(">H" if b == 0xDC else ">I"))
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"msgpack: unknown type byte 0x{b:02x}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.obj()
            out[key] = self.obj()
        return out

    def array(self, n: int) -> list:
        return [self.obj() for _ in range(n)]

    def ext(self, n: int) -> Any:
        code = self.unpack(">b")
        payload = bytes(self.take(n))
        if code in (_EXT_NDARRAY, _EXT_NPSCALAR):
            arr = _ndarray(payload)
            return arr if code == _EXT_NDARRAY else arr[()]
        if code == _EXT_COMPLEX:
            real, imag = unpackb(payload)
            return complex(real, imag)
        raise ValueError(f"msgpack: unknown ext type {code}")


def _ndarray(payload: bytes) -> np.ndarray:
    shape, dtype_name, buffer = unpackb(payload)
    if isinstance(dtype_name, bytes):
        dtype_name = dtype_name.decode()
    shape: Tuple[int, ...] = tuple(shape)
    if dtype_name == "bfloat16":
        bits = torch.frombuffer(bytearray(buffer), dtype=torch.int16)
        return bits.view(torch.bfloat16).float().numpy().reshape(shape)
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name)).reshape(shape)


def unpackb(data: bytes) -> Any:
    """Decode one msgpack object."""
    reader = _Reader(data)
    out = reader.obj()
    if reader.pos != len(reader.data):
        raise ValueError("msgpack: trailing bytes")
    return out


def _unchunk(tree: Any) -> Any:
    if isinstance(tree, dict):
        if "__msgpack_chunked_array__" in tree:
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def msgpack_restore(data: bytes) -> Any:
    """The tree of ``flax.serialization.msgpack_serialize``: nested dicts of
    numpy arrays and Python scalars."""
    return _unchunk(unpackb(data))
