"""A msgpack reader for flax parameter files, in the standard library and
numpy.

The JAX package saves parameters with ``flax.serialization.to_bytes``:
msgpack maps of maps whose leaves are numpy arrays, each one msgpack ext
type 1 holding the msgpack triple ``(shape, dtype name, raw bytes)``
(flax's ``_ndarray_to_bytes``). :func:`unpackb` decodes such a file into
the same nested dicts of numpy arrays that
``flax.serialization.msgpack_restore`` gives, without ``msgpack`` or
``flax``.

msgpack's own integers and floats are big-endian; an array's bytes are its
native (little-endian) C-order buffer. Anything this reader does not know,
an ext code other than 1 (flax uses 2 for complex numbers and 3 for numpy
scalars), a dtype numpy lacks, or flax's ``__msgpack_chunked_array__``
nodes (arrays over 2**30 bytes), raises :class:`MsgpackError`: no partial
tree is returned.
"""

from __future__ import annotations

import struct
from typing import Any, Callable, Dict, Tuple

import numpy as np

NDARRAY_EXT = 1  # flax's _MsgpackExtType.ndarray
CHUNKED_KEY = "__msgpack_chunked_array__"


class MsgpackError(ValueError):
    """The bytes are not a msgpack document this reader can decode."""


class _Reader:
    def __init__(self, data: bytes, ext_hook: Callable[[int, bytes], Any]):
        self.buf = memoryview(data)
        self.pos = 0
        self.ext_hook = ext_hook

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise MsgpackError(f"truncated msgpack data: need {n} bytes at offset {self.pos}")
        out = self.buf[self.pos : end]
        self.pos = end
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self) -> Any:
        b = self.unpack(">B")
        if b <= 0x7F:  # positive fixint
            return b
        if b >= 0xE0:  # negative fixint
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.text(b & 0x1F)
        if b in _FIXED:
            return _FIXED[b]
        if b in _SCALARS:
            return self.unpack(_SCALARS[b])
        if b in _SIZED:
            kind, fmt = _SIZED[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "str":
                return self.text(n)
            if kind == "array":
                return self.array(n)
            return self.map(n)
        if b in _FIXEXT:
            return self.ext(_FIXEXT[b])
        if b in _EXT:
            return self.ext(self.unpack(_EXT[b]))
        raise MsgpackError(f"unknown msgpack type byte 0x{b:02x} at offset {self.pos - 1}")

    def text(self, n: int) -> str:
        return str(self.take(n), "utf-8")

    def array(self, n: int) -> list:
        return [self.obj() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.obj()
            out[key] = self.obj()
        if CHUNKED_KEY in out:
            raise MsgpackError(
                f"'{CHUNKED_KEY}' node: flax splits arrays over 2**30 bytes into chunks, "
                "which this reader does not join"
            )
        return out

    def ext(self, n: int):
        code = self.unpack(">b")
        return self.ext_hook(code, bytes(self.take(n)))


_FIXED = {0xC0: None, 0xC2: False, 0xC3: True}
_SCALARS = {
    0xCA: ">f", 0xCB: ">d",
    0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
    0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
}
_SIZED: Dict[int, Tuple[str, str]] = {
    0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
    0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
    0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
    0xDE: ("map", ">H"), 0xDF: ("map", ">I"),
}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
_EXT = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}


def _reject_ext(code: int, data: bytes):
    raise MsgpackError(f"unexpected msgpack ext type {code} inside an array payload")


def _ndarray(data: bytes) -> np.ndarray:
    """flax's ext payload (shape, dtype name, bytes) → a writable array."""
    triple = unpackb(data, ext_hook=_reject_ext)
    if not (isinstance(triple, list) and len(triple) == 3):
        raise MsgpackError("ndarray ext payload is not a (shape, dtype, bytes) triple")
    shape, name, buf = triple
    if isinstance(name, bytes):
        name = name.decode()
    try:
        dtype = np.dtype(name).newbyteorder("<")
    except TypeError as e:
        raise MsgpackError(f"array dtype {name!r} is not a numpy dtype") from e
    # frombuffer is a read-only view of the file's bytes: copy it
    return np.frombuffer(buf, dtype=dtype).reshape(shape).copy()


def _flax_ext(code: int, data: bytes):
    if code == NDARRAY_EXT:
        return _ndarray(data)
    raise MsgpackError(f"msgpack ext type {code} is not a flax ndarray (type {NDARRAY_EXT})")


def unpackb(data: bytes, ext_hook: Callable[[int, bytes], Any] = _flax_ext) -> Any:
    """Decode one msgpack document. Strings come back as ``str``, bins as
    ``bytes``, arrays as lists, maps as dicts; ext values go to
    ``ext_hook(code, payload)``, by default flax's ndarray decoding. Trailing
    bytes are an error."""
    r = _Reader(data, ext_hook)
    out = r.obj()
    if r.pos != len(r.buf):
        raise MsgpackError(f"{len(r.buf) - r.pos} trailing bytes after the msgpack document")
    return out
