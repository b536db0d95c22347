"""A reader of flax's msgpack checkpoint format (``flax.serialization.
msgpack_serialize``), the ``.ckpt`` files every JAX driver writes
(``geossl_tpu/train/checkpoints.py``), without ``msgpack`` or ``flax``.

What it reads:

* msgpack's nil, bool, ints, floats, str, bin, array and map;
* ext type 1, an ndarray packed as ``(shape, dtype name, C-order bytes)``;
* ext type 3, a numpy scalar in the same packing (the fine-tunes'
  ``y_mean``/``y_std``);
* the ``__msgpack_chunked_array__`` maps that flax writes for arrays above
  its chunk size, joined back into one array.

``bfloat16`` arrays and any other ext type raise ``ValueError`` naming
them. :func:`loads` returns the tree with numpy arrays (read-only views of
the file's bytes, as flax's own reader gives them) and numpy scalars at its
leaves; arrays come back as lists.
"""

from __future__ import annotations

import struct

import numpy as np

_NDARRAY, _NPSCALAR = 1, 3
_CHUNKED = "__msgpack_chunked_array__"


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self.take(size))[0]

    def obj(self, raw: bool = False):
        """The next object; ``raw`` leaves str as bytes (flax packs an
        ndarray's dtype name so)."""
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F, raw)
        fixed = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in fixed:
            return fixed[b]
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q", 0xD0: ">b",
                0xD1: ">h", 0xD2: ">i", 0xD3: ">q", 0xCA: ">f", 0xCB: ">d"}
        if b in ints:
            return self.unpack(ints[b])
        lengths = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}  # bin
        if b in lengths:
            return bytes(self.take(self.unpack(lengths[b])))
        strs = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if b in strs:
            return self.str(self.unpack(strs[b]), raw)
        if b in (0xDC, 0xDD):
            return self.array(self.unpack(">H" if b == 0xDC else ">I"))
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"))
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        extlen = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if b in extlen:
            return self.ext(self.unpack(extlen[b]))
        raise ValueError(f"msgpack byte 0x{b:02x} is not a type this reader "
                         "knows")

    def str(self, n: int, raw: bool):
        data = bytes(self.take(n))
        return data if raw else data.decode("utf-8")

    def array(self, n: int) -> list:
        return [self.obj() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.obj()
            out[key] = self.obj()
        return out

    def ext(self, n: int):
        code = self.unpack(">b")
        data = self.take(n)
        if code == _NDARRAY:
            return _ndarray(data)
        if code == _NPSCALAR:
            return _ndarray(data)[()]
        raise ValueError(f"msgpack ext type {code} is not supported (the "
                         "reader takes flax's ndarray, 1, and numpy scalar, "
                         "3)")


def _ndarray(data: memoryview) -> np.ndarray:
    """flax's packing of an ndarray: a msgpack array (shape, dtype name,
    C-order bytes)."""
    inner = _Reader(bytes(data))
    shape, name, buf = inner.obj(raw=True)
    name = name.decode() if isinstance(name, bytes) else name
    if name == "bfloat16":
        raise ValueError("bfloat16 arrays are not supported (numpy has no "
                         "bfloat16; save the checkpoint in float32)")
    try:
        dtype = np.dtype(name)
    except TypeError as e:
        raise ValueError(f"array dtype {name!r} is not supported") from e
    return np.frombuffer(buf, dtype=dtype).reshape(shape, order="C")


def _unchunk(tree):
    """Join flax's chunked arrays back together, anywhere in the tree."""
    if not isinstance(tree, dict):
        return tree
    if tree.get(_CHUNKED):
        shape = [tree["shape"][str(i)] for i in range(len(tree["shape"]))]
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def loads(data: bytes):
    """The tree that ``flax.serialization.msgpack_serialize`` wrote."""
    reader = _Reader(data)
    tree = reader.obj()
    if reader.pos != len(reader.data):
        raise ValueError(f"{len(reader.data) - reader.pos} bytes after the "
                         "msgpack object")
    return _unchunk(tree)


def load(path: str):
    """:func:`loads` of the file ``path``."""
    with open(path, "rb") as f:
        return loads(f.read())
