"""A reader for the msgpack subset that flax's ``msgpack_serialize`` writes.

The JAX package's checkpoints (``RMDT1``/``RMDT2`` files) hold a flax
msgpack payload. This decoder reads it without the ``msgpack`` or
``flax`` packages: maps, arrays, strings, integers, floats, nil, booleans,
bin, and flax's extension types (1: ndarray, 2: complex, 3: numpy scalar),
each ndarray a msgpack ``(shape, dtype name, C-order bytes)`` triple.
Arrays of ``bfloat16`` (which numpy has no type for) are widened to
``float32``, exactly. Flax's chunked form of arrays over 1 GiB
(``__msgpack_chunked_array__``) is joined back into one array.

Everything is big-endian, as the msgpack specification says; arrays
decode to lists, maps to dicts.
"""

import struct

import numpy as np

_EXT_NDARRAY = 1
_EXT_COMPLEX = 2
_EXT_NPSCALAR = 3


class MsgpackError(ValueError):
    """The bytes are not a payload this reader can decode."""


class _Reader:
    def __init__(self, data):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n):
        end = self.pos + n
        if end > len(self.data):
            raise MsgpackError("truncated msgpack payload")
        chunk = self.data[self.pos:end]
        self.pos = end
        return chunk

    def unpack(self, fmt):
        (value,) = struct.unpack(fmt, self.take(struct.calcsize(fmt)))
        return value

    def obj(self):
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
            return self.str(b & 0x1F)

        if b == 0xC0:
            return None
        if b == 0xC2:
            return False
        if b == 0xC3:
            return True
        if b in (0xC4, 0xC5, 0xC6):
            return bytes(self.take(self.unpack(_LEN[b])))
        if b in (0xC7, 0xC8, 0xC9):
            n = self.unpack(_LEN[b])
            return self.ext(self.unpack(">b"), n)
        if b in _FIXEXT:
            return self.ext(self.unpack(">b"), _FIXEXT[b])
        if b in _SCALAR:
            return self.unpack(_SCALAR[b])
        if b in (0xD9, 0xDA, 0xDB):
            return self.str(self.unpack(_LEN[b]))
        if b in (0xDC, 0xDD):
            return self.array(self.unpack(_LEN[b]))
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(_LEN[b]))
        raise MsgpackError(f"unsupported msgpack type byte 0x{b:02x}")

    def str(self, n):
        return bytes(self.take(n)).decode("utf-8")

    def array(self, n):
        return [self.obj() for _ in range(n)]

    def map(self, n):
        out = {}
        for _ in range(n):
            key = self.obj()
            out[key] = self.obj()
        return out

    def ext(self, code, n):
        payload = self.take(n)
        if code == _EXT_NDARRAY:
            return _ndarray(payload)
        if code == _EXT_NPSCALAR:
            return _ndarray(payload)[()]
        if code == _EXT_COMPLEX:
            real, imag = unpackb(payload)
            return complex(real, imag)
        raise MsgpackError(f"unsupported msgpack extension type {code}")


_LEN = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xC7: ">B", 0xC8: ">H",
        0xC9: ">I", 0xD9: ">B", 0xDA: ">H", 0xDB: ">I", 0xDC: ">H",
        0xDD: ">I", 0xDE: ">H", 0xDF: ">I"}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
_SCALAR = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
           0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}


def _ndarray(payload):
    """flax's ndarray extension: (shape, dtype name, C-order bytes)."""
    shape, dtype, buffer = unpackb(payload)
    if isinstance(buffer, str):
        buffer = buffer.encode("latin-1")
    if dtype == "bfloat16":
        # the upper half of a float32: widen exactly
        raw = np.frombuffer(buffer, np.uint16).astype(np.uint32) << 16
        return raw.view(np.float32).reshape(shape)
    return np.frombuffer(buffer, np.dtype(dtype)).reshape(shape)


def unpackb(data):
    """Decode one msgpack object from ``data`` (bytes); the whole input
    must be consumed."""
    reader = _Reader(data)
    out = reader.obj()
    if reader.pos != len(reader.data):
        raise MsgpackError(f"{len(reader.data) - reader.pos} trailing bytes "
                           "after the msgpack object")
    return out


def _unchunk(tree):
    if isinstance(tree, dict):
        if "__msgpack_chunked_array__" in tree:
            shape = [tree["shape"][str(i)] for i in range(len(tree["shape"]))]
            chunks = [tree["chunks"][str(i)]
                      for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def restore(data):
    """flax ``msgpack_restore``: the decoded tree with chunked arrays
    joined."""
    return _unchunk(unpackb(data))
