"""A msgpack codec for state-dict trees, in plain Python and numpy.

``acn_tpu`` writes its checkpoints with ``flax.serialization``: a tree of
dicts with str keys whose leaves are arrays, packed by msgpack with each
array as extension type 1 holding the packed ``(shape, dtype name, C-order
bytes)``. This module writes and reads the subset of msgpack that flax
emits, so that the port's files equal flax's byte for byte without flax or
msgpack:

* maps with str keys, written in the dict's own order (the caller orders
  them as JAX would serialize the tree, see ``utils/checkpoint.py``);
* nil, bool, int, float (float64), str, bin;
* ext type 1: a numpy array (or a CPU tensor), its bytes in one piece. An
  array over 2³⁰ bytes is written as flax writes it, a map of flat chunks
  under ``__msgpack_chunked_array__``.

Lists and tuples are written as msgpack arrays (flax's state dicts hold
none: lists become maps {"0": …}). Reading gives dicts, lists, Python
scalars and read-only numpy arrays that view the input buffer (no copy).
"""

from __future__ import annotations

import struct
from typing import Any, Iterator, List, Union

import numpy as np

EXT_NDARRAY = 1
# flax splits arrays above this many bytes into chunks (msgpack's limit on
# one object is 2³¹ − 1 bytes)
MAX_CHUNK_SIZE = 2 ** 30
CHUNKED = "__msgpack_chunked_array__"

Buffer = Union[bytes, bytearray, memoryview]


# ------------------------------------------------------------------ writing


def _uint_header(n: int, small: int, small_limit: int, codes) -> bytes:
    """The header of a str / bin / map / array / ext of length ``n``: the
    fix form below ``small_limit`` (``small`` | n) if there is one, then the
    8-, 16- and 32-bit length forms in ``codes``."""
    if small is not None and n < small_limit:
        return bytes([small | n])
    for code, fmt, limit in codes:
        if code is not None and n < limit:
            return struct.pack(">B" + fmt, code, n)
    raise ValueError(f"msgpack: a length of {n} does not fit in 32 bits")


def _str_header(n):
    return _uint_header(n, 0xA0, 32, ((0xD9, "B", 1 << 8), (0xDA, "H", 1 << 16),
                                      (0xDB, "I", 1 << 32)))


def _bin_header(n):
    return _uint_header(n, None, 0, ((0xC4, "B", 1 << 8), (0xC5, "H", 1 << 16),
                                     (0xC6, "I", 1 << 32)))


def _map_header(n):
    return _uint_header(n, 0x80, 16, ((None, "", 0), (0xDE, "H", 1 << 16),
                                      (0xDF, "I", 1 << 32)))


def _array_header(n):
    return _uint_header(n, 0x90, 16, ((None, "", 0), (0xDC, "H", 1 << 16),
                                      (0xDD, "I", 1 << 32)))


_FIXEXT = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}


def _ext_header(n: int, code: int) -> bytes:
    if n in _FIXEXT:
        return bytes([_FIXEXT[n], code])
    for head, fmt, limit in ((0xC7, "B", 1 << 8), (0xC8, "H", 1 << 16),
                             (0xC9, "I", 1 << 32)):
        if n < limit:
            return struct.pack(">B" + fmt + "B", head, n, code)
    raise ValueError(f"msgpack: an extension of {n} bytes does not fit in 32 bits")


def _int(v: int) -> bytes:
    """msgpack-python's choice: the smallest form, unsigned for v ≥ 0."""
    if 0 <= v < 0x80:
        return bytes([v])
    if -32 <= v < 0:
        return struct.pack(">b", v)
    if v >= 0:
        for code, fmt, limit in ((0xCC, "B", 1 << 8), (0xCD, "H", 1 << 16),
                                 (0xCE, "I", 1 << 32), (0xCF, "Q", 1 << 64)):
            if v < limit:
                return struct.pack(">B" + fmt, code, v)
    else:
        for code, fmt, limit in ((0xD0, "b", 1 << 7), (0xD1, "h", 1 << 15),
                                 (0xD2, "i", 1 << 31), (0xD3, "q", 1 << 63)):
            if v >= -limit:
                return struct.pack(">B" + fmt, code, v)
    raise OverflowError(f"msgpack: the integer {v} does not fit in 64 bits")


def _str(s: str) -> bytes:
    b = s.encode("utf-8")
    return _str_header(len(b)) + b


def _as_numpy(x) -> np.ndarray:
    """A numpy array leaf, or a CPU tensor's numpy view."""
    if isinstance(x, np.ndarray):
        return x
    import torch

    if isinstance(x, torch.Tensor):
        if x.device.type != "cpu":
            raise ValueError("msgpack_tree writes CPU arrays; move the tensor first")
        return x.detach().numpy()
    raise TypeError(f"msgpack_tree: cannot write a {type(x).__name__}")


def _ndarray_chunks(arr: np.ndarray) -> List[Buffer]:
    """Ext type 1 of one array: the header, the packed (shape, dtype name)
    prefix, the bin header and the array's bytes as one memoryview."""
    if arr.dtype.hasobject or arr.dtype.fields is not None:
        raise ValueError("object and structured dtypes cannot be written")
    data = np.ascontiguousarray(arr)
    nbytes = data.size * data.itemsize
    prefix = (_array_header(3) + _array_header(arr.ndim)
              + b"".join(_int(int(s)) for s in arr.shape)
              + _str(arr.dtype.name) + _bin_header(nbytes))
    body = memoryview(data.view(np.uint8).reshape(-1)) if nbytes else b""
    return [_ext_header(len(prefix) + nbytes, EXT_NDARRAY), prefix, body]


def _chunked(arr: np.ndarray) -> dict:
    """flax's map of flat chunks for an array over ``MAX_CHUNK_SIZE`` bytes."""
    step = max(1, int(MAX_CHUNK_SIZE / arr.dtype.itemsize))
    flat = np.ascontiguousarray(arr).reshape(-1)
    return {CHUNKED: True,
            "shape": {str(i): int(s) for i, s in enumerate(arr.shape)},
            "chunks": {str(i): flat[j:j + step]
                       for i, j in enumerate(range(0, flat.size, step))}}


def iter_packed(tree: Any) -> Iterator[Buffer]:
    """The msgpack encoding of ``tree`` as a sequence of byte pieces (an
    array's bytes are one piece, not copied)."""
    if tree is None:
        yield b"\xc0"
    elif tree is True:
        yield b"\xc3"
    elif tree is False:
        yield b"\xc2"
    elif isinstance(tree, dict):
        yield _map_header(len(tree))
        for k, v in tree.items():
            if not isinstance(k, str):
                raise TypeError(f"msgpack_tree: map keys are str, not {type(k).__name__}")
            yield _str(k)
            yield from iter_packed(v)
    elif isinstance(tree, (list, tuple)):
        yield _array_header(len(tree))
        for v in tree:
            yield from iter_packed(v)
    elif isinstance(tree, int) and not isinstance(tree, np.integer):
        yield _int(tree)
    elif isinstance(tree, float):
        yield struct.pack(">Bd", 0xCB, tree)
    elif isinstance(tree, str):
        yield _str(tree)
    elif isinstance(tree, (bytes, bytearray, memoryview)):
        yield _bin_header(len(tree))
        yield bytes(tree)
    else:
        arr = _as_numpy(tree)
        if arr.size * arr.dtype.itemsize > MAX_CHUNK_SIZE:
            yield from iter_packed(_chunked(arr))
        else:
            yield from _ndarray_chunks(arr)


def packb(tree: Any) -> bytes:
    """The msgpack encoding of ``tree`` as one bytes object."""
    return b"".join(iter_packed(tree))


# ------------------------------------------------------------------ reading


class _Reader:
    def __init__(self, buf: Buffer):
        self.buf = memoryview(buf).cast("B")
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("msgpack_tree: the input ends inside an object")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self.take(size))[0]

    def read(self) -> Any:
        b = self.take(1)[0]
        if b < 0x80:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        if b in (0xC4, 0xC5, 0xC6):
            return self.take(self.unpack({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[b]))
        if b in (0xC7, 0xC8, 0xC9):
            n = self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
            return self.ext(self.unpack(">b"), n)
        if b == 0xCA:
            return self.unpack(">f")
        if b == 0xCB:
            return self.unpack(">d")
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in ints:
            return self.unpack(ints[b])
        if b in (0xD4, 0xD5, 0xD6, 0xD7, 0xD8):
            code = self.unpack(">b")
            return self.ext(code, {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}[b])
        if b in (0xD9, 0xDA, 0xDB):
            return str(self.take(self.unpack({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[b])),
                       "utf-8")
        if b in (0xDC, 0xDD):
            return [self.read() for _ in range(self.unpack(">H" if b == 0xDC else ">I"))]
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"msgpack_tree: unsupported type byte 0x{b:02x}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out

    def ext(self, code: int, n: int):
        if code != EXT_NDARRAY:
            raise ValueError(f"msgpack_tree: unsupported extension type {code}")
        end = self.pos + n
        shape, name, data = self.read()
        if self.pos != end:
            raise ValueError("msgpack_tree: a malformed array extension")
        return np.frombuffer(data, dtype=np.dtype(name)).reshape(shape)


def _unchunk(tree: Any) -> Any:
    if isinstance(tree, dict):
        if CHUNKED in tree:
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            parts = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            return np.concatenate(parts).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def unpackb(buf: Buffer) -> Any:
    """The tree encoded in ``buf`` (chunked arrays joined again). Arrays are
    read-only views of ``buf``."""
    r = _Reader(buf)
    out = r.read()
    if r.pos != len(r.buf):
        raise ValueError(f"msgpack_tree: {len(r.buf) - r.pos} bytes after the tree")
    return _unchunk(out)
