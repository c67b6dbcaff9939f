"""msgpack trees of arrays, written byte for byte as flax writes them.

The port's counterpart of ``flax.serialization.msgpack_serialize`` /
``msgpack_restore``, in Python and numpy, so that either package reads the
checkpoints the other writes. The format:

* dict keys sorted at every level (flax copies the tree with
  ``jax.tree_util.tree_map``, which sorts them);
* Python ints in their smallest encoding, floats as float64, str and bytes
  as msgpack str and bin; lists (and tuples, which flax refuses) as arrays,
  read back as lists;
* an array as ext type 1 holding ``packb((shape, dtype name, C-order
  bytes))``, a numpy scalar as ext type 3 holding the same for its 0-d
  array. A ``bfloat16`` array comes and goes as a CPU ``torch.Tensor``
  (numpy has no bf16);
* an array of more than ``MAX_CHUNK_SIZE`` bytes reached through dicts only
  is written as flax's ``{"__msgpack_chunked_array__": True, "shape":
  {"0": ...}, "chunks": {"0": ...}}``, flat chunks of at most that many
  bytes, and read back whole.

``msgpack_pieces`` returns the encoding as a list of byte pieces in which
each array's data is a view of the array, not a copy, so a multi-GB tree
can be streamed to a file. ``msgpack_restore`` reads arrays as views of
the buffer it is given (writable if the buffer is a ``bytearray``).
"""

from __future__ import annotations

import struct

import numpy as np
import torch

MAX_CHUNK_SIZE = 2**30  # flax's: msgpack's limit is 2**31 - 1 bytes a leaf

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3
_CHUNKED = "__msgpack_chunked_array__"
_INLINE = 1 << 16  # byte pieces at least this long are not copied into the header buffer
_BIN = {0xC4: "B", 0xC5: ">H", 0xC6: ">I"}


def _int(value: int) -> bytes:
    if 0 <= value < 0x80:
        return struct.pack("B", value)
    if -0x20 <= value < 0:
        return struct.pack("b", value)
    if 0x80 <= value <= 0xFF:
        return struct.pack("BB", 0xCC, value)
    if -0x80 <= value < 0:
        return struct.pack(">Bb", 0xD0, value)
    if 0xFF < value <= 0xFFFF:
        return struct.pack(">BH", 0xCD, value)
    if -0x8000 <= value < -0x80:
        return struct.pack(">Bh", 0xD1, value)
    if 0xFFFF < value <= 0xFFFFFFFF:
        return struct.pack(">BI", 0xCE, value)
    if -0x80000000 <= value < -0x8000:
        return struct.pack(">Bi", 0xD2, value)
    if 0xFFFFFFFF < value <= 0xFFFFFFFFFFFFFFFF:
        return struct.pack(">BQ", 0xCF, value)
    if -0x8000000000000000 <= value < -0x80000000:
        return struct.pack(">Bq", 0xD3, value)
    raise OverflowError(f"integer {value} does not fit in 64 bits")


def _container_header(n: int, fix: int, code16: int) -> bytes:
    if n <= 0x0F:
        return struct.pack("B", fix | n)
    if n <= 0xFFFF:
        return struct.pack(">BH", code16, n)
    return struct.pack(">BI", code16 + 1, n)


def _bin_header(n: int) -> bytes:
    if n <= 0xFF:
        return struct.pack("BB", 0xC4, n)
    if n <= 0xFFFF:
        return struct.pack(">BH", 0xC5, n)
    if n < 2**32:
        return struct.pack(">BI", 0xC6, n)
    raise ValueError(f"{n} bytes is too large for one msgpack bin")


def _str(value: str) -> bytes:
    data = value.encode("utf-8")
    n = len(data)
    if n <= 0x1F:
        head = struct.pack("B", 0xA0 | n)
    elif n <= 0xFF:
        head = struct.pack("BB", 0xD9, n)
    elif n <= 0xFFFF:
        head = struct.pack(">BH", 0xDA, n)
    else:
        head = struct.pack(">BI", 0xDB, n)
    return head + data


def _ext_header(n: int, code: int) -> bytes:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        head = struct.pack("B", fixed[n])
    elif n <= 0xFF:
        head = struct.pack("BB", 0xC7, n)
    elif n <= 0xFFFF:
        head = struct.pack(">BH", 0xC8, n)
    else:
        head = struct.pack(">BI", 0xC9, n)
    return head + struct.pack("b", code)


def _array_parts(value) -> tuple[tuple[int, ...], str, int, np.ndarray] | None:
    """(shape, dtype name, itemsize, flat uint8 view of the C-order bytes)
    of an array leaf, or None for anything else."""
    if isinstance(value, torch.Tensor):
        if value.device.type != "cpu":
            raise ValueError(f"copy tensors to the host before serializing (got one on {value.device})")
        shape = tuple(value.shape)
        if value.dtype == torch.bfloat16:
            raw = value.detach().contiguous().view(torch.int16).numpy()
            return shape, "bfloat16", 2, raw.reshape(-1).view(np.uint8)
        value = value.detach().numpy()
    if not isinstance(value, np.ndarray):
        return None
    if value.dtype.hasobject or value.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be serialized")
    flat = np.ascontiguousarray(value).reshape(-1)
    return value.shape, value.dtype.name, value.dtype.itemsize, flat.view(np.uint8)


class _Encoder:
    def __init__(self):
        self.pieces: list = []
        self.buf = bytearray()

    def put(self, data) -> None:
        if len(data) >= _INLINE:
            if self.buf:
                self.pieces.append(bytes(self.buf))
                self.buf = bytearray()
            self.pieces.append(data)
        else:
            self.buf += data

    def finish(self) -> list:
        if self.buf:
            self.pieces.append(bytes(self.buf))
        return self.pieces

    def array(self, shape, name: str, data: np.ndarray, code: int = _EXT_NDARRAY) -> None:
        prefix = b"\x93" + _container_header(len(shape), 0x90, 0xDC)
        prefix += b"".join(_int(int(d)) for d in shape) + _str(name) + _bin_header(data.nbytes)
        self.put(_ext_header(len(prefix) + data.nbytes, code) + prefix)
        self.put(memoryview(data))

    def chunked(self, shape, name: str, itemsize: int, data: np.ndarray) -> None:
        step = max(1, int(MAX_CHUNK_SIZE / itemsize)) * itemsize
        self.put(b"\x83" + _str(_CHUNKED) + b"\xc3" + _str("shape"))
        self.put(_container_header(len(shape), 0x80, 0xDE))
        for i, d in enumerate(shape):
            self.put(_str(str(i)) + _int(int(d)))
        starts = range(0, data.nbytes, step)
        self.put(_str("chunks") + _container_header(len(starts), 0x80, 0xDE))
        for i, start in enumerate(starts):
            part = data[start : start + step]
            self.put(_str(str(i)))
            self.array((part.nbytes // itemsize,), name, part)

    def value(self, value, in_dict: bool) -> None:
        kind = type(value)
        if value is None:
            self.put(b"\xc0")
        elif kind is bool:
            self.put(b"\xc3" if value else b"\xc2")
        elif kind is int:
            self.put(_int(value))
        elif kind is float:
            self.put(struct.pack(">Bd", 0xCB, value))
        elif kind is str:
            self.put(_str(value))
        elif kind in (bytes, bytearray):
            self.put(_bin_header(len(value)))
            self.put(bytes(value))
        elif kind in (list, tuple):
            self.put(_container_header(len(value), 0x90, 0xDC))
            for item in value:
                self.value(item, in_dict=False)
        elif kind is dict:
            self.put(_container_header(len(value), 0x80, 0xDE))
            for key in sorted(value):
                self.value(key, in_dict=False)
                self.value(value[key], in_dict=True)
        elif isinstance(value, np.generic):
            shape, name, _, data = _array_parts(np.asarray(value))
            self.array(shape, name, data, code=_EXT_NPSCALAR)
        else:
            parts = _array_parts(value)
            if parts is None:
                raise TypeError(f"cannot serialize {kind.__name__!r} object")
            shape, name, itemsize, data = parts
            if in_dict and data.nbytes > MAX_CHUNK_SIZE:
                self.chunked(shape, name, itemsize, data)
            else:
                self.array(shape, name, data)


def msgpack_pieces(tree) -> list:
    """The encoding of ``tree`` as byte pieces; ``b"".join`` gives the bytes
    ``flax.serialization.msgpack_serialize`` writes for it."""
    encoder = _Encoder()
    encoder.value(tree, in_dict=True)
    return encoder.finish()


def msgpack_serialize(tree) -> bytes:
    return b"".join(msgpack_pieces(tree))


def _frombuffer(shape: list, name: str, data: memoryview):
    if name == "bfloat16":
        if data.nbytes == 0:
            return torch.empty(shape, dtype=torch.bfloat16)
        # torch wants a writable buffer: copy out of a read-only one.
        return torch.frombuffer(bytearray(data) if data.readonly else data, dtype=torch.bfloat16).reshape(shape)
    return np.frombuffer(data, dtype=np.dtype(name)).reshape(shape)


class _Decoder:
    def __init__(self, view: memoryview):
        self.view = view
        self.pos = 0

    def take(self, n: int) -> memoryview:
        start = self.pos
        self.pos += n
        if self.pos > len(self.view):
            raise ValueError("truncated msgpack data")
        return self.view[start : self.pos]

    def unpack(self, fmt: str):
        (value,) = struct.unpack_from(fmt, self.view, self.pos)
        self.pos += struct.calcsize(fmt)
        return value

    def ext(self, code: int, n: int):
        inner = _Decoder(self.take(n))
        if inner.unpack("B") != 0x93:
            raise ValueError("malformed array in msgpack ext")
        shape, name = inner.value(), inner.value()
        b = inner.unpack("B")
        if b not in _BIN:
            raise ValueError("malformed array in msgpack ext")
        # The array is a view of the buffer, not a copy.
        array = _frombuffer(shape, name, inner.take(inner.unpack(_BIN[b])))
        if code == _EXT_NDARRAY:
            return array
        if code == _EXT_NPSCALAR:
            return array if isinstance(array, torch.Tensor) else array[()]
        raise ValueError(f"unsupported msgpack ext type {code}")

    def value(self):
        b = self.unpack("B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        if b in _BIN:
            return bytes(self.take(self.unpack(_BIN[b])))
        if b in (0xC7, 0xC8, 0xC9):
            n = self.unpack({0xC7: "B", 0xC8: ">H", 0xC9: ">I"}[b])
            return self.ext(self.unpack("b"), n)
        if b in (0xD4, 0xD5, 0xD6, 0xD7, 0xD8):
            n = 1 << (b - 0xD4)
            return self.ext(self.unpack("b"), n)
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: "B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                   0xD0: "b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        if b in (0xD9, 0xDA, 0xDB):
            return str(self.take(self.unpack({0xD9: "B", 0xDA: ">H", 0xDB: ">I"}[b])), "utf-8")
        if b in (0xDC, 0xDD):
            return [self.value() for _ in range(self.unpack(">H" if b == 0xDC else ">I"))]
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out


def _unchunk(data: dict):
    shape = [data["shape"][str(i)] for i in range(len(data["shape"]))]
    chunks = [data["chunks"][str(i)] for i in range(len(data["chunks"]))]
    if isinstance(chunks[0], torch.Tensor):
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def _unchunk_in_place(tree):
    """flax's walk: chunked arrays are found through dicts only."""
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            return _unchunk(tree)
        for key, value in tree.items():
            if isinstance(value, dict):
                tree[key] = _unchunk_in_place(value)
    return tree


def msgpack_restore(data):
    """The tree encoded in ``data`` (bytes, bytearray or memoryview): dicts,
    lists, Python scalars, numpy arrays and scalars, bf16 tensors."""
    decoder = _Decoder(memoryview(data).cast("B"))
    tree = decoder.value()
    if decoder.pos != len(decoder.view):
        raise ValueError(f"{len(decoder.view) - decoder.pos} bytes after the msgpack object")
    return _unchunk_in_place(tree)
