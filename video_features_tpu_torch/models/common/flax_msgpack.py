"""The port's reader and writer of Flax ``.msgpack`` checkpoints.

``flax.serialization.msgpack_serialize`` writes a param tree as one
MessagePack document: maps with str keys, and each array leaf an
extension value whose payload is itself a packed ``(shape, dtype name,
C-order bytes)``. Flax's extension codes are 1 (an ndarray), 2 (a
complex number) and 3 (a numpy scalar, packed as a 0-d ndarray). An array
over ``MAX_CHUNK_SIZE`` bytes is split into a map ``{"__msgpack_chunked_array__":
True, "shape": {"0": d0, ...}, "chunks": {"0": flat, ...}}``, because a
MessagePack value cannot exceed 2**31 - 1 bytes.

This module reads and writes that format with ``struct`` and numpy alone:
it imports no ``msgpack``, ``flax`` or ``jax``, which a card host need not
have. Leaves come back as numpy arrays, except ``bfloat16`` ones, which
numpy has no type for: those come back as ``torch.bfloat16`` tensors.
"""

from __future__ import annotations

import os
import struct
from typing import Any, List, NamedTuple

import numpy as np
import torch

# Flax's limit (flax.serialization.MAX_CHUNK_SIZE): a leaf over this many
# bytes is written in chunks of at most this many
MAX_CHUNK_SIZE = 2**30
CHUNKED = "__msgpack_chunked_array__"
EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
# the dtypes a leaf may have; bfloat16 is read as uint16 and viewed
DTYPES = ("float32", "float16", "bfloat16", "bool", "int8", "int16", "int32", "int64",
          "uint8", "uint16", "uint32", "uint64")


class MsgpackFormatError(ValueError):
    """The bytes are not a Flax ``.msgpack`` document this reader takes."""


def _dtype(name: str, path: str) -> np.dtype:
    if name not in DTYPES:
        raise MsgpackFormatError(
            f"leaf {path or '<root>'}: dtype {name!r} is not read (takes {', '.join(DTYPES)})")
    return np.dtype(np.uint16 if name == "bfloat16" else name)


class _Reader:
    """A cursor over one MessagePack document."""

    def __init__(self, buf) -> None:
        self.buf = memoryview(buf)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise MsgpackFormatError(f"truncated at byte {self.pos}: wants {n} more")
        out = self.buf[self.pos:end]
        self.pos = end
        return out

    def num(self, fmt: str):
        (v,) = struct.unpack(fmt, self.take(struct.calcsize(fmt)))
        return v

    def value(self, path: str = "") -> Any:
        b = self.num(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if b <= 0x8F:
            return self.map(b & 0x0F, path)
        if b <= 0x9F:
            return self.array(b & 0x0F, path)
        if b <= 0xBF:
            return self.text(b & 0x1F)
        if b in _SIMPLE:
            return self.num(_SIMPLE[b])
        if b in _SIZED:
            kind, fmt = _SIZED[b]
            n = self.num(fmt)
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "str":
                return self.text(n)
            if kind == "array":
                return self.array(n, path)
            if kind == "map":
                return self.map(n, path)
            return self.ext(n, path)
        if b in _FIXEXT:
            return self.ext(_FIXEXT[b], path)
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        raise MsgpackFormatError(f"byte 0x{b:02x} at {self.pos - 1} starts no MessagePack value")

    def text(self, n: int) -> str:
        return str(self.take(n), "utf-8")

    def array(self, n: int, path: str) -> List[Any]:
        return [self.value(f"{path}/{i}") for i in range(n)]

    def map(self, n: int, path: str) -> Any:
        out = {}
        for _ in range(n):
            key = self.value(path)
            out[key] = self.value(f"{path}/{key}")
        return _unchunk(out, path) if CHUNKED in out else out

    def ext(self, n: int, path: str) -> Any:
        code = self.num(">b")
        data = self.take(n)
        if code == EXT_COMPLEX:
            raise MsgpackFormatError(f"leaf {path or '<root>'}: a complex number is not read")
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise MsgpackFormatError(f"leaf {path or '<root>'}: extension type {code} is unknown")
        triple = loads(data)
        if not (isinstance(triple, list) and len(triple) == 3):
            raise MsgpackFormatError(f"leaf {path or '<root>'}: not a (shape, dtype, bytes) array")
        shape, name, raw = triple
        if isinstance(name, bytes):
            name = name.decode("ascii")
        if not (isinstance(shape, list) and isinstance(name, str) and isinstance(raw, bytes)):
            raise MsgpackFormatError(f"leaf {path or '<root>'}: not a (shape, dtype, bytes) array")
        dtype = _dtype(name, path)
        count = int(np.prod(shape, dtype=np.int64))
        if count * dtype.itemsize != len(raw):
            raise MsgpackFormatError(f"leaf {path}: {len(raw)} bytes for shape {shape} {name}")
        arr = np.frombuffer(raw, dtype=dtype).reshape(shape).copy()
        if name == "bfloat16":
            return torch.from_numpy(arr).view(torch.bfloat16)
        return arr[()] if code == EXT_NPSCALAR else arr


_SIMPLE = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
           0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_SIZED = {0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
          0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I"),
          0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
          0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
          0xDE: ("map", ">H"), 0xDF: ("map", ">I")}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


def _unchunk(d: dict, path: str):
    """A chunked leaf's map -> the array it was cut from."""
    try:
        shape = [d["shape"][str(i)] for i in range(len(d["shape"]))]
        chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    except (KeyError, TypeError) as exc:
        raise MsgpackFormatError(f"leaf {path}: a malformed chunked array ({exc!r})") from None
    if any(isinstance(c, torch.Tensor) for c in chunks):
        return torch.cat([c.reshape(-1) for c in chunks]).reshape(shape)
    return np.concatenate([np.asarray(c).reshape(-1) for c in chunks]).reshape(shape)


def loads(buf) -> Any:
    """A Flax ``.msgpack`` document's bytes -> its tree."""
    reader = _Reader(buf)
    tree = reader.value()
    if reader.pos != len(reader.buf):
        raise MsgpackFormatError(f"{len(reader.buf) - reader.pos} bytes after the document")
    return tree


def load_msgpack(path: str) -> Any:
    """Read a ``.msgpack`` file that ``flax.serialization.msgpack_serialize``
    (or :func:`save_msgpack`) wrote."""
    with open(path, "rb") as f:
        return loads(f.read())


# --- the writer ----------------------------------------------------------------

def _head(out: list, n: int, fix: int, fix_max: int, codes) -> None:
    """The header of a sized value: a fix form below ``fix_max``, else the
    smallest of ``codes`` ((code, struct format, limit), ...)."""
    if fix is not None and n < fix_max:
        out.append(struct.pack(">B", fix | n))
        return
    for code, fmt, limit in codes:
        if n < limit:
            out.append(struct.pack(">B" + fmt[1:], code, n))
            return
    raise ValueError(f"a MessagePack value of {n} items or bytes is too large")


_STR = ((0xD9, ">B", 2**8), (0xDA, ">H", 2**16), (0xDB, ">I", 2**32))
_BIN = ((0xC4, ">B", 2**8), (0xC5, ">H", 2**16), (0xC6, ">I", 2**32))
_ARRAY = ((0xDC, ">H", 2**16), (0xDD, ">I", 2**32))
_MAP = ((0xDE, ">H", 2**16), (0xDF, ">I", 2**32))
_EXT = ((0xC7, ">B", 2**8), (0xC8, ">H", 2**16), (0xC9, ">I", 2**32))


def _int(out: list, v: int) -> None:
    if 0 <= v < 0x80 or -32 <= v < 0:
        out.append(struct.pack(">b" if v < 0 else ">B", v))
        return
    forms = ((0xCC, ">B", 0, 2**8), (0xCD, ">H", 0, 2**16), (0xCE, ">I", 0, 2**32),
             (0xCF, ">Q", 0, 2**64)) if v >= 0 else (
        (0xD0, ">b", -2**7, 2**7), (0xD1, ">h", -2**15, 2**15), (0xD2, ">i", -2**31, 2**31),
        (0xD3, ">q", -2**63, 2**63))
    for code, fmt, lo, hi in forms:
        if lo <= v < hi:
            out.append(struct.pack(">B" + fmt[1:], code, v))
            return
    raise ValueError(f"integer {v} does not fit 64 bits")


def _array_payload(arr: np.ndarray, name: str) -> bytes:
    """Flax's ndarray payload: packed ``(shape, dtype name, bytes)``."""
    inner: list = []
    _head(inner, 3, 0x90, 16, _ARRAY)
    _head(inner, arr.ndim, 0x90, 16, _ARRAY)
    for d in arr.shape:
        _int(inner, int(d))
    _pack(inner, name, "")
    _pack(inner, np.ascontiguousarray(arr).tobytes(), "")
    return b"".join(inner)


def _ext(out: list, code: int, payload: bytes) -> None:
    n = len(payload)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(struct.pack(">B", fixed[n]))
    else:
        _head(out, n, None, 0, _EXT)
    out.append(struct.pack(">b", code))
    out.append(payload)


class _Array(NamedTuple):
    """An array leaf as it is written: C-order data and Flax's dtype name."""

    data: np.ndarray
    name: str

    @classmethod
    def of(cls, x) -> "_Array":
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu()
            if x.dtype == torch.bfloat16:
                return cls(x.view(torch.int16).numpy().view(np.uint16), "bfloat16")
            x = x.numpy()
        return cls(x, x.dtype.name)


def _chunked(leaf: _Array) -> list:
    """Flax's chunked form of an array over ``MAX_CHUNK_SIZE`` bytes, as
    the (key, value) pairs of its map, in Flax's order."""
    per = max(1, MAX_CHUNK_SIZE // leaf.data.dtype.itemsize)
    flat = leaf.data.reshape(-1)
    return [(CHUNKED, True),
            ("shape", [(str(i), int(d)) for i, d in enumerate(leaf.data.shape)]),
            ("chunks", [(str(i), _Array(flat[j:j + per], leaf.name))
                        for i, j in enumerate(range(0, flat.size, per))])]


def _map(out: list, pairs, path: str) -> None:
    """A map of ``pairs`` in their order; a value that is a list of pairs
    is a map too (the chunked form)."""
    _head(out, len(pairs), 0x80, 16, _MAP)
    for k, v in pairs:
        _pack(out, k, path)
        if isinstance(v, list):
            _map(out, v, f"{path}/{k}")
        else:
            _pack(out, v, f"{path}/{k}")


def _pack(out: list, x, path: str) -> None:
    if isinstance(x, (torch.Tensor, np.ndarray)):
        x = _Array.of(x)
    if isinstance(x, bool):
        out.append(b"\xc3" if x else b"\xc2")
    elif isinstance(x, _Array):
        _dtype(x.name, path)
        if x.data.size * x.data.dtype.itemsize > MAX_CHUNK_SIZE:
            _map(out, _chunked(x), path)
        else:
            _ext(out, EXT_NDARRAY, _array_payload(x.data, x.name))
    elif isinstance(x, np.generic):
        _dtype(x.dtype.name, path)
        _ext(out, EXT_NPSCALAR, _array_payload(np.asarray(x), x.dtype.name))
    elif isinstance(x, int):
        _int(out, x)
    elif isinstance(x, str):
        raw = x.encode("utf-8")
        _head(out, len(raw), 0xA0, 32, _STR)
        out.append(raw)
    elif isinstance(x, bytes):
        _head(out, len(x), None, 0, _BIN)
        out.append(x)
    elif isinstance(x, dict):
        bad = [k for k in x if not isinstance(k, str)]
        if bad:
            raise TypeError(f"map key {bad[0]!r} at {path or '<root>'} is not a str")
        # in sorted order, as Flax writes a dict (it flattens the tree first)
        _map(out, sorted(x.items(), key=lambda kv: kv[0]), path)
    else:
        raise TypeError(f"leaf {path or '<root>'}: {type(x).__name__} is not written")


def dumps(tree) -> bytes:
    """A param tree (str-keyed dicts over numpy/torch arrays and numpy
    scalars) -> the bytes ``flax.serialization.msgpack_serialize`` gives
    for it: each dict in sorted key order, each array over
    ``MAX_CHUNK_SIZE`` bytes chunked."""
    out: list = []
    _pack(out, tree, "")
    return b"".join(out)


def save_msgpack(tree, path: str) -> None:
    """Write ``tree`` to ``path`` as Flax's ``.msgpack``, through
    ``path + ".tmp"`` and a rename, so a reader never sees half a file."""
    blob = dumps(tree)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(blob)
    os.replace(tmp, path)
