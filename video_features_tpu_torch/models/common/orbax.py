"""The port's reader and writer of orbax checkpoint directories.

An orbax ``StandardCheckpointer`` directory, as orbax writes it with its
defaults (``use_ocdbt`` on, ``use_zarr3`` off), holds:

- ``_CHECKPOINT_METADATA`` (JSON: the handler and timestamps) and
  ``_METADATA`` (JSON: ``tree_metadata``, one entry a leaf with its dict
  keys, and the layout flags);
- one OCDBT key-value store: a ``manifest.ocdbt`` at the top, whose newest
  version names the root of a b-tree, whose leaf nodes map keys to values,
  each value held in the node (inline) or as a byte range of a data file
  (out of line). orbax writes each process's arrays into an
  ``ocdbt.process_N/`` store and merges them into the top one, whose nodes
  then point into the per-process data files;
- in that store, one zarr v2 array a leaf, under the leaf's dotted keys:
  ``<keys>/.zarray`` (JSON: shape, chunks, dtype, compressor, fill value)
  and one value a chunk, ``<keys>/i.j...`` in the chunk grid (``0`` for a
  0-d array).

Manifests and nodes are framed the same way: a 4-byte magic, the frame's
length as a little-endian u64, a version varint, a compression varint (0
none, 1 zstd) and the body, then a CRC-32C (Castagnoli) of all the bytes
before it. Lists in a body are stored column by column: a count, then
each field for every element.

This module reads and writes that format with ``struct``, ``ctypes`` and
numpy alone: it imports no ``orbax``, ``tensorstore``, ``zstandard``,
``jax`` or ``flax``, which a card host need not have.

zstd: both the reader and the writer call the system library
``libzstd.so.1`` through ``ctypes`` (``ZSTD_decompress`` where a frame
states its size, ``ZSTD_decompressStream`` where it does not, as
tensorstore's frames do not; ``ZSTD_compress`` to write). No header and no
build is needed. Where the library does not load, reading or writing an
orbax directory raises and names it.

The writer writes what orbax writes with its defaults, in one store at the
top of the directory: one zstd chunk (level 1) an array, zstd-compressed
nodes and manifest, values over 1024 bytes out of line in one data file,
the metadata files, all in a temporary sibling directory renamed into
place. orbax's ``StandardCheckpointer`` and the JAX package read it back
bit for bit; the bytes differ from orbax's own, which hold random file
names and timestamps anyway.

Leaves come back as numpy arrays, except ``bfloat16`` ones, which numpy
has no type for: those come back as ``torch.bfloat16`` tensors, as
``flax_msgpack`` gives them.
"""

from __future__ import annotations

import ctypes
import functools
import json
import os
import shutil
import struct
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, NamedTuple, Tuple

import numpy as np
import torch

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
COMPRESSION_NONE, COMPRESSION_ZSTD = 0, 1
MANIFEST_SINGLE = 0
MISSING = 2**64 - 1  # the offset and length of an empty version's root
# orbax's OCDBT settings (its add_ocdbt_write_options), which the writer keeps
MAX_INLINE_VALUE_BYTES = 1024
MAX_DECODED_NODE_BYTES = 100_000_000
VERSION_TREE_ARITY_LOG2 = 4
CHUNK_ZSTD_LEVEL = 1  # orbax's zarr compressor: {"id": "zstd", "level": 1}
ZSTD_LIBRARY = "libzstd.so.1"
CHECKPOINT_HANDLER = ("orbax.checkpoint._src.handlers.standard_checkpoint_handler."
                      "StandardCheckpointHandler")

# zarr v2 dtype -> (the numpy dtype of its bytes, the dtype's name); bfloat16
# is read as uint16 and viewed
DTYPES = {
    "<f4": ("<f4", "float32"), "<f2": ("<f2", "float16"), "bfloat16": ("<u2", "bfloat16"),
    "|b1": ("|b1", "bool"), "|i1": ("|i1", "int8"), "<i2": ("<i2", "int16"),
    "<i4": ("<i4", "int32"), "<i8": ("<i8", "int64"), "|u1": ("|u1", "uint8"),
    "<u2": ("<u2", "uint16"), "<u4": ("<u4", "uint32"), "<u8": ("<u8", "uint64"),
}
ZARR_DTYPE = {name: zarr for zarr, (_, name) in DTYPES.items()}


class OrbaxFormatError(ValueError):
    """The bytes are not an orbax directory this reader takes."""


# --- CRC-32C -------------------------------------------------------------------------

def _crc32c_table() -> List[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC32C = _crc32c_table()


def crc32c(data) -> int:
    """CRC-32C (Castagnoli, reflected polynomial 0x82F63B78) of ``data``:
    OCDBT's checksum of a manifest or a node, which are small."""
    crc = 0xFFFFFFFF
    table = _CRC32C
    for b in bytes(data):
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


# --- zstd through libzstd.so.1 -------------------------------------------------------

class _Buffer(ctypes.Structure):
    """``ZSTD_inBuffer`` and ``ZSTD_outBuffer``: a pointer, a size, a position."""

    _fields_ = [("ptr", ctypes.c_void_p), ("size", ctypes.c_size_t), ("pos", ctypes.c_size_t)]


ZSTD_CONTENTSIZE_UNKNOWN = 2**64 - 1
ZSTD_CONTENTSIZE_ERROR = 2**64 - 2


@functools.lru_cache(maxsize=None)
def _zstd() -> ctypes.CDLL:
    try:
        lib = ctypes.CDLL(ZSTD_LIBRARY)
    except OSError as exc:
        raise RuntimeError(
            f"an orbax checkpoint is read and written through the system zstd library "
            f"{ZSTD_LIBRARY}, which does not load here ({exc})") from None
    size_t, ptr = ctypes.c_size_t, ctypes.c_void_p
    for name, restype, argtypes in (
        ("ZSTD_isError", ctypes.c_uint, [size_t]),
        ("ZSTD_getErrorName", ctypes.c_char_p, [size_t]),
        ("ZSTD_getFrameContentSize", ctypes.c_ulonglong, [ptr, size_t]),
        ("ZSTD_decompress", size_t, [ptr, size_t, ptr, size_t]),
        ("ZSTD_compressBound", size_t, [size_t]),
        ("ZSTD_compress", size_t, [ptr, size_t, ptr, size_t, ctypes.c_int]),
        ("ZSTD_createDStream", ptr, []),
        ("ZSTD_freeDStream", size_t, [ptr]),
        ("ZSTD_initDStream", size_t, [ptr]),
        ("ZSTD_decompressStream", size_t, [ptr, ctypes.POINTER(_Buffer),
                                           ctypes.POINTER(_Buffer)]),
    ):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def _zstd_check(lib, ret: int, what: str) -> int:
    if lib.ZSTD_isError(ret):
        raise OrbaxFormatError(f"{what}: zstd {lib.ZSTD_getErrorName(ret).decode()}")
    return ret


def zstd_decompress(data: bytes, what: str, size: int | None = None) -> np.ndarray:
    """zstd frames -> their bytes, as a uint8 array: in one call where the
    frame states its size, else through the streaming decoder (tensorstore
    writes frames that do not). ``size``, where the caller knows it (a zarr
    chunk), is the one size the frame may decode to."""
    lib = _zstd()
    stated = lib.ZSTD_getFrameContentSize(data, len(data))
    if stated == ZSTD_CONTENTSIZE_ERROR:
        raise OrbaxFormatError(f"{what}: not a zstd frame")
    if stated != ZSTD_CONTENTSIZE_UNKNOWN:
        if size is not None and stated != size:
            raise OrbaxFormatError(f"{what}: a zstd frame of {stated} bytes, {size} expected")
        out = np.empty(stated, np.uint8)
        n = _zstd_check(lib, lib.ZSTD_decompress(out.ctypes.data, stated, data, len(data)), what)
        return out[:n]
    out = np.empty(size if size is not None else max(4 * len(data), 1 << 16), np.uint8)
    stream = lib.ZSTD_createDStream()
    if not stream:
        raise MemoryError("ZSTD_createDStream")
    try:
        _zstd_check(lib, lib.ZSTD_initDStream(stream), what)
        src = _Buffer(ctypes.cast(ctypes.c_char_p(data), ctypes.c_void_p), len(data), 0)
        written = 0
        while True:
            dst = _Buffer(out.ctypes.data + written, out.size - written, 0)
            ret = _zstd_check(lib, lib.ZSTD_decompressStream(stream, dst, src), what)
            written += dst.pos
            if not ret and src.pos == src.size:
                break
            if written == out.size:
                if size is not None:
                    raise OrbaxFormatError(f"{what}: a zstd frame of over {size} bytes")
                grown = np.empty(2 * out.size, np.uint8)
                grown[:written] = out
                out = grown
            elif src.pos == src.size:
                raise OrbaxFormatError(f"{what}: a truncated zstd frame")
    finally:
        lib.ZSTD_freeDStream(stream)
    if size is not None and written != size:
        raise OrbaxFormatError(f"{what}: a zstd frame of {written} bytes, {size} expected")
    return out[:written]


def zstd_compress(data, level: int) -> bytes:
    """``data`` (bytes, or a C-contiguous array's memory) as one zstd
    frame, which states its size."""
    src = (np.frombuffer(data, np.uint8) if isinstance(data, bytes)
           else data.reshape(-1).view(np.uint8))
    lib = _zstd()
    out = np.empty(lib.ZSTD_compressBound(src.size), np.uint8)
    n = _zstd_check(lib, lib.ZSTD_compress(out.ctypes.data, out.size, src.ctypes.data, src.size,
                                           level), "compress")
    return out[:n].tobytes()


# --- OCDBT: frames, varints, data-file tables -----------------------------------------

class _Cursor:
    """A cursor over a manifest's or a node's body."""

    def __init__(self, buf: bytes, where: str) -> None:
        self.buf, self.pos, self.where = buf, 0, where

    def take(self, n: int) -> bytes:
        end = self.pos + n
        if end > len(self.buf):
            raise OrbaxFormatError(f"{self.where}: truncated at byte {self.pos}")
        out = self.buf[self.pos:end]
        self.pos = end
        return out

    def varint(self) -> int:
        value = shift = 0
        while True:
            b = self.take(1)[0]
            value |= (b & 0x7F) << shift
            shift += 7
            if b < 0x80:
                return value
            if shift > 63:
                raise OrbaxFormatError(f"{self.where}: a varint over 64 bits at {self.pos}")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]


def _unframe(raw: bytes, magic: int, where: str) -> bytes:
    """A manifest's or a node's frame -> its body, after its magic, length,
    CRC-32C and version are checked and its compression undone."""
    if len(raw) < 18 or struct.unpack(">I", raw[:4])[0] != magic:
        kind = "manifest" if magic == MANIFEST_MAGIC else "node"
        raise OrbaxFormatError(f"{where}: not an OCDBT {kind} (starts {raw[:4].hex()})")
    (length,) = struct.unpack("<Q", raw[4:12])
    if length != len(raw):
        raise OrbaxFormatError(f"{where}: the frame says {length} bytes, {len(raw)} are there")
    (want,) = struct.unpack("<I", raw[-4:])
    got = crc32c(raw[:-4])
    if got != want:
        raise OrbaxFormatError(f"{where}: CRC-32C mismatch (stored {want:08x}, computed {got:08x})")
    cur = _Cursor(raw[:-4], where)
    cur.pos = 12
    version, compression = cur.varint(), cur.varint()
    if version != 0:
        raise OrbaxFormatError(f"{where}: OCDBT format version {version} is not read")
    body = raw[cur.pos:-4]
    if compression == COMPRESSION_ZSTD:
        return zstd_decompress(body, where).tobytes()
    if compression != COMPRESSION_NONE:
        raise OrbaxFormatError(f"{where}: compression format {compression} is not read")
    return body


def _frame(body: bytes, magic: int) -> bytes:
    """The writer's frame: zstd-compressed ``body`` with its CRC-32C."""
    payload = _varint(0) + _varint(COMPRESSION_ZSTD) + zstd_compress(body, 0)
    head = struct.pack(">I", magic) + struct.pack("<Q", 4 + 8 + len(payload) + 4)
    framed = head + payload
    return framed + struct.pack("<I", crc32c(framed))


def _varint(v: int) -> bytes:
    out = bytearray()
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


class DataFile(NamedTuple):
    """A data file of the store: ``base + relative`` is its path under the
    store's root; ``base`` is what the files its nodes name are under."""

    base: str
    relative: str

    @property
    def path(self) -> str:
        return self.base + self.relative


def _read_files(cur: _Cursor, base: str) -> List[DataFile]:
    """A data-file table: a count, the length each path shares with the one
    before it (from the second on), each path's length past that, each
    path's base length, then the path bytes. A path is relative to
    ``base``, the base of the file that holds the table."""
    n = cur.varint()
    if not n:
        return []
    shared = [0] + cur.varints(n - 1)
    rest = cur.varints(n)
    bases = cur.varints(n)
    files, prev = [], b""
    for i in range(n):
        path = prev[:shared[i]] + cur.take(rest[i])
        prev = path
        text = path.decode("utf-8")
        files.append(DataFile(base + text[:bases[i]], text[bases[i]:]))
    return files


def _write_files(paths: List[str]) -> bytes:
    """The table of ``paths`` (sorted, base ``""``), as :func:`_read_files` reads it."""
    out = [_varint(len(paths))]
    if paths:
        raw = [p.encode("utf-8") for p in paths]
        shared = [len(os.path.commonprefix([a, b])) for a, b in zip(raw, raw[1:])]
        out += [_varint(s) for s in shared]
        out += [_varint(len(p) - s) for p, s in zip(raw, [0] + shared)]
        out += [_varint(0) for _ in raw]
        out += [p[s:] for p, s in zip(raw, [0] + shared)]
    return b"".join(out)


def _keys(cur: _Cursor, n: int, interior: bool) -> Tuple[List[bytes], List[int]]:
    """A node's ``n`` keys: the length each shares with the one before (from
    the second on), each key's length past that, in an interior node the
    length of the prefix that every key under each child shares (which
    the child's own keys leave out), then the key bytes."""
    shared = [0] + cur.varints(n - 1)
    rest = cur.varints(n)
    common = cur.varints(n) if interior else [0] * n
    keys, prev = [], b""
    for i in range(n):
        prev = prev[:shared[i]] + cur.take(rest[i])
        keys.append(prev)
    return keys, common


def _pread(path: str, offset: int, length: int) -> bytes:
    """``length`` bytes of ``path`` from ``offset``, without reading the rest."""
    fd = os.open(path, os.O_RDONLY)
    try:
        pieces, got = [], 0
        while got < length:
            piece = os.pread(fd, min(length - got, 1 << 30), offset + got)
            if not piece:
                raise OrbaxFormatError(f"{path}: {length} bytes at {offset} run past its end")
            pieces.append(piece)
            got += len(piece)
        return b"".join(pieces)
    finally:
        os.close(fd)


# --- the reader ------------------------------------------------------------------------

class Location(NamedTuple):
    """A node or a value: ``length`` bytes at ``offset`` of a data file."""

    file: DataFile
    offset: int
    length: int


class _Value(NamedTuple):
    """A leaf entry's value: its bytes (inline), or where they lie."""

    inline: bytes | None
    file: DataFile | None = None
    offset: int = 0
    length: int = 0


class Store:
    """An OCDBT key-value store read from ``root``: its newest version's
    keys, each to its value (``generation``, the b-tree's ``height`` and
    ``root_node`` say which version and where its root lies)."""

    def __init__(self, root: str) -> None:
        self.root = root
        self.entries: Dict[bytes, _Value] = {}
        self.generation, self.height, self.root_node = 0, 0, None
        where = os.path.join(root, "manifest.ocdbt")
        if not os.path.exists(where):
            raise OrbaxFormatError(f"{root}: no manifest.ocdbt (not an OCDBT store)")
        with open(where, "rb") as f:
            cur = _Cursor(_unframe(f.read(), MANIFEST_MAGIC, where), where)
        cur.take(16)  # the store's uuid
        kind = cur.varint()
        if kind != MANIFEST_SINGLE:
            raise OrbaxFormatError(f"{where}: manifest kind {kind} (numbered) is not read")
        cur.varints(2)  # max_inline_value_bytes, max_decoded_node_bytes
        cur.take(1)  # version_tree_arity_log2
        if cur.varint() == COMPRESSION_ZSTD:
            cur.take(4)  # the zstd level the store writes with
        files = _read_files(cur, "")
        n = cur.varint()
        if not n:
            return
        generation = cur.varints(n)
        height = list(cur.take(n))
        file_id, offset, length = cur.varints(n), cur.varints(n), cur.varints(n)
        newest = max(range(n), key=generation.__getitem__)
        self.generation, self.height = generation[newest], height[newest]
        if offset[newest] == MISSING:
            return
        self.root_node = Location(files[file_id[newest]], offset[newest], length[newest])
        self._node(*self.root_node, self.height, b"")

    def _node(self, file: DataFile, offset: int, length: int, height: int, prefix: bytes) -> None:
        where = f"{os.path.join(self.root, file.path)} [{offset}:{offset + length}]"
        cur = _Cursor(_unframe(_pread(os.path.join(self.root, file.path), offset, length),
                               NODE_MAGIC, where), where)
        if cur.take(1)[0] != height:
            raise OrbaxFormatError(f"{where}: a node of another height than its parent says")
        files = _read_files(cur, file.base)
        n = cur.varint()
        keys, common = _keys(cur, n, bool(height))
        if height:
            ids, offsets, lengths = cur.varints(n), cur.varints(n), cur.varints(n)
            for i in range(n):
                self._node(files[ids[i]], offsets[i], lengths[i], height - 1,
                           prefix + keys[i][:common[i]])
            return
        lengths = cur.varints(n)
        kinds = list(cur.take(n))
        out_of_line = [i for i in range(n) if kinds[i]]
        ids, offsets = cur.varints(len(out_of_line)), cur.varints(len(out_of_line))
        where_of = dict(zip(out_of_line, zip(ids, offsets)))
        for i in range(n):
            if kinds[i]:
                fid, off = where_of[i]
                self.entries[prefix + keys[i]] = _Value(None, files[fid], off, lengths[i])
            else:
                self.entries[prefix + keys[i]] = _Value(cur.take(lengths[i]))

    def get(self, key: str) -> bytes | None:
        value = self.entries.get(key.encode("utf-8"))
        if value is None:
            return None
        if value.inline is not None:
            return value.inline
        return _pread(os.path.join(self.root, value.file.path), value.offset, value.length)


def _fill(meta: dict, where: str) -> Any:
    fill = meta.get("fill_value")
    if fill is None:
        return 0
    if isinstance(fill, str):
        if fill in ("NaN", "Infinity", "-Infinity"):
            return float(fill.replace("Infinity", "inf"))
        raise OrbaxFormatError(f"{where}: fill_value {fill!r} is not read")
    return fill


def read_array(store: Store, name: str):
    """The zarr v2 array ``name`` of ``store``: its chunk grid in C order,
    edge chunks cropped, an absent chunk at its ``fill_value``."""
    raw = store.get(f"{name}/.zarray")
    if raw is None:
        raise OrbaxFormatError(f"{store.root}: leaf {name} has no {name}/.zarray")
    meta = json.loads(raw)
    zdtype = meta.get("dtype")
    if not isinstance(zdtype, str) or zdtype not in DTYPES:
        raise OrbaxFormatError(f"{store.root}: leaf {name}: dtype {zdtype!r} is not read "
                               f"(takes {', '.join(DTYPES)})")
    if (meta.get("zarr_format") != 2 or meta.get("order", "C") != "C"
            or meta.get("filters") is not None):
        raise OrbaxFormatError(f"{store.root}: leaf {name}: a zarr layout this reader does not "
                               f"take (zarr_format {meta.get('zarr_format')}, order "
                               f"{meta.get('order')}, filters {meta.get('filters')})")
    compressor = meta.get("compressor")
    if compressor is not None and compressor.get("id") != "zstd":
        raise OrbaxFormatError(f"{store.root}: leaf {name}: compressor {compressor} is not read")
    np_dtype, name_of = DTYPES[zdtype]
    dtype = np.dtype(np_dtype)
    shape, chunks = list(meta["shape"]), list(meta["chunks"])
    sep = meta.get("dimension_separator", ".")
    grid = [-(-s // c) for s, c in zip(shape, chunks)]
    want = int(np.prod(chunks, dtype=np.int64)) * dtype.itemsize
    out = np.empty(shape, dtype)
    for index in np.ndindex(*grid):
        key = f"{name}/{sep.join(map(str, index)) if index else '0'}"
        region = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(index, chunks, shape))
        data = store.get(key)
        if data is None:
            out[region] = _fill(meta, f"{store.root}: leaf {name}")
            continue
        if compressor is not None:
            data = zstd_decompress(data, f"{store.root}: chunk {key}", want)
        elif len(data) != want:
            raise OrbaxFormatError(f"{store.root}: chunk {key} holds {len(data)} bytes, "
                                   f"its shape {chunks} {zdtype} takes {want}")
        chunk = np.frombuffer(data, dtype).reshape(chunks)
        if chunks == shape:  # the whole array in one chunk, as orbax writes it
            out = chunk if chunk.flags.writeable else chunk.copy()
        else:
            out[region] = chunk[tuple(slice(0, r.stop - r.start) for r in region)]
    if name_of == "bfloat16":
        return torch.from_numpy(out).view(torch.bfloat16)
    return out


def _pool() -> ThreadPoolExecutor:
    return ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1))


def is_orbax_checkpoint(path: str) -> bool:
    """An orbax checkpoint directory, told from a plain weights directory
    (I3D's directory of reference-named files) by its marker file."""
    return os.path.isdir(path) and (
        os.path.exists(os.path.join(path, "_CHECKPOINT_METADATA"))
        or os.path.exists(os.path.join(path, "_METADATA"))
    )


def load_orbax(path: str) -> Dict[str, Any]:
    """An orbax ``StandardCheckpointer`` directory -> its nested dict of
    arrays.

    ``_METADATA``'s ``tree_metadata`` lists each leaf's keys; the leaf is
    the zarr array named by the dotted keys in the directory's OCDBT store
    (orbax's defaults; a checkpoint written with ``use_ocdbt`` off or
    ``use_zarr3`` on is refused, and so is a leaf that is not an array
    under dict keys, or of a dtype outside :data:`DTYPES`).

    The whole tree is read on every host, a copy per process: enough for
    every mesh, one process or several (``weights.load_params``)."""
    path = os.path.abspath(path)
    with open(os.path.join(path, "_METADATA")) as f:
        meta = json.load(f)
    if not meta.get("use_ocdbt", True) or meta.get("use_zarr3"):
        raise ValueError(f"{path}: an orbax layout this reader does not take (use_ocdbt "
                         f"{meta.get('use_ocdbt')}, use_zarr3 {meta.get('use_zarr3')})")
    leaves = []
    for entry in meta["tree_metadata"].values():
        keys = [k["key"] for k in entry["key_metadata"]]
        kinds = {k.get("key_type") for k in entry["key_metadata"]}
        value = entry.get("value_metadata", {}).get("value_type")
        if kinds - {2} or value not in ("np.ndarray", "jax.Array"):
            raise ValueError(f"{path}: leaf {'.'.join(map(str, keys))} is not an array "
                             f"under dict keys ({value}, key types {sorted(kinds)})")
        leaves.append(keys)
    store = Store(path)
    with _pool() as pool:  # libzstd runs without the GIL: the leaves decode in parallel
        arrays = list(pool.map(lambda keys: read_array(store, ".".join(keys)), leaves))
    tree: Dict[str, Any] = {}
    for keys, arr in zip(leaves, arrays):
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = arr
    return tree


# --- the writer ------------------------------------------------------------------------

def _leaves(tree, keys: Tuple[str, ...] = ()):
    """(keys, C-order numpy data, zarr dtype) of each leaf, keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            if not isinstance(k, str):
                raise TypeError(f"key {k!r} under {'.'.join(keys) or '<root>'} is not a str")
            yield from _leaves(tree[k], keys + (k,))
        return
    leaf = ".".join(keys) or "<root>"
    if isinstance(tree, torch.Tensor):
        tree = tree.detach().cpu()
        if tree.dtype == torch.bfloat16:
            yield keys, tree.contiguous().view(torch.int16).numpy().view(np.uint16), "bfloat16"
            return
        tree = tree.numpy()
    if not isinstance(tree, (np.ndarray, np.generic)):
        raise TypeError(f"leaf {name}: {type(tree).__name__} is not written")
    arr = np.asarray(tree, order="C")
    if arr.dtype.name not in ZARR_DTYPE:
        raise TypeError(f"leaf {name}: dtype {arr.dtype.name!r} is not written "
                        f"(takes {', '.join(ZARR_DTYPE)})")
    yield keys, arr.astype(arr.dtype.newbyteorder("<"), copy=False), ZARR_DTYPE[arr.dtype.name]


def _zarray(shape, zdtype: str) -> bytes:
    chunks = [max(1, int(d)) for d in shape]
    return json.dumps({
        "chunks": chunks, "compressor": {"id": "zstd", "level": CHUNK_ZSTD_LEVEL},
        "dimension_separator": ".", "dtype": zdtype, "fill_value": None, "filters": None,
        "order": "C", "shape": [int(d) for d in shape], "zarr_format": 2,
    }, sort_keys=True, separators=(",", ":")).encode()


def _leaf_node(entries: List[Tuple[bytes, bytes]], data_path: str,
               offsets: Dict[bytes, int]) -> bytes:
    """A leaf node over ``entries`` (sorted (key, value)); a value whose key
    is in ``offsets`` lies out of line at that offset of ``data_path``."""
    keys = [k for k, _ in entries]
    shared = [len(os.path.commonprefix([a, b])) for a, b in zip(keys, keys[1:])]
    out = [b"\x00", _write_files([data_path] if offsets else []), _varint(len(entries))]
    out += [_varint(s) for s in shared]
    out += [_varint(len(k) - s) for k, s in zip(keys, [0] + shared)]
    out += [k[s:] for k, s in zip(keys, [0] + shared)]
    out += [_varint(len(v)) for _, v in entries]
    out.append(bytes(1 if k in offsets else 0 for k in keys))
    out += [_varint(0) for k in keys if k in offsets]
    out += [_varint(offsets[k]) for k in keys if k in offsets]
    out += [v for k, v in entries if k not in offsets]
    return b"".join(out)


def _manifest(data_path: str, node_offset: int, node_length: int, num_keys: int,
              indirect_bytes: int) -> bytes:
    """A single-kind manifest with one version (generation 1) rooted at the
    leaf node at ``node_offset`` of ``data_path``."""
    config = (os.urandom(16) + _varint(MANIFEST_SINGLE) + _varint(MAX_INLINE_VALUE_BYTES)
              + _varint(MAX_DECODED_NODE_BYTES) + bytes([VERSION_TREE_ARITY_LOG2])
              + _varint(COMPRESSION_ZSTD) + struct.pack("<i", 0))
    version = (_varint(1) + _varint(1) + b"\x00" + _varint(0) + _varint(node_offset)
               + _varint(node_length) + _varint(num_keys) + _varint(node_length)
               + _varint(indirect_bytes) + struct.pack("<Q", time.time_ns()))
    return config + _write_files([data_path]) + version + _varint(0)


def save_orbax(tree, path: str) -> None:
    """Write a converted param tree as an orbax checkpoint directory, the
    counterpart of the JAX package's ``save_orbax``: a nested dict of
    numpy arrays or numpy scalars, or torch tensors (``bfloat16`` too),
    under str keys. The directory is built beside ``path`` and renamed
    into place; an existing ``path`` is refused."""
    path = os.path.abspath(path)
    if os.path.exists(path):
        raise FileExistsError(f"orbax dst already exists: {path}")
    leaves = list(_leaves(tree))
    if not leaves:
        raise ValueError(f"{path}: an empty tree is not written")
    init_ns = time.time_ns()
    with _pool() as pool:
        chunks = list(pool.map(lambda leaf: zstd_compress(leaf[1], CHUNK_ZSTD_LEVEL)
                               if leaf[1].size else None, leaves))
    entries = []
    for (keys, arr, zdtype), chunk in zip(leaves, chunks):
        name = ".".join(keys)
        entries.append((f"{name}/.zarray".encode(), _zarray(arr.shape, zdtype)))
        if chunk is not None:
            entries.append((f"{name}/{'.'.join('0' * arr.ndim) or '0'}".encode(), chunk))
    entries.sort()
    data_path = f"d/{os.urandom(16).hex()}"
    parent = os.path.dirname(path)
    tmp = tempfile.mkdtemp(prefix=f".{os.path.basename(path)}.", dir=parent)
    try:
        os.mkdir(os.path.join(tmp, "d"))
        offsets: Dict[bytes, int] = {}
        with open(os.path.join(tmp, data_path), "wb") as f:
            for key, value in entries:
                if len(value) > MAX_INLINE_VALUE_BYTES:
                    offsets[key] = f.tell()
                    f.write(value)
            node_offset = f.tell()
            node = _frame(_leaf_node(entries, data_path, offsets), NODE_MAGIC)
            f.write(node)
        indirect = sum(len(v) for k, v in entries if k in offsets)
        with open(os.path.join(tmp, "manifest.ocdbt"), "wb") as f:
            f.write(_frame(_manifest(data_path, node_offset, len(node), len(entries), indirect),
                           MANIFEST_MAGIC))
        tree_metadata = {
            repr(keys): {"key_metadata": [{"key": k, "key_type": 2} for k in keys],
                         "value_metadata": {"value_type": "np.ndarray",
                                            "skip_deserialize": False}}
            for keys, _, _ in leaves}
        with open(os.path.join(tmp, "_METADATA"), "w") as f:
            json.dump({"tree_metadata": tree_metadata, "use_ocdbt": True, "use_zarr3": False,
                       "store_array_data_equal_to_fill_value": True, "custom_metadata": None}, f)
        with open(os.path.join(tmp, "_CHECKPOINT_METADATA"), "w") as f:
            json.dump({"item_handlers": CHECKPOINT_HANDLER, "metrics": {},
                       "performance_metrics": {}, "init_timestamp_nsecs": init_ns,
                       "commit_timestamp_nsecs": time.time_ns(), "custom_metadata": {}}, f)
        os.rename(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
