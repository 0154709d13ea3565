"""Reader of the JAX package's Orbax checkpoints with no JAX, Orbax or tensorstore.

The JAX package saves a pytree with ``orbax.checkpoint.PyTreeCheckpointer`` (its
``DynamicsHandler.save`` as ``checkpoint/``, the loop's proposer as ``proposer/``). Such a
directory holds ``_METADATA`` (JSON: each leaf's key path with its key types) and the arrays
as zarr v2 arrays named by the dotted path (``params.net.0.w/.zarray``,
``params.net.0.w/0.0.0``). With OCDBT on (Orbax's default) the arrays live in one key-value
store: ``manifest.ocdbt`` and the B-tree nodes and values it references in ``d/`` and
``ocdbt.process_*/d/``. With OCDBT off (as :mod:`~blackbox_mpc_torch.learning.orbax_write`
writes the port's checkpoints) each key is a file of its own.

:func:`restore_pytree` gives the tree as Orbax's restore with ``restore_type=np.ndarray``
gives it: dicts for dict keys, lists for sequence indices (optax's tuple states come back as
lists), ``None`` for ``None`` leaves, numpy arrays elsewhere. Only what Orbax writes is read:
OCDBT format version 0 with zstd or no compression, one process, zarr v2 with zstd or no
compressor. Anything else raises ``ValueError`` naming the path.

The OCDBT encoding, as tensorstore writes it (the numbers little-endian, ``varint`` LEB128):
a manifest or B-tree node is ``magic u32 (big-endian), length u64, version varint,
compression varint``, the body (a zstd frame when compressed) and a CRC-32C of all before it.
The manifest's body: the config (uuid[16], manifest kind, max inline value bytes, max decoded
node bytes, version tree arity log2 u8, compression with a zstd level i32), a data file table,
then the versions column by column (generation, root height u8, root's file, offset, length,
three statistics, commit time u64); version tree nodes after them are not needed for the
latest version. A data file table is ``count``, the shared prefix with the previous path for
every path but the first, each suffix's length, each base path's length, the suffixes; a path
names a file under the store's directory. A B-tree node's body is ``height u8``, its data file
table and its entries column by column: leaves hold keys (prefix-compressed), value lengths,
kinds (0 inline, 1 in a data file) and each stored value's file and offset, then the inline
values; interior nodes hold keys, each subtree's common prefix length (dropped from the keys
in the child) and each child's file, offset, length and three statistics.
"""
from __future__ import annotations

import hashlib
import json
import math
import os
import struct
from typing import Union

import numpy as np

from blackbox_mpc_torch.learning import _zstd

__all__ = ["DirectoryStore", "OcdbtStore", "leaf_digests", "named_leaves", "read_zarr2",
           "restore_pytree"]

_MANIFEST_MAGIC = 0x0CDB3A2A
_BTREE_MAGIC = 0x0CDB20DE
_OCDBT_VERSION = 0
_NO_COMPRESSION, _ZSTD = 0, 1
_MISSING = 2**64 - 1  # the offset and length of an empty tree's root
_INLINE, _INDIRECT = 0, 1
# Orbax's key types in _METADATA.
_SEQUENCE_KEY, _DICT_KEY = 1, 2
_ARRAY_TYPES = ("jax.Array", "np.ndarray", "scalar")


def _crc32c_table() -> list:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC32C = _crc32c_table()


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for byte in data:
        crc = _CRC32C[(crc ^ byte) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


class _Cursor:
    """Reads the encoding's fields from ``data``; running past its end is a ValueError."""

    def __init__(self, data: bytes, where: str):
        self.data, self.pos, self.where = data, 0, where

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError(f"{self.where}: truncated ({len(self.data)} bytes, wanted "
                             f"{self.pos + n})")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def varint(self) -> int:
        value = shift = 0
        while True:
            byte = self.u8()
            value |= (byte & 0x7F) << shift
            if not byte & 0x80:
                return value
            shift += 7
            if shift > 63:
                raise ValueError(f"{self.where}: varint longer than 10 bytes")

    def varints(self, n: int) -> list:
        return [self.varint() for _ in range(n)]


def _open_envelope(raw: bytes, magic: int, where: str) -> bytes:
    """The body of a manifest or B-tree node: header, CRC and compression checked."""
    if len(raw) < 18:
        raise ValueError(f"{where}: truncated ({len(raw)} bytes)")
    found, length = struct.unpack(">I", raw[:4])[0], struct.unpack("<Q", raw[4:12])[0]
    if found != magic:
        raise ValueError(f"{where}: magic {found:#010x}, expected {magic:#010x}")
    if length != len(raw):
        raise ValueError(f"{where}: truncated or padded: {len(raw)} bytes, header says {length}")
    if _crc32c(raw[:-4]) != struct.unpack("<I", raw[-4:])[0]:
        raise ValueError(f"{where}: CRC-32C mismatch")
    head = _Cursor(raw[:-4], where)
    head.take(12)
    version, compression = head.varint(), head.varint()
    if version != _OCDBT_VERSION:
        raise ValueError(f"{where}: OCDBT format version {version} is not read here")
    body = raw[head.pos:-4]
    if compression == _ZSTD:
        return _zstd.decompress(body)
    if compression != _NO_COMPRESSION:
        raise ValueError(f"{where}: compression {compression} is not read here (zstd or none)")
    return body


def _data_file_table(cur: _Cursor) -> list:
    n = cur.varint()
    shared = [0] + cur.varints(n - 1) if n else []
    suffix_lengths, base_lengths = cur.varints(n), cur.varints(n)
    paths, prev = [], b""
    for i in range(n):
        path = prev[:shared[i]] + cur.take(suffix_lengths[i])
        if shared[i] > len(prev) or base_lengths[i] > len(path):
            raise ValueError(f"{cur.where}: malformed data file table")
        paths.append(path.decode())
        prev = path
    return paths


class OcdbtStore:
    """The key-value store of an Orbax checkpoint directory saved with OCDBT: its manifest's
    latest version, read when the store opens. ``keys()`` and ``read(key) -> bytes``."""

    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        where = os.path.join(self.directory, "manifest.ocdbt")
        try:
            with open(where, "rb") as f:
                raw = f.read()
        except OSError as e:
            raise ValueError(f"{where}: no OCDBT manifest ({e})") from e
        cur = _Cursor(_open_envelope(raw, _MANIFEST_MAGIC, where), where)
        cur.take(16)  # uuid
        if cur.varint() != 0:
            raise ValueError(f"{where}: a numbered manifest is not read here (Orbax writes one "
                             "manifest)")
        cur.varint()  # max inline value bytes
        cur.varint()  # max decoded node bytes (a target of the writer's)
        cur.u8()  # version tree arity log2
        compression = cur.varint()
        if compression == _ZSTD:
            cur.take(4)  # level
        elif compression != _NO_COMPRESSION:
            raise ValueError(f"{where}: compression {compression} is not read here")
        files = _data_file_table(cur)
        n = cur.varint()
        if n == 0:
            raise ValueError(f"{where}: the manifest holds no version")
        cur.varints(n)  # generation numbers
        heights = [cur.u8() for _ in range(n)]
        file_ids, offsets, lengths = cur.varints(n), cur.varints(n), cur.varints(n)
        self._values: dict = {}
        if offsets[-1] != _MISSING:  # else the latest version is empty
            self._walk(self._ref(files, file_ids[-1], offsets[-1], lengths[-1], where),
                       heights[-1], b"")

    def _ref(self, files: list, file_id: int, offset: int, length: int, where: str) -> tuple:
        if file_id >= len(files):
            raise ValueError(f"{where}: data file {file_id} not in its table of {len(files)}")
        path = files[file_id]
        if os.path.isabs(path) or ".." in path.split("/"):
            raise ValueError(f"{where}: data file {path!r} lies outside the checkpoint")
        return os.path.join(self.directory, path), offset, length

    def _fetch(self, ref: tuple) -> bytes:
        path, offset, length = ref
        try:
            with open(path, "rb") as f:
                f.seek(offset)
                data = f.read(length)
        except OSError as e:
            raise ValueError(f"{path}: dangling reference ({e})") from e
        if len(data) != length:
            raise ValueError(f"{path}: dangling reference: {length} bytes at {offset}, the file "
                             f"has {offset + len(data)}")
        return data

    def _walk(self, ref: tuple, height: int, prefix: bytes) -> None:
        where = f"{ref[0]}@{ref[1]}"
        body = _open_envelope(self._fetch(ref), _BTREE_MAGIC, where)
        cur = _Cursor(body, where)
        if cur.u8() != height:
            raise ValueError(f"{where}: node height differs from its parent's reference")
        files = _data_file_table(cur)
        n = cur.varint()
        shared = [0] + cur.varints(n - 1) if n else []
        suffix_lengths = cur.varints(n)
        common = cur.varints(n) if height else None
        keys, prev = [], b""
        for i in range(n):
            if shared[i] > len(prev):
                raise ValueError(f"{where}: malformed key prefix")
            prev = prev[:shared[i]] + cur.take(suffix_lengths[i])
            keys.append(prev)
        if height:
            file_ids, offsets, lengths = cur.varints(n), cur.varints(n), cur.varints(n)
            for i, key in enumerate(keys):
                if common[i] > len(key):
                    raise ValueError(f"{where}: malformed subtree prefix")
                self._walk(self._ref(files, file_ids[i], offsets[i], lengths[i], where),
                           height - 1, prefix + key[:common[i]])
            return
        value_lengths, kinds = cur.varints(n), cur.varints(n)
        if any(k not in (_INLINE, _INDIRECT) for k in kinds):
            raise ValueError(f"{where}: value kind {max(kinds)} is not read here")
        indirect = kinds.count(_INDIRECT)
        file_ids, offsets = cur.varints(indirect), cur.varints(indirect)
        stored = iter(zip(file_ids, offsets))
        for key, length, kind in zip(keys, value_lengths, kinds):
            if kind == _INDIRECT:
                file_id, offset = next(stored)
                value = self._ref(files, file_id, offset, length, where)
            else:
                value = cur.take(length)
            self._values[(prefix + key).decode()] = value
        if cur.pos != len(body):
            raise ValueError(f"{where}: {len(body) - cur.pos} bytes after the last entry")

    def keys(self) -> list:
        return sorted(self._values)

    def read(self, key: str) -> bytes:
        value = self._values[key]
        return value if isinstance(value, bytes) else self._fetch(value)


class DirectoryStore:
    """The store of a checkpoint saved with OCDBT off: every key a file under ``directory``."""

    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)

    def keys(self) -> list:
        return sorted(os.path.relpath(os.path.join(root, name), self.directory)
                      for root, _, names in os.walk(self.directory) for name in names)

    def read(self, key: str) -> bytes:
        if os.path.isabs(key) or ".." in key.split("/"):
            raise ValueError(f"{key!r} lies outside {self.directory}")
        with open(os.path.join(self.directory, key), "rb") as f:
            return f.read()


Store = Union[OcdbtStore, DirectoryStore]


def _fill_value(value):
    if value is None:
        return 0
    if isinstance(value, str):  # zarr v2 writes the non-finite floats by name
        return {"NaN": np.nan, "Infinity": np.inf, "-Infinity": -np.inf}[value]
    return value


def read_zarr2(store: Store, name: str, keys=None) -> np.ndarray:
    """The zarr v2 array ``name`` of ``store`` (its ``.zarray`` and chunks): C order,
    ``dimension_separator`` "." or "/", compressor zstd or none, chunks that were never
    written taken as ``fill_value``. ``keys``, the store's keys as a set, saves listing them
    again for every array."""
    keys = set(store.keys()) if keys is None else keys
    where = f"{getattr(store, 'directory', store)}/{name}"
    if f"{name}/zarr.json" in keys:
        raise ValueError(f"{where}: a zarr v3 array is not read here")
    if f"{name}/.zarray" not in keys:
        raise ValueError(f"{where}: no .zarray")
    meta = json.loads(store.read(f"{name}/.zarray"))
    if meta.get("zarr_format") != 2:
        raise ValueError(f"{where}: zarr format {meta.get('zarr_format')} is not read here")
    if meta.get("order", "C") != "C" or meta.get("filters"):
        raise ValueError(f"{where}: order {meta.get('order')!r} with filters "
                         f"{meta.get('filters')!r} is not read here (C order, no filters)")
    compressor = meta.get("compressor")
    if compressor is not None and compressor.get("id") != "zstd":
        raise ValueError(f"{where}: compressor {compressor.get('id')!r} is not read here")
    try:
        dtype = np.dtype(meta["dtype"])
    except TypeError as e:
        raise ValueError(f"{where}: dtype {meta['dtype']!r} is not read here") from e
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    if len(chunks) != len(shape) or dtype.hasobject or dtype.fields:
        raise ValueError(f"{where}: chunks {chunks} for shape {shape}, dtype {dtype}")
    sep = meta.get("dimension_separator", ".")
    out = np.full(shape, _fill_value(meta.get("fill_value")), dtype.newbyteorder("="))
    chunk_bytes = math.prod(chunks) * dtype.itemsize
    grid = [math.ceil(s / c) if c else 0 for s, c in zip(shape, chunks)]
    for index in np.ndindex(*grid):
        key = f"{name}/{sep.join(map(str, index)) if index else '0'}"
        if key not in keys:
            continue
        raw = store.read(key)
        if compressor is not None:
            raw = _zstd.decompress(raw)
        if len(raw) != chunk_bytes:
            raise ValueError(f"{where}: chunk {key} holds {len(raw)} bytes, expected "
                             f"{chunk_bytes}")
        chunk = np.frombuffer(raw, dtype).reshape(chunks)
        region = tuple(slice(i * c, min((i + 1) * c, s))
                       for i, c, s in zip(index, chunks, shape))
        out[region] = chunk[tuple(slice(0, r.stop - r.start) for r in region)]
    return out


def _nest(entries: list, where: str):
    """The tree of ``[(key path, leaf)]``, a key path being ``[(key, key type)]``."""
    root: dict = {}
    kinds = {id(root): None}
    for path, leaf in entries:
        node = root
        for depth, (key, kind) in enumerate(path):
            if kind not in (_SEQUENCE_KEY, _DICT_KEY):
                raise ValueError(f"{where}: key type {kind} is not read here")
            if kinds[id(node)] not in (None, kind):
                raise ValueError(f"{where}: {key!r} mixes sequence and dict keys")
            kinds[id(node)] = kind
            key = int(key) if kind == _SEQUENCE_KEY else key
            if depth == len(path) - 1:
                node[key] = leaf
            else:
                child = node.setdefault(key, {})
                kinds.setdefault(id(child), None)
                node = child

    def build(node):
        if not isinstance(node, dict):
            return node
        if kinds[id(node)] == _SEQUENCE_KEY:
            if sorted(node) != list(range(len(node))):
                raise ValueError(f"{where}: sequence indices {sorted(node)} have gaps")
            return [build(node[i]) for i in range(len(node))]
        return {k: build(v) for k, v in node.items()}

    return build(root)


def restore_pytree(directory: str):
    """The pytree Orbax saved in ``directory``, as numpy arrays (see the module's doc)."""
    directory = os.path.abspath(directory)
    try:
        with open(os.path.join(directory, "_METADATA")) as f:
            meta = json.load(f)
    except OSError as e:
        raise ValueError(f"{directory}: not an Orbax pytree checkpoint ({e})") from e
    if meta.get("use_zarr3"):
        raise ValueError(f"{directory}: zarr v3 arrays are not read here")
    arrays_meta = os.path.join(directory, "array_metadatas")
    names = os.listdir(directory) + (os.listdir(arrays_meta) if os.path.isdir(arrays_meta)
                                     else [])
    processes = {n.rsplit("_", 1)[1] for n in names if n.startswith(("process_", "ocdbt.process_"))}
    if len(processes) > 1:
        raise ValueError(f"{directory}: a checkpoint written by processes {sorted(processes)} "
                         "(sharded over several) is not read here")
    if meta.get("use_ocdbt", True):
        store = OcdbtStore(directory)
    else:
        store = DirectoryStore(directory)
    keys = set(store.keys())
    entries = []
    for name, entry in meta["tree_metadata"].items():
        path = [(k["key"], k["key_type"]) for k in entry["key_metadata"]]
        value_type = entry["value_metadata"]["value_type"]
        if value_type == "None":
            leaf = None
        elif value_type in _ARRAY_TYPES:
            leaf = read_zarr2(store, ".".join(str(k) for k, _ in path), keys)
        else:
            raise ValueError(f"{directory}: leaf {name} of type {value_type!r} is not read here")
        entries.append((path, leaf))
    return _nest(entries, directory)


def named_leaves(tree, prefix: str = "") -> dict:
    """The leaves of a tree of dicts and lists by Orbax's name for them: the key path joined
    with dots (``opt_state.0.mu.net.0.w``), as the zarr arrays are named."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for key, value in items:
        out.update(named_leaves(value, f"{prefix}.{key}" if prefix else str(key)))
    return out


def leaf_digests(tree) -> dict:
    """``{Orbax parameter name: {"dtype", "shape", "sha256"}}`` of a tree of numpy leaves
    (``None`` for a ``None`` leaf): what a reader of the tree must reproduce bit for bit."""
    return {name: None if leaf is None else {
        "dtype": leaf.dtype.name, "shape": list(leaf.shape),
        "sha256": hashlib.sha256(leaf.tobytes()).hexdigest()}
        for name, leaf in sorted(named_leaves(tree).items())}
