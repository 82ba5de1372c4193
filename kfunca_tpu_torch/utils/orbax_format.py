"""The on-disk format of orbax's StandardCheckpointer, read and written with
numpy alone: TensorStore's OCDBT key-value store holding zarr v2 arrays.

utils/checkpoint.save_orbax / load_orbax are built on this module; the JAX
package's counterparts call orbax, which the port does not depend on.  A
checkpoint directory holds
  * orbax's JSON files: `_CHECKPOINT_METADATA`, `_METADATA` (the tree's
    leaves keyed by the repr of their key tuple, "('l', '0')", each with
    its keys, key_type 2 a dict key and 1 a sequence index, and its value
    type, "jax.Array" or "scalar"), `_sharding` (keyed by the base64 of the
    dotted name) and `array_metadatas/process_<n>`;
  * an OCDBT store: `manifest.ocdbt` and the files it names under `d/` (a
    writer of several processes adds `ocdbt.process_<n>/`, whose files the
    top tree names with that base path);
  * in the store, for each leaf of dotted name `n` (keys joined by "."),
    `n/.zarray` (zarr v2 metadata) and its chunks `n/0.0...` (one key a
    chunk, indices joined by the metadata's dimension_separator; "0" for a
    0-d array), each chunk a zstd frame when the compressor is zstd.

OCDBT files (TensorStore's documented format): a manifest or B+tree node is
a 4-byte big-endian magic (0x0cdb3a2a manifest, 0x0cdb20de node), the
file's length as a little-endian u64, a varint version (0) and a varint
compression (0 none, 1 zstd), the body (zstd-compressed or not), and a
little-endian crc32c of every byte before it.  Integers in bodies are
LEB128 varints unless said otherwise; lists are stored column by column.
  * manifest body: the config (uuid[16], manifest_kind, max_inline_value_
    bytes, max_decoded_node_bytes, version_tree_arity_log2 as a byte,
    compression, and for zstd its level as a little-endian int32), then the
    inline version tree leaf (a data file table; num_versions;
    generation_number[], root_height[] (bytes), the root's data_file_id[],
    offset[], length[], num_keys[], num_tree_bytes[],
    num_indirect_value_bytes[], commit_time[] as u64), then the number of
    version tree nodes.  A root offset of 2^64 - 1 is an empty tree.
  * a data file table: num_files; path_prefix_length[1:] (shared with the
    previous path); path_suffix_length[]; base_path_length[]; the suffixes'
    bytes.  A file's path, relative to the store, is the base path and the
    relative path together.
  * a node body: height (a byte); a data file table; num_entries;
    key_prefix_length[1:] (shared with the previous key); key_suffix_
    length[]; interior nodes only: subtree_common_prefix_length[]; the
    suffixes' bytes; then
      leaf: value_length[]; value_kind[] (0 inline, 1 in a data file); for
        the indirect values data_file_id[] and offset[]; the inline values'
        bytes in entry order;
      interior: the child's data_file_id[], offset[], length[], num_keys[],
        num_tree_bytes[], num_indirect_value_bytes[].
    A node's keys leave out the prefix its parent entry declared common to
    the subtree (the parent's key prefix, that entry's subtree_common_
    prefix_length bytes of it).

Reading takes the newest version of a manifest of kind "single" (orbax's),
any depth of tree, inline and indirect values, nodes compressed or not.
zstd frames decode in the native core (csrc/core.cpp kf_zstd_decompress,
runtime/_native.py): without it, reading raises RuntimeError.  Writing
needs no compressor: every zstd frame written here is made of raw blocks
(valid for every reader), so a checkpoint is about the size of its raw
arrays.  A writer here makes one data file of values and one leaf node,
under orbax's config (values up to 1024 bytes inline, nodes up to 10^8
bytes decoded, zstd named as the compression); the files themselves are
written uncompressed.
"""

from __future__ import annotations

import base64
import json
import math
import os
import struct
import time
import uuid

import numpy as np

from ..runtime import _native

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
NO_ROOT = (1 << 64) - 1
# orbax's OCDBT config: a reader that opens the store with it (orbax does)
# refuses a manifest whose config differs
MAX_INLINE_VALUE_BYTES = 1024
MAX_DECODED_NODE_BYTES = 100_000_000
VERSION_TREE_ARITY_LOG2 = 4
ZSTD_RAW_BLOCK = 1 << 17  # the largest block a zstd frame may hold

# zarr v2 dtype strings <-> numpy dtypes (bfloat16 travels as its uint16
# bits: numpy has no bf16)
ZARR_DTYPES = {
    "<f4": np.float32, "<f8": np.float64, "<f2": np.float16,
    "bfloat16": np.uint16, "|i1": np.int8, "<i1": np.int8,
    "<i2": np.int16, "<i4": np.int32, "<i8": np.int64, "|u1": np.uint8,
    "<u1": np.uint8, "|b1": np.bool_, "<b1": np.bool_,
}
NUMPY_TO_ZARR = {
    np.dtype(np.float32): "<f4", np.dtype(np.float64): "<f8",
    np.dtype(np.float16): "<f2", np.dtype(np.int8): "|i1",
    np.dtype(np.int16): "<i2", np.dtype(np.int32): "<i4",
    np.dtype(np.int64): "<i8", np.dtype(np.uint8): "|u1",
    np.dtype(np.bool_): "|b1",
}

# -- crc32c and zstd ----------------------------------------------------------

_CRC_TABLE: list | None = None


def crc32c(data, crc: int = 0) -> int:
    """crc32c (Castagnoli, reflected) of `data`, continuing from `crc`; only
    manifests and B+tree nodes, a few KB each, are checksummed."""
    global _CRC_TABLE
    if _CRC_TABLE is None:
        table = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ (0x82F63B78 if c & 1 else 0)
            table.append(c)
        _CRC_TABLE = table
    table, c = _CRC_TABLE, crc ^ 0xFFFFFFFF
    for b in memoryview(data).cast("B"):
        c = (c >> 8) ^ table[(c ^ b) & 0xFF]
    return c ^ 0xFFFFFFFF


_ZSTD_ERRORS = {-1: "corrupt data", -2: "a content checksum that does not "
                "match", -3: "a frame that needs a dictionary",
                -4: "truncated data"}


def zstd_decompress(data, size: int | None = None) -> np.ndarray:
    """The bytes of the zstd frames in `data` as a uint8 array, decoded by
    the native core.  `size`: the expected decoded size (the buffer is
    made for it; decoding to another size raises)."""
    lib = _native.get_lib()
    if lib is None:
        raise RuntimeError(
            "reading zstd needs the native core (csrc/core.cpp, built by g++ "
            "into kfunca_tpu_torch/build/; unset KFUNCA_NO_NATIVE), and the "
            "port has no slower path")
    src = np.frombuffer(data, dtype=np.uint8) if not isinstance(
        data, np.ndarray) else data
    cap = size if size is not None else max(65536, 8 * len(src))
    while True:
        out = np.empty(cap, dtype=np.uint8)
        got = lib.kf_zstd_decompress(src.ctypes.data, len(src),
                                     out.ctypes.data, cap)
        if got < 0:
            raise ValueError(f"zstd: {_ZSTD_ERRORS.get(got, got)}")
        if size is not None and got != size:
            raise ValueError(f"zstd: decoded {got} bytes where {size} were "
                             f"expected")
        if got <= cap:
            return out[:got]
        cap = got


def zstd_raw_frame_parts(data: memoryview) -> list:
    """A zstd frame of raw blocks holding `data`, as a list of buffers
    (the data's own slices, not copies): single segment, 8-byte content
    size, no checksum."""
    n = len(data)
    parts = [struct.pack("<IBQ", 0xFD2FB528, 0xE0, n)]
    pos = 0
    while True:
        size = min(ZSTD_RAW_BLOCK, n - pos)
        last = pos + size == n
        parts.append(struct.pack("<I", int(last) | (size << 3))[:3])
        if size:
            parts.append(data[pos:pos + size])
        pos += size
        if last:
            return parts


# -- varints and framing -----------------------------------------------------


class _Body:
    """A cursor over a decoded manifest or node body."""

    def __init__(self, data, what: str):
        self.b, self.p, self.what = bytes(data), 0, what

    def byte(self) -> int:
        if self.p >= len(self.b):
            raise ValueError(f"{self.what}: truncated")
        self.p += 1
        return self.b[self.p - 1]

    def varint(self) -> int:
        out = shift = 0
        while True:
            x = self.byte()
            out |= (x & 0x7F) << shift
            if x < 0x80:
                return out
            shift += 7
            if shift > 63:
                raise ValueError(f"{self.what}: varint too long")

    def varints(self, n: int) -> list:
        return [self.varint() for _ in range(n)]

    def take(self, n: int) -> bytes:
        if self.p + n > len(self.b):
            raise ValueError(f"{self.what}: truncated")
        self.p += n
        return self.b[self.p - n:self.p]


def _put_varint(out: bytearray, v: int) -> None:
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)


def _unframe(buf: bytes, magic: int, what: str) -> bytes:
    """The body of a manifest or node file section, its header and crc32c
    checked."""
    if len(buf) < 18:
        raise ValueError(f"{what}: {len(buf)} bytes is too short")
    got_magic, length = struct.unpack(">I", buf[:4])[0], struct.unpack(
        "<Q", buf[4:12])[0]
    if got_magic != magic:
        raise ValueError(f"{what}: magic {got_magic:#010x}, not {magic:#010x}")
    if length != len(buf):
        raise ValueError(f"{what}: its header says {length} bytes, the file "
                         f"section holds {len(buf)}")
    if crc32c(buf[:-4]) != struct.unpack("<I", buf[-4:])[0]:
        raise ValueError(f"{what}: crc32c mismatch")
    head = _Body(buf[12:-4], what)
    if head.varint() != 0:
        raise ValueError(f"{what}: unknown format version")
    compression = head.varint()
    body = buf[12 + head.p:-4]
    if compression == 1:
        return zstd_decompress(body).tobytes()
    if compression != 0:
        raise ValueError(f"{what}: unknown compression {compression}")
    return body


def _frame(magic: int, body: bytes) -> bytes:
    """A manifest or node file: header, uncompressed body, crc32c."""
    total = 12 + 2 + len(body) + 4
    out = struct.pack(">I", magic) + struct.pack("<Q", total) + b"\0\0" + body
    return out + struct.pack("<I", crc32c(out))


def _read_file_table(r: _Body) -> list:
    n = r.varint()
    if n == 0:
        return []
    prefix = [0] + r.varints(n - 1)
    suffix = r.varints(n)
    r.varints(n)  # base path lengths: the paths are used whole
    paths, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            raise ValueError(f"{r.what}: bad data file table")
        prev = prev[:prefix[i]] + r.take(suffix[i])
        paths.append(prev.decode())
    return paths


def _put_file_table(out: bytearray, paths: list) -> None:
    _put_varint(out, len(paths))
    raw = [p.encode() for p in paths]
    for i in range(1, len(raw)):
        _put_varint(out, 0)
    for p in raw:
        _put_varint(out, len(p))
    for _ in raw:
        _put_varint(out, 0)
    for p in raw:
        out += p


# -- reading a store ---------------------------------------------------------


class OcdbtReader:
    """The newest version of the OCDBT store in `directory`: its keys and
    values (get), read from the node and data files as they are asked for."""

    def __init__(self, directory: str):
        self.dir = directory
        path = os.path.join(directory, "manifest.ocdbt")
        if not os.path.exists(path):
            raise ValueError(f"{directory}: no OCDBT manifest "
                             f"(manifest.ocdbt); orbax with use_ocdbt writes "
                             f"one")
        with open(path, "rb") as f:
            r = _Body(_unframe(f.read(), MANIFEST_MAGIC, path), path)
        r.take(16)  # uuid
        kind = r.varint()
        if kind != 0:
            raise ValueError(f"{path}: manifest_kind {kind} (numbered "
                             f"manifests) is not read here, only 'single'")
        r.varint()
        r.varint()
        r.byte()
        if r.varint() == 1:
            r.take(4)  # zstd level
        files = _read_file_table(r)
        n = r.varint()
        r.varints(n)  # generation numbers
        heights = [r.byte() for _ in range(n)]
        cols = [r.varints(n) for _ in range(6)]
        if n == 0:
            raise ValueError(f"{path}: no version")
        file_id, offset, length = cols[0][-1], cols[1][-1], cols[2][-1]
        self.height = heights[-1]  # of the newest version's root
        self.keys: dict = {}  # key -> ("inline", bytes) or (path, off, len)
        if offset != NO_ROOT:
            self._walk(files[file_id], offset, length, heights[-1], b"")

    def _section(self, rel: str, offset: int, length: int) -> bytes:
        path = os.path.join(self.dir, rel)
        try:
            with open(path, "rb") as f:
                f.seek(offset)
                data = f.read(length)
        except OSError as e:
            raise ValueError(f"OCDBT data file {rel}: {e}") from None
        if len(data) != length:
            raise ValueError(f"OCDBT data file {rel}: {length} bytes at "
                             f"{offset} run past its end")
        return data

    def _walk(self, rel, offset, length, height, prefix: bytes) -> None:
        what = f"OCDBT node {rel}@{offset}"
        r = _Body(_unframe(self._section(rel, offset, length), NODE_MAGIC,
                           what), what)
        if r.byte() != height:
            raise ValueError(f"{what}: height differs from its reference")
        files = _read_file_table(r)
        n = r.varint()
        kprefix = [0] + r.varints(max(n - 1, 0))
        ksuffix = r.varints(n)
        common = r.varints(n) if height > 0 else None
        keys, prev = [], b""
        for i in range(n):
            prev = prev[:kprefix[i]] + r.take(ksuffix[i])
            keys.append(prev)
        if height > 0:
            cols = [r.varints(n) for _ in range(6)]
            for i in range(n):
                self._walk(files[cols[0][i]], cols[1][i], cols[2][i],
                           height - 1, prefix + keys[i][:common[i]])
            return
        lengths = r.varints(n)
        kinds = [r.varint() for _ in range(n)]
        indirect = [i for i in range(n) if kinds[i] == 1]
        ids = r.varints(len(indirect))
        offs = r.varints(len(indirect))
        refs = dict(zip(indirect, zip(ids, offs)))
        for i in range(n):
            if kinds[i] == 0:
                self.keys[prefix + keys[i]] = ("inline", r.take(lengths[i]))
            elif kinds[i] == 1:
                fid, off = refs[i]
                self.keys[prefix + keys[i]] = (files[fid], off, lengths[i])
            else:
                raise ValueError(f"{what}: unknown value kind {kinds[i]}")

    def get(self, key: str):
        """The value of `key` (bytes or a uint8 array), or None."""
        ref = self.keys.get(key.encode())
        if ref is None:
            return None
        if ref[0] == "inline":
            return ref[1]
        rel, off, length = ref
        out = np.empty(length, dtype=np.uint8)
        with open(os.path.join(self.dir, rel), "rb") as f:
            f.seek(off)
            if f.readinto(memoryview(out)) != length:
                raise ValueError(f"OCDBT data file {rel}: value of {key!r} "
                                 f"runs past its end")
        return out


# -- zarr v2 -------------------------------------------------------------


def read_zarr(store: OcdbtReader, name: str):
    """(numpy array, zarr dtype string) of the zarr v2 array `name`."""
    raw = store.get(f"{name}/.zarray")
    if raw is None:
        raise ValueError(f"the checkpoint has no array {name!r} (no key "
                         f"{name}/.zarray)")
    meta = json.loads(bytes(raw))
    if meta.get("zarr_format") != 2:
        raise ValueError(f"{name}: zarr_format {meta.get('zarr_format')}, "
                         f"only 2 is read here")
    dt = meta.get("dtype")
    if not isinstance(dt, str) or dt not in ZARR_DTYPES:
        raise ValueError(f"{name}: zarr dtype {dt!r} is not read here "
                         f"({sorted(ZARR_DTYPES)})")
    if meta.get("order", "C") != "C" or meta.get("filters"):
        raise ValueError(f"{name}: order {meta.get('order')!r} with filters "
                         f"{meta.get('filters')!r}; only C order without "
                         f"filters is read here")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise ValueError(f"{name}: compressor {comp.get('id')!r}; only zstd "
                         f"or none is read here")
    shape, chunks = list(meta["shape"]), list(meta["chunks"])
    if len(shape) != len(chunks):
        raise ValueError(f"{name}: chunks {chunks} do not match shape {shape}")
    sep = meta.get("dimension_separator", ".")
    dtype = np.dtype(ZARR_DTYPES[dt])
    chunk_bytes = math.prod(chunks) * dtype.itemsize
    grid = [-(-s // c) if c else 0 for s, c in zip(shape, chunks)]
    if chunks == shape and comp is not None:  # one chunk: its buffer is all
        key = f"{name}/{sep.join('0' for _ in shape) or '0'}"
        data = store.get(key)
        if data is not None:
            return zstd_decompress(data, chunk_bytes).view(dtype).reshape(
                shape), dt
    out = np.empty(shape, dtype=dtype)
    for idx in np.ndindex(*grid):
        key = f"{name}/{sep.join(map(str, idx)) if idx else '0'}"
        data = store.get(key)
        if data is None:
            if meta.get("fill_value") is None:
                raise ValueError(f"{name}: chunk {key!r} is missing and the "
                                 f"array has no fill value")
            fill = meta["fill_value"]
            block = np.full(chunks, fill, dtype=np.float64).astype(dtype)
        else:
            if comp is not None:
                data = zstd_decompress(data, chunk_bytes)
            elif len(data) != chunk_bytes:
                raise ValueError(f"{name}: chunk {key!r} holds {len(data)} "
                                 f"bytes, not {chunk_bytes}")
            block = np.frombuffer(data, dtype=dtype).reshape(chunks)
        sl = tuple(slice(i * c, min((i + 1) * c, s))
                   for i, c, s in zip(idx, chunks, shape))
        out[sl] = block[tuple(slice(0, s.stop - s.start) for s in sl)]
    return out, dt


def zarray_json(shape, zarr_dtype: str) -> bytes:
    """The .zarray of a one-chunk, zstd-framed array, as TensorStore writes
    its keys."""
    return json.dumps({
        "chunks": list(shape), "compressor": {"id": "zstd", "level": 1},
        "dimension_separator": ".", "dtype": zarr_dtype, "fill_value": None,
        "filters": None, "order": "C", "shape": list(shape), "zarr_format": 2,
    }, separators=(",", ":")).encode()


# -- writing a store -----------------------------------------------------


def write_ocdbt(directory: str, values: dict) -> None:
    """An OCDBT store of one version in `directory` (which must exist):
    `values` maps each key (str) to a list of buffers whose concatenation
    is its value.  Values of up to MAX_INLINE_VALUE_BYTES sit in the leaf
    node; the rest, and the node after them, in one data file."""
    keys = sorted(values, key=lambda k: k.encode())
    rel = f"d/{uuid.uuid4().hex}"
    os.makedirs(os.path.join(directory, "d"), exist_ok=True)
    lengths = [sum(len(b) for b in values[k]) for k in keys]
    offsets = {}
    with open(os.path.join(directory, rel), "wb") as f:
        pos = 0
        for k, n in zip(keys, lengths):
            if n > MAX_INLINE_VALUE_BYTES:
                offsets[k] = pos
                for b in values[k]:
                    f.write(b)
                pos += n
        body = bytearray([0])  # height 0: a leaf
        _put_file_table(body, [rel] if offsets else [])
        _put_varint(body, len(keys))
        raw = [k.encode() for k in keys]
        prefixes = [0]  # bytes each key shares with the one before
        for a, b in zip(raw, raw[1:]):
            s = 0
            while s < min(len(a), len(b)) and a[s] == b[s]:
                s += 1
            prefixes.append(s)
        for s in prefixes[1:]:
            _put_varint(body, s)
        for k, s in zip(raw, prefixes):
            _put_varint(body, len(k) - s)
        for k, s in zip(raw, prefixes):
            body += k[s:]
        for n in lengths:
            _put_varint(body, n)
        for k in keys:
            body.append(1 if k in offsets else 0)
        for k in keys:
            if k in offsets:
                _put_varint(body, 0)
        for k in keys:
            if k in offsets:
                _put_varint(body, offsets[k])
        for k, n in zip(keys, lengths):
            if k not in offsets:
                for b in values[k]:
                    body += b
        if len(body) > MAX_DECODED_NODE_BYTES:
            raise ValueError(f"the leaf node of {len(keys)} keys would hold "
                             f"{len(body)} bytes, past "
                             f"{MAX_DECODED_NODE_BYTES}")
        node = _frame(NODE_MAGIC, bytes(body))
        node_off = pos
        f.write(node)
    m = bytearray(uuid.uuid4().bytes)
    m.append(0)  # manifest_kind: single
    _put_varint(m, MAX_INLINE_VALUE_BYTES)
    _put_varint(m, MAX_DECODED_NODE_BYTES)
    m.append(VERSION_TREE_ARITY_LOG2)
    _put_varint(m, 1)  # zstd, as orbax's config names it
    m += struct.pack("<i", 0)  # its level
    _put_file_table(m, [rel])
    _put_varint(m, 1)  # one version
    _put_varint(m, 1)  # generation 1
    m.append(0)  # root height
    for v in (0, node_off, len(node), len(keys), len(node),
              sum(n for k, n in zip(keys, lengths) if k in offsets)):
        _put_varint(m, v)
    m += struct.pack("<Q", time.time_ns())
    _put_varint(m, 0)  # no version tree node
    tmp = os.path.join(directory, f"manifest.ocdbt.{os.getpid()}.tmp")
    with open(tmp, "wb") as f:
        f.write(_frame(MANIFEST_MAGIC, bytes(m)))
    os.replace(tmp, os.path.join(directory, "manifest.ocdbt"))


def sharding_key(name: str) -> str:
    """orbax's `_sharding` key of a dotted name."""
    return base64.urlsafe_b64encode(name.encode()).decode()
