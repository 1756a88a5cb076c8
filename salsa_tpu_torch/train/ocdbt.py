"""TensorStore's OCDBT key-value store, read and written without tensorstore.

orbax keeps every array of a `.orbax` checkpoint in an OCDBT store: a B+tree of
keys whose values sit inline in its nodes or in data files under `d/`. Every
encoded manifest and node is a header (magic u32 big-endian, total length u64,
format version varint 0, compression varint: 0 none, 1 zstd), a body, and a
CRC-32C of everything before it (u32). Integers in a body are LEB128 varints
unless noted, and arrays of records are stored column by column:

- manifest (`manifest.ocdbt`, magic 0x0cdb3a2a): config (uuid 16 bytes, manifest
  kind (0: single), max_inline_value_bytes, max_decoded_node_bytes,
  version_tree_arity_log2 u8, compression (0 none; 1 zstd + level int32)), then
  a data-file table, the newest versions (generation, root height u8, root node
  file / offset / length, number of keys, tree bytes, indirect value bytes,
  commit time u64) and the references to version-tree nodes of older ones
  (generation, file / offset / length, number of generations, commit time u64,
  height u8). A root offset of 2**64 - 1 is an empty tree.
- B+tree node (magic 0x0cdb20de): height u8, a data-file table, the number of
  entries, each key's prefix length shared with the previous key (from the
  second key on) and suffix lengths; in an interior node each child's common
  key-prefix length; the key suffixes; then in a leaf (height 0) each value's
  length, its kind (u8: 0 inline, 1 in a data file), the data file and offset of
  the indirect ones and the inline values, and in an interior node each child's
  file / offset / length and its three statistics.
  Keys are relative to the prefix the parent gives its subtree.
- data-file table: the number of files, each path's prefix length shared with
  the previous path (from the second on), suffix lengths, base-path lengths and
  the suffixes. A path is relative to the base path of the file holding the
  table; a node read from a file takes that file's base path as its own.

`OcdbtStore` reads the newest version of a store; `write` writes a new store of
one version. Every fault (a bad magic, length or CRC, an unknown format version,
manifest kind or compression, a tree that does not add up) is a ValueError
naming the file.
"""
from __future__ import annotations

import os
import struct
import time
import uuid

from salsa_tpu_torch.train import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
MISSING = 2**64 - 1  # the root offset of an empty tree
# what orbax's stores are configured with
MAX_INLINE_VALUE_BYTES = 1024
MAX_DECODED_NODE_BYTES = 100_000_000
VERSION_TREE_ARITY_LOG2 = 4


def _crc32c_table() -> list[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli) of `data`."""
    crc, table = 0xFFFFFFFF, _CRC_TABLE
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


class _Reader:
    def __init__(self, buf: bytes, what: str):
        self.buf, self.pos, self.what = buf, 0, what

    def fail(self, msg: str) -> ValueError:
        return ValueError(f"{self.what}: {msg}")

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.buf):
            raise self.fail("truncated body")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def varint(self) -> int:
        value, shift = 0, 0
        while True:
            b = self.u8()
            value |= (b & 0x7F) << shift
            if b < 0x80:
                return value
            shift += 7
            if shift > 63:
                raise self.fail("varint longer than 64 bits")

    def varints(self, n: int) -> list[int]:
        return [self.varint() for _ in range(n)]

    def end(self) -> None:
        if self.pos != len(self.buf):
            raise self.fail(f"{len(self.buf) - self.pos} bytes after the body")


def decode(blob: bytes, magic: int, what: str) -> bytes:
    """The body of an encoded manifest or node, its header and CRC checked."""
    if len(blob) < 18:
        raise ValueError(f"{what}: {len(blob)} bytes, too short for an OCDBT header")
    got = struct.unpack(">I", blob[:4])[0]
    if got != magic:
        raise ValueError(f"{what}: magic 0x{got:08x}, expected 0x{magic:08x}")
    length = int.from_bytes(blob[4:12], "little")
    if length != len(blob):
        raise ValueError(f"{what}: header length {length}, the encoding has {len(blob)} bytes")
    crc = int.from_bytes(blob[-4:], "little")
    if crc32c(blob[:-4]) != crc:
        raise ValueError(f"{what}: CRC-32C does not match")
    r = _Reader(blob[:-4], what)
    r.pos = 12
    version = r.varint()
    if version != 0:
        raise ValueError(f"{what}: OCDBT format version {version}, only 0 is read")
    compression = r.varint()
    body = blob[r.pos:-4]
    if compression == 0:
        return body
    if compression == 1:
        return bytes(zstd.decompress(body, what=what))
    raise ValueError(f"{what}: compression format {compression} is neither none nor zstd")


def encode(body: bytes, magic: int) -> bytes:
    """`body` encoded with zstd (raw blocks) as a manifest or node."""
    payload = b"\x00\x01" + zstd.compress_raw(body)  # version 0, zstd
    head = struct.pack(">I", magic) + (12 + len(payload) + 4).to_bytes(8, "little")
    blob = head + payload
    return blob + crc32c(blob).to_bytes(4, "little")


def _read_table(r: _Reader, base: str) -> list[tuple[str, str]]:
    """A data-file table: [(base path, full path)] relative to the store."""
    n = r.varint()
    prefix = [0] + r.varints(max(n - 1, 0))
    suffix, base_len = r.varints(n), r.varints(n)
    out, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            raise r.fail("data-file path prefix longer than the previous path")
        path = prev[:prefix[i]] + r.take(suffix[i])
        if base_len[i] > len(path):
            raise r.fail("data-file base path longer than its path")
        prev = path
        text = path.decode()
        out.append((base + text[:base_len[i]], base + text))
    return out


def _file(r: _Reader, table, file_id: int) -> tuple[str, str]:
    if file_id >= len(table):
        raise r.fail(f"data file {file_id} is not in the table of {len(table)}")
    return table[file_id]


class OcdbtStore:
    """The newest version of the OCDBT store at `root`: `keys()` in order and
    `read(key)`."""

    def __init__(self, root: str):
        self.root = root
        self._files: dict[str, bytes] = {}
        what = os.path.join(root, "manifest.ocdbt")
        with open(what, "rb") as f:
            r = _Reader(decode(f.read(), MANIFEST_MAGIC, what), what)
        r.take(16)  # uuid
        kind = r.varint()
        if kind != 0:
            raise r.fail(f"manifest kind {kind}: only a single manifest (0) is read")
        r.varints(2)  # max_inline_value_bytes, max_decoded_node_bytes
        r.u8()  # version_tree_arity_log2
        method = r.varint()
        if method == 1:
            r.take(4)  # zstd level
        elif method != 0:
            raise r.fail(f"compression method {method} is neither none nor zstd")
        table = _read_table(r, "")
        n = r.varint()
        gens, heights = r.varints(n), list(r.take(n))
        files, offsets, lengths = r.varints(n), r.varints(n), r.varints(n)
        r.varints(3 * n)  # statistics: keys, tree bytes, indirect value bytes
        r.take(8 * n)  # commit times
        m = r.varint()
        r.varints(5 * m)  # version-tree nodes of older versions: generation, file,
        r.take(9 * m)  # offset, length, generations; commit time and height
        r.end()
        if not n:
            raise r.fail("no version")
        if gens != sorted(gens):
            raise r.fail("versions out of generation order")
        self.generation, self.height = gens[-1], heights[-1]
        self._values: dict[bytes, bytes | tuple[str, int, int]] = {}
        if offsets[-1] != MISSING:
            self._node(_file(r, table, files[-1]), offsets[-1], lengths[-1], heights[-1], b"")
        self._keys = sorted(self._values)

    def _data(self, path: str) -> bytes:
        if path not in self._files:
            with open(os.path.join(self.root, path), "rb") as f:
                self._files[path] = f.read()
        return self._files[path]

    def _slice(self, path: str, offset: int, length: int, what: str) -> bytes:
        data = self._data(path)
        if offset + length > len(data):
            raise ValueError(f"{what}: [{offset}, {offset + length}) is past the end of "
                             f"{os.path.join(self.root, path)} ({len(data)} bytes)")
        return data[offset:offset + length]

    def _node(self, file: tuple[str, str], offset: int, length: int, height: int,
              prefix: bytes) -> None:
        base, path = file
        what = f"{os.path.join(self.root, path)} node at {offset}"
        r = _Reader(decode(self._slice(path, offset, length, what), NODE_MAGIC, what), what)
        if r.u8() != height:
            raise r.fail(f"height does not match its parent's ({height})")
        table = _read_table(r, base)
        n = r.varint()
        shared = [0] + r.varints(max(n - 1, 0))
        suffix = r.varints(n)
        common = r.varints(n) if height else []
        keys, prev = [], b""
        for i in range(n):
            if shared[i] > len(prev):
                raise r.fail("key prefix longer than the previous key")
            prev = prev[:shared[i]] + r.take(suffix[i])
            keys.append(prev)
        if height == 0:
            sizes, kinds = r.varints(n), list(r.take(n))
            indirect = [i for i in range(n) if kinds[i] == 1]
            if len(indirect) + kinds.count(0) != n:
                raise r.fail("value kind neither inline (0) nor indirect (1)")
            files, offs = r.varints(len(indirect)), r.varints(len(indirect))
            for i, f, o in zip(indirect, files, offs):
                self._values[prefix + keys[i]] = (_file(r, table, f)[1], o, sizes[i])
            for i in range(n):
                if kinds[i] == 0:
                    self._values[prefix + keys[i]] = r.take(sizes[i])
            r.end()
            return
        files, offs, lens = r.varints(n), r.varints(n), r.varints(n)
        r.varints(3 * n)  # statistics
        r.end()
        for i in range(n):
            if common[i] > len(keys[i]):
                raise r.fail("subtree prefix longer than its key")
            self._node(_file(r, table, files[i]), offs[i], lens[i], height - 1,
                       prefix + keys[i][:common[i]])

    def keys(self) -> list[bytes]:
        return list(self._keys)

    def __contains__(self, key: bytes) -> bool:
        return key in self._values

    def read(self, key: bytes) -> bytes:
        value = self._values[key]
        if isinstance(value, bytes):
            return value
        path, offset, length = value
        return self._slice(path, offset, length, f"value of {key!r}")


def _varints(values) -> bytes:
    out = bytearray()
    for v in values:
        while v >= 0x80:
            out.append((v & 0x7F) | 0x80)
            v >>= 7
        out.append(v)
    return bytes(out)


def _table(paths: list[tuple[str, str]]) -> bytes:
    """A data-file table of [(base path, relative path)]."""
    full = [(b + r).encode() for b, r in paths]
    shared = []
    for prev, cur in zip(full, full[1:]):
        k = 0
        while k < min(len(prev), len(cur)) and prev[k] == cur[k]:
            k += 1
        shared.append(k)
    suffixes = full[:1] + [cur[k:] for cur, k in zip(full[1:], shared)]
    return (_varints([len(full)]) + _varints(shared) + _varints(map(len, suffixes))
            + _varints(len(b.encode()) for b, _ in paths) + b"".join(suffixes))


def write_values(root: str, items: dict[bytes, bytes]) -> dict[bytes, bytes | tuple]:
    """The values of `items` longer than MAX_INLINE_VALUE_BYTES in one data file
    `<root>/d/<hex>`; returns {key: the value itself, or ("d/<hex>", offset, length)}."""
    name = f"d/{uuid.uuid4().hex}"
    refs, chunks, offset = {}, [], 0
    for key in sorted(items):
        value = bytes(items[key])
        if len(value) <= MAX_INLINE_VALUE_BYTES:
            refs[key] = value
        else:
            refs[key] = (name, offset, len(value))
            chunks.append(value)
            offset += len(value)
    os.makedirs(os.path.join(root, "d"), exist_ok=True)
    with open(os.path.join(root, name), "wb") as f:
        f.writelines(chunks)
    return refs


def write_version(root: str, refs: dict[bytes, bytes | tuple], base: str = "") -> None:
    """Generation 1 of a store at `root` holding `refs` (from `write_values`, its
    data file under `<root>/<base>`) in one leaf node `<root>/d/<hex>`, and
    `<root>/manifest.ocdbt`."""
    keys = sorted(refs)
    if not keys:
        raise ValueError("an OCDBT store of no key is not written")
    shared = [0]
    for prev, cur in zip(keys, keys[1:]):
        k = 0
        while k < min(len(prev), len(cur)) and prev[k] == cur[k]:
            k += 1
        shared.append(k)
    data_files = sorted({refs[k][0] for k in keys if isinstance(refs[k], tuple)})
    ids = {p: i for i, p in enumerate(data_files)}
    indirect = [refs[k] for k in keys if isinstance(refs[k], tuple)]
    inline = [refs[k] for k in keys if isinstance(refs[k], bytes)]
    body = b"".join([
        b"\x00", _table([(base, p) for p in data_files]), _varints([len(keys)]),
        _varints(shared[1:]), _varints(len(k) - s for k, s in zip(keys, shared)),
        b"".join(k[s:] for k, s in zip(keys, shared)),
        _varints(len(v) if isinstance(v, bytes) else v[2] for v in map(refs.get, keys)),
        bytes(int(isinstance(refs[k], tuple)) for k in keys),
        _varints(ids[v[0]] for v in indirect), _varints(v[1] for v in indirect),
        b"".join(inline)])
    if len(body) > MAX_DECODED_NODE_BYTES:
        raise ValueError(f"{root}: a leaf node of {len(body)} bytes is larger than "
                         f"{MAX_DECODED_NODE_BYTES}")
    node = encode(body, NODE_MAGIC)
    name = f"d/{uuid.uuid4().hex}"
    os.makedirs(os.path.join(root, "d"), exist_ok=True)
    with open(os.path.join(root, name), "wb") as f:
        f.write(node)
    manifest = b"".join([
        uuid.uuid4().bytes, _varints([0, MAX_INLINE_VALUE_BYTES, MAX_DECODED_NODE_BYTES]),
        bytes([VERSION_TREE_ARITY_LOG2]), b"\x01", struct.pack("<i", 0),  # zstd, level 0
        _table([("", name)]),
        _varints([1, 1]), b"\x00",  # one version: generation 1, root height 0
        _varints([0, 0, len(node), len(keys), len(node), sum(v[2] for v in indirect)]),
        time.time_ns().to_bytes(8, "little"), b"\x00"])  # commit time; no version tree
    with open(os.path.join(root, "manifest.ocdbt"), "wb") as f:
        f.write(encode(manifest, MANIFEST_MAGIC))


def write(root: str, items: dict[bytes, bytes]) -> None:
    """A new store at `root` of one version holding `items`."""
    write_version(root, write_values(root, items))
