"""The OCDBT key-value store of orbax checkpoint directories, without
tensorstore.

Orbax writes a checkpoint's arrays through tensorstore's ``ocdbt`` kvstore:
an append-only b-tree of keys and values in a directory. Its on-disk form,
as tensorstore 0.1.80 writes and reads it:

* every manifest and b-tree node is one *encoded object*: a 4-byte magic
  (big-endian ``0x0cdb3a2a`` for a manifest, ``0x0cdb20de`` for a node),
  the object's whole length (u64, little-endian), a format version varint
  (0), a compression varint (0 = none, 1 = zstd), the body (one zstd frame
  when compressed) and the crc32c (Castagnoli) of everything before it
  (u32, little-endian);
* ``manifest.ocdbt`` holds the config (a 16-byte uuid, the manifest kind,
  ``max_inline_value_bytes``, ``max_decoded_node_bytes``, the version
  tree's arity log2 as a byte, the compression method and, for zstd, its
  level as an int32), a data-file table and the newest versions: their
  generation numbers, root heights, root node references (data file,
  offset, length) and statistics (keys, node bytes, out-of-line value
  bytes), and commit times (u64 nanoseconds), each field stored for all
  versions before the next field; older versions sit in version-tree
  nodes the reader does not need;
* a data-file table is a count, each path's prefix shared with the one
  before it (from the second path on), each path's suffix length, each
  path's base-path length, then the suffixes; paths are relative to the
  store's directory (``d/<32 hex>``, ``ocdbt.process_0/d/<32 hex>``);
* a b-tree node holds its height (a byte), a data-file table, the entry
  count, the keys prefix-compressed against the key before (prefix
  lengths from the second entry on, suffix lengths, for interior nodes the
  length of the key's part every key of the child shares, then the
  suffixes); a leaf then holds each value's length, each value's kind
  (0 inline, 1 in a data file), each out-of-line value's data file and
  offset, and the inline values; an interior node each child's data file,
  offset, length and statistics. Keys in a node omit the prefix its
  ancestors' entries stripped;
* an out-of-line value is raw bytes at an offset of a data file.

Every length is a LEB128 varint unless said otherwise. ``Reader`` takes
what orbax writes (several processes' data files merged under one root
manifest, inline and out-of-line values, interior nodes) and verifies the
crc32c of every manifest and node it reads. ``write_store`` writes the
smallest store tensorstore reads: one version whose root is one leaf,
values above ``max_inline_value_bytes`` ahead of the leaf in one data file.
A feature the reader does not take (numbered manifests, another format
version or compression) raises a ``ValueError`` naming it.
"""

from __future__ import annotations

import os
import struct
import time
import uuid as _uuid
from typing import Dict, Iterator, List, Optional, Tuple, Union

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
MANIFEST = "manifest.ocdbt"
#: orbax's config: values up to 1 KiB sit in the node, nodes up to 100 MB
MAX_INLINE_VALUE_BYTES = 1024
MAX_DECODED_NODE_BYTES = 100_000_000
VERSION_TREE_ARITY_LOG2 = 4
#: the writer's zstd level for manifests and nodes (0: zstd's default, as
#: tensorstore's config has it)
ZSTD_LEVEL = 0
#: a node reference's offset and length when the tree is empty
_MISSING = (1 << 64) - 1


# --------------------------------------------------------------------------- #
# crc32c and varints
# --------------------------------------------------------------------------- #

def _crc_table() -> List[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc_table()


def crc32c(data: Union[bytes, bytearray, memoryview], crc: int = 0) -> int:
    """CRC-32C (Castagnoli, reflected polynomial 0x82F63B78)."""
    t = _CRC_TABLE
    c = crc ^ 0xFFFFFFFF
    for b in bytes(data):
        c = t[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def _put_varint(out: bytearray, v: int) -> None:
    if v < 0:
        raise ValueError(f"varint of a negative number {v}")
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)


class _Cursor:
    """Reads varints, fixed-width integers and byte runs from ``buf``."""

    def __init__(self, buf: bytes, what: str) -> None:
        self.buf, self.pos, self.what = buf, 0, what

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.buf):
            raise ValueError(f"{self.what}: truncated")
        b = self.buf[self.pos:self.pos + n]
        self.pos += n
        return b

    def varint(self) -> int:
        v = shift = 0
        while True:
            if self.pos >= len(self.buf):
                raise ValueError(f"{self.what}: truncated varint")
            b = self.buf[self.pos]
            self.pos += 1
            v |= (b & 0x7F) << shift
            if b < 0x80:
                return v
            shift += 7
            if shift > 63:
                raise ValueError(f"{self.what}: varint longer than 64 bits")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def u8(self) -> int:
        return self.take(1)[0]

    def fixed(self, fmt: str) -> int:
        return struct.unpack("<" + fmt, self.take(struct.calcsize(fmt)))[0]


# --------------------------------------------------------------------------- #
# encoded objects
# --------------------------------------------------------------------------- #

def decode_object(data: bytes, magic: int, what: str) -> bytes:
    """The body of one encoded object (``data`` is exactly the object)."""
    if len(data) < 16:
        raise ValueError(f"{what}: {len(data)} bytes, too short for an "
                         "OCDBT object")
    got_magic, length = struct.unpack_from(">I", data, 0)[0], \
        struct.unpack_from("<Q", data, 4)[0]
    if got_magic != magic:
        raise ValueError(f"{what}: magic 0x{got_magic:08x}, expected "
                         f"0x{magic:08x}")
    if length != len(data):
        raise ValueError(f"{what}: the header says {length} bytes, "
                         f"{len(data)} were read")
    want = struct.unpack_from("<I", data, length - 4)[0]
    got = crc32c(memoryview(data)[:length - 4])
    if got != want:
        raise ValueError(f"{what}: crc32c 0x{got:08x} does not match the "
                         f"stored 0x{want:08x}")
    c = _Cursor(data[:length - 4], what)
    c.pos = 12
    version, compression = c.varint(), c.varint()
    if version != 0:
        raise ValueError(f"{what}: OCDBT format version {version} is not "
                         "supported (only 0)")
    body = data[c.pos:length - 4]
    if compression == 0:
        return body
    if compression == 1:
        from . import zstd

        return zstd.decompress(body)
    raise ValueError(f"{what}: compression format {compression} is not "
                     "supported (0 none, 1 zstd)")


def encode_object(body: bytes, magic: int) -> bytes:
    """``body`` as one encoded object, a zstd frame at ``ZSTD_LEVEL``."""
    from . import zstd

    head = bytearray()
    _put_varint(head, 0)  # format version
    _put_varint(head, 1)  # zstd
    payload = zstd.compress(body, ZSTD_LEVEL)
    length = 12 + len(head) + len(payload) + 4
    out = bytearray(struct.pack(">I", magic) + struct.pack("<Q", length))
    out += head
    out += payload
    out += struct.pack("<I", crc32c(out))
    return bytes(out)


def _read_table(c: _Cursor) -> List[str]:
    n = c.varint()
    prefix = [0] + c.varints(max(n - 1, 0))
    suffix = c.varints(n)
    c.varints(n)  # base-path lengths: the paths are read whole
    paths: List[str] = []
    prev = b""
    for p, s in zip(prefix, suffix):
        if p > len(prev):
            raise ValueError(f"{c.what}: data-file path prefix {p} is longer "
                             "than the path before it")
        prev = prev[:p] + c.take(s)
        paths.append(prev.decode("utf-8"))
    return paths


def _write_table(out: bytearray, paths: List[str]) -> None:
    raw = [p.encode("utf-8") for p in paths]
    _put_varint(out, len(raw))
    prefixes = [0] + [_common(a, b) for a, b in zip(raw, raw[1:])]
    for p in prefixes[1:]:
        _put_varint(out, p)
    for r, p in zip(raw, prefixes):
        _put_varint(out, len(r) - p)
    for _ in raw:
        _put_varint(out, 0)
    for r, p in zip(raw, prefixes):
        out += r[p:]


def _common(a: bytes, b: bytes) -> int:
    n = min(len(a), len(b))
    i = 0
    while i < n and a[i] == b[i]:
        i += 1
    return i


# --------------------------------------------------------------------------- #
# the reader
# --------------------------------------------------------------------------- #

#: a value: inline bytes, or (data file path, offset, length)
ValueRef = Union[bytes, Tuple[str, int, int]]


class Reader:
    """The newest version of the OCDBT store in directory ``root``: its keys
    (``list``) and values (``read``). The whole b-tree is walked when the
    reader opens; out-of-line values are read on demand."""

    def __init__(self, root: str) -> None:
        self.root = root
        body = decode_object(self._file(MANIFEST), MANIFEST_MAGIC,
                             os.path.join(root, MANIFEST))
        c = _Cursor(body, os.path.join(root, MANIFEST))
        c.take(16)  # the store's uuid
        kind = c.varint()
        if kind != 0:
            raise ValueError(f"{c.what}: manifest kind {kind} (numbered "
                             "manifests) is not supported, only a single "
                             "manifest")
        self.max_inline_value_bytes = c.varint()
        c.varint()  # max_decoded_node_bytes
        c.u8()  # version_tree_arity_log2
        method = c.varint()
        if method == 1:
            c.fixed("i")  # the writer's zstd level
        elif method != 0:
            raise ValueError(f"{c.what}: compression method {method} is not "
                             "supported (0 none, 1 zstd)")
        paths = _read_table(c)
        n = c.varint()
        if n == 0:
            raise ValueError(f"{c.what}: the manifest holds no version")
        gens = c.varints(n)
        heights = [c.u8() for _ in range(n)]
        files, offsets, lengths = c.varints(n), c.varints(n), c.varints(n)
        c.varints(3 * n)  # statistics: keys, node bytes, value bytes
        c.take(8 * n)  # commit times
        i = max(range(n), key=gens.__getitem__)
        self._refs: Dict[bytes, ValueRef] = {}
        if offsets[i] != _MISSING:
            self._walk(paths[files[i]], offsets[i], lengths[i], heights[i], b"")
        self._keys = sorted(self._refs)

    def _file(self, rel: str, offset: int = 0,
              length: Optional[int] = None) -> bytes:
        path = os.path.join(self.root, rel)
        with open(path, "rb") as f:
            f.seek(offset)
            data = f.read() if length is None else f.read(length)
        if length is not None and len(data) != length:
            raise ValueError(f"{path}: {length} bytes at {offset} asked, "
                             f"{len(data)} there")
        return data

    def _walk(self, rel: str, offset: int, length: int, height: int,
              prefix: bytes) -> None:
        what = f"{os.path.join(self.root, rel)}@{offset}"
        body = decode_object(self._file(rel, offset, length), NODE_MAGIC, what)
        c = _Cursor(body, what)
        got = c.u8()
        if got != height:
            raise ValueError(f"{what}: node height {got}, its parent says "
                             f"{height}")
        paths = _read_table(c)
        n = c.varint()
        pre = [0] + c.varints(max(n - 1, 0))
        suf = c.varints(n)
        common = c.varints(n) if height else None
        keys: List[bytes] = []
        prev = b""
        for p, s in zip(pre, suf):
            prev = prev[:p] + c.take(s)
            keys.append(prev)
        if height:
            files, offs, lens = c.varints(n), c.varints(n), c.varints(n)
            c.varints(3 * n)  # statistics
            for k, cp, f, o, ln in zip(keys, common, files, offs, lens):
                self._walk(paths[f], o, ln, height - 1, prefix + k[:cp])
            return
        vlens = c.varints(n)
        kinds = c.varints(n)
        bad = set(kinds) - {0, 1}
        if bad:
            raise ValueError(f"{what}: value kinds {sorted(bad)} are not "
                             "supported (0 inline, 1 out of line)")
        n_out = kinds.count(1)
        files, offs = c.varints(n_out), c.varints(n_out)
        j = 0
        for k, ln, kind in zip(keys, vlens, kinds):
            if kind:
                self._refs[prefix + k] = (paths[files[j]], offs[j], ln)
                j += 1
            else:
                self._refs[prefix + k] = c.take(ln)

    def list(self) -> List[bytes]:
        """Every key, sorted."""
        return list(self._keys)

    def read(self, key: Union[bytes, str]) -> Optional[bytes]:
        """The value of ``key``; None when the store has no such key."""
        ref = self._refs.get(_key(key))
        if ref is None or isinstance(ref, bytes):
            return ref
        return self._file(*ref)

    def items(self) -> Iterator[Tuple[bytes, bytes]]:
        for k in self._keys:
            yield k, self.read(k)


def _key(key: Union[bytes, str]) -> bytes:
    return key.encode("utf-8") if isinstance(key, str) else bytes(key)


# --------------------------------------------------------------------------- #
# the writer
# --------------------------------------------------------------------------- #

def _write_leaf(root: str, rel: str, entries: List[Tuple[bytes, bytes]]
                ) -> Tuple[int, int, int, int]:
    """Write data file ``rel`` under ``root``: the values above
    ``MAX_INLINE_VALUE_BYTES``, then one leaf node of every entry. Returns
    the leaf's (offset, length, node bytes, out-of-line value bytes)."""
    data = bytearray()
    out_of_line: List[int] = []
    for _, v in entries:
        if len(v) > MAX_INLINE_VALUE_BYTES:
            out_of_line.append(len(data))
            data += v
    value_bytes = len(data)
    node = bytearray([0])  # height 0
    _write_table(node, [rel] if out_of_line else [])
    _put_varint(node, len(entries))
    keys = [k for k, _ in entries]
    prefixes = [0] + [_common(a, b) for a, b in zip(keys, keys[1:])]
    for p in prefixes[1:]:
        _put_varint(node, p)
    for k, p in zip(keys, prefixes):
        _put_varint(node, len(k) - p)
    for k, p in zip(keys, prefixes):
        node += k[p:]
    for _, v in entries:
        _put_varint(node, len(v))
    for _, v in entries:
        _put_varint(node, int(len(v) > MAX_INLINE_VALUE_BYTES))
    for _ in out_of_line:
        _put_varint(node, 0)  # the data file: the table's only one
    for off in out_of_line:
        _put_varint(node, off)
    for _, v in entries:
        if len(v) <= MAX_INLINE_VALUE_BYTES:
            node += v
    if len(node) > MAX_DECODED_NODE_BYTES:
        raise ValueError(f"write_store: one leaf of {len(node)} bytes "
                         f"exceeds max_decoded_node_bytes "
                         f"{MAX_DECODED_NODE_BYTES}")
    leaf = encode_object(bytes(node), NODE_MAGIC)
    offset = len(data)
    data += leaf
    with open(os.path.join(root, rel), "wb") as f:
        f.write(data)
    return offset, len(leaf), len(leaf), value_bytes


def write_store(root: str, items: Dict[Union[bytes, str], bytes]) -> None:
    """Write ``items`` as a new OCDBT store in directory ``root`` (made if
    missing; it must not hold a store yet): one version, its root one leaf
    node in ``d/<uuid>`` after the values above ``MAX_INLINE_VALUE_BYTES``.
    Nodes and the manifest are zstd frames, as tensorstore writes them."""
    entries = sorted((_key(k), bytes(v)) for k, v in items.items())
    if os.path.exists(os.path.join(root, MANIFEST)):
        raise ValueError(f"write_store: {root} already holds a store")
    os.makedirs(os.path.join(root, "d"), exist_ok=True)
    if entries:
        rel = f"d/{_uuid.uuid4().hex}"
        root_ref = _write_leaf(root, rel, entries)
    else:  # an empty tree: a root reference to no node, as tensorstore's
        rel, root_ref = "", (_MISSING, _MISSING, 0, 0)
    m = bytearray(_uuid.uuid4().bytes)
    for v in (0, MAX_INLINE_VALUE_BYTES, MAX_DECODED_NODE_BYTES):
        _put_varint(m, v)  # a single manifest, orbax's limits
    m.append(VERSION_TREE_ARITY_LOG2)
    _put_varint(m, 1)  # zstd
    m += struct.pack("<i", ZSTD_LEVEL)
    _write_table(m, [rel])
    offset, length, tree_bytes, value_bytes = root_ref
    _put_varint(m, 1)  # one version: generation 1, its root a leaf
    _put_varint(m, 1)
    m.append(0)
    for v in (0, offset, length, len(entries), tree_bytes, value_bytes):
        _put_varint(m, v)
    m += struct.pack("<Q", time.time_ns())
    _put_varint(m, 0)  # no version-tree nodes
    with open(os.path.join(root, MANIFEST), "wb") as f:
        f.write(encode_object(bytes(m), MANIFEST_MAGIC))
