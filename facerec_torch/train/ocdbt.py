"""A read-only reader of OCDBT key-value stores, the format orbax writes its
checkpoint trees in (tensorstore's "optionally cooperative distributed
B+tree"). Writing is out of scope: the port's trainer writes ``state.pt``.

    store = ocdbt.open("outputs/checkpoints/arcface_synth/best")
    store.keys()                      # ['batch_stats.backbone.bn1.mean/.zarray', ...]
    store.read("params.arc_weight/0.0")

Every structure file (the manifest and each B+tree node, a whole file or a
byte range of one) is framed the same way:

    magic            u32 big-endian: 0x0cdb3a2a manifest, 0x0cdb20de B+tree node
    length           u64 little-endian, the whole frame
    version          varint (0)
    compression      varint (0 none, 1 zstd)
    body             the rest, zstd-compressed when compression is 1
    crc32c           u32 little-endian, CRC-32C over every byte before it

and every frame's magic, length and checksum are checked before its body is
read. Bodies are columns of varints: a field of all ``n`` entries, then the
next field. Key and path lists store the first item whole and each later
one as the length it shares with the one before plus its own suffix
(``_prefixed``). Data-file paths (``base_path + relative_path``) are
relative to the database root.

Manifest body: uuid (16 bytes), manifest kind (0 single; the numbered kind,
which keeps its versions in other files, is refused), max inline value
bytes, max decoded node bytes, version-tree arity log2 (a byte), compression
(varint; for zstd an i32 little-endian level), a data-file table, and the
newest versions: generation, root height (byte), root node (file, offset,
length), key count, tree bytes, indirect value bytes, commit time (u64).
Older versions, in version-tree nodes after that, are not read.

B+tree node body: height (byte, 0 for a leaf), a data-file table, the entry
count, and the keys (an interior entry adds the length of the prefix that
every key of its subtree shares; the child stores its keys without it).
A leaf then has each value's length, its kind (0 inline, 1 held in a data
file), the file and offset of each held value, and the inline values
concatenated. An interior node has each child's file, offset and length,
then its key count, tree bytes and indirect value bytes.
"""

from __future__ import annotations

import struct
from pathlib import Path, PurePosixPath

from facerec_torch.utils import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
BTREE_MAGIC = 0x0CDB20DE
MANIFEST_FILE = "manifest.ocdbt"
_HEADER = 12  # magic + length


def _crc32c_table() -> list[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC32C = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli, reflected, as iSCSI and tensorstore use it)."""
    crc = 0xFFFFFFFF
    table = _CRC32C
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


class FormatError(ValueError):
    """The bytes are not a well-formed OCDBT structure."""


class _Cursor:
    def __init__(self, buf: bytes, what: str):
        self.buf, self.pos, self.what = buf, 0, what

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.buf):
            raise FormatError(f"{self.what}: truncated at byte {self.pos}")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def byte(self) -> int:
        return self.take(1)[0]

    def varint(self) -> int:
        out = shift = 0
        while True:
            b = self.byte()
            out |= (b & 0x7F) << shift
            if b < 0x80:
                return out
            shift += 7
            if shift > 63:
                raise FormatError(f"{self.what}: varint longer than 64 bits at {self.pos}")

    def varints(self, n: int) -> list[int]:
        return [self.varint() for _ in range(n)]

    def prefixed(self, n: int, common: bool = False) -> tuple[list[bytes], list[int]]:
        """``n`` prefix-compressed byte strings (and, with ``common``, the
        subtree-prefix length stored after the suffix lengths)."""
        shared = [0] + self.varints(n - 1) if n else []
        suffix = self.varints(n)
        extra = self.varints(n) if common else []
        out: list[bytes] = []
        prev = b""
        for i in range(n):
            if shared[i] > len(prev):
                raise FormatError(f"{self.what}: entry {i} shares more than its predecessor")
            prev = prev[:shared[i]] + self.take(suffix[i])
            out.append(prev)
        return out, extra


def unframe(buf: bytes, magic: int, what: str) -> bytes:
    """The body of one structure file, after checking its magic, length and
    CRC-32C footer."""
    if len(buf) < _HEADER + 2 + 4:
        raise FormatError(f"{what}: {len(buf)} bytes is too short for an OCDBT frame")
    got = struct.unpack_from(">I", buf, 0)[0]
    if got != magic:
        raise FormatError(f"{what}: magic {got:#010x}, expected {magic:#010x}")
    length = struct.unpack_from("<Q", buf, 4)[0]
    if length != len(buf):
        raise FormatError(f"{what}: frame says {length} bytes, holds {len(buf)}")
    want = struct.unpack_from("<I", buf, len(buf) - 4)[0]
    crc = crc32c(buf[:-4])
    if crc != want:
        raise FormatError(f"{what}: CRC-32C {crc:#010x} does not match its footer {want:#010x}")
    cur = _Cursor(buf[:-4], what)
    cur.pos = _HEADER
    version = cur.varint()
    if version != 0:
        raise FormatError(f"{what}: format version {version} is not supported")
    compression = cur.varint()
    body = buf[cur.pos:-4]
    if compression == 0:
        return body
    if compression == 1:
        return zstd.decompress(body)
    raise FormatError(f"{what}: compression method {compression} is not supported")


def _data_files(cur: _Cursor) -> list[str]:
    n = cur.varint()
    shared = [0] + cur.varints(n - 1) if n else []
    suffix = cur.varints(n)
    cur.varints(n)  # base-path lengths: the path is base + relative as one string
    out: list[str] = []
    prev = b""
    for i in range(n):
        prev = prev[:shared[i]] + cur.take(suffix[i])
        out.append(prev.decode())
    return out


class OcdbtStore:
    """The newest version of one OCDBT database, listed once at ``open``:
    its keys and where each value lies (inline bytes, or a byte range of a
    data file under the root)."""

    def __init__(self, root: str | Path):
        self.root = Path(root)
        self._values: dict[bytes, bytes | tuple[str, int, int]] = {}
        self._read_manifest()

    def _path(self, rel: str) -> Path:
        p = PurePosixPath(rel)
        if p.is_absolute() or ".." in p.parts:
            raise FormatError(f"{self.root}: data file path {rel!r} leaves the database")
        return self.root / p

    def _segment(self, rel: str, offset: int, length: int) -> bytes:
        with self._path(rel).open("rb") as f:
            f.seek(offset)
            buf = f.read(length)
        if len(buf) != length:
            raise FormatError(f"{rel}: {length} bytes at {offset} run past the end of the file")
        return buf

    def _read_manifest(self) -> None:
        what = str(self.root / MANIFEST_FILE)
        cur = _Cursor(unframe((self.root / MANIFEST_FILE).read_bytes(), MANIFEST_MAGIC, what),
                      what)
        cur.take(16)  # database uuid
        kind = cur.varint()
        if kind != 0:
            raise FormatError(f"{what}: manifest kind {kind} (numbered) is not supported")
        cur.varint()  # max inline value bytes
        cur.varint()  # max decoded node bytes
        cur.byte()  # version-tree arity log2
        if cur.varint() == 1:
            cur.take(4)  # zstd level
        files = _data_files(cur)
        n = cur.varint()
        generation = cur.varints(n)
        height = [cur.byte() for _ in range(n)]
        fid, offset, length = cur.varints(n), cur.varints(n), cur.varints(n)
        if not n:
            return  # a database with no commit yet
        last = max(range(n), key=generation.__getitem__)
        self._node(files[fid[last]], offset[last], length[last], height[last], b"")

    def _node(self, rel: str, offset: int, length: int, height: int, prefix: bytes) -> None:
        what = f"{rel}@{offset}"
        cur = _Cursor(unframe(self._segment(rel, offset, length), BTREE_MAGIC, what), what)
        got = cur.byte()
        if got != height:
            raise FormatError(f"{what}: node height {got}, its parent expects {height}")
        files = _data_files(cur)
        n = cur.varint()
        keys, common = cur.prefixed(n, common=height > 0)
        if height > 0:
            fid, off, size = cur.varints(n), cur.varints(n), cur.varints(n)
            cur.varints(3 * n)  # key counts, tree bytes, indirect value bytes
            for i in range(n):
                if common[i] > len(keys[i]):
                    raise FormatError(f"{what}: subtree prefix longer than its key")
                self._node(files[fid[i]], off[i], size[i], height - 1,
                           prefix + keys[i][:common[i]])
            return
        size = cur.varints(n)
        kinds = cur.varints(n)
        if any(k > 1 for k in kinds):
            raise FormatError(f"{what}: unknown value kind in {sorted(set(kinds))}")
        held = [i for i in range(n) if kinds[i] == 1]
        fid, off = cur.varints(len(held)), cur.varints(len(held))
        for j, i in enumerate(held):
            self._values[prefix + keys[i]] = (files[fid[j]], off[j], size[i])
        for i in range(n):
            if kinds[i] == 0:
                self._values[prefix + keys[i]] = cur.take(size[i])
        if cur.pos != len(cur.buf):
            raise FormatError(f"{what}: {len(cur.buf) - cur.pos} bytes after the last value")

    def keys(self) -> list[str]:
        """Every key, in byte order."""
        return [k.decode() for k in sorted(self._values)]

    def __contains__(self, key: str | bytes) -> bool:
        return (key.encode() if isinstance(key, str) else key) in self._values

    def read(self, key: str | bytes) -> bytes:
        """The value stored under ``key`` (KeyError when there is none)."""
        v = self._values[key.encode() if isinstance(key, str) else key]
        return v if isinstance(v, bytes) else self._segment(*v)


def open(path: str | Path) -> OcdbtStore:  # noqa: A001 - the module's entry point
    """Parse the manifest under ``path`` and walk the newest version's
    B+tree."""
    return OcdbtStore(path)
