"""SSTable — immutable sorted table segment for the disk engine.

The on-disk unit of storage/engine.py, shaped like the reference's RocksDB
data files (PAPER.md §1 layer 5): rows from every table live in ONE sorted
key space (`<table>\\x00<key>`), cut into block-aligned data blocks with
prefix-compressed keys, addressed through a sparse index (first key + file
offset per block) and guarded by a per-segment bloom filter so negative
lookups skip the file without touching disk. A footer carries the metadata
sections (index, bloom, table-name set) under one CRC; a segment is only
ever referenced by the engine's manifest AFTER it has been fully written
and fsynced, so a reader never sees a torn file in normal operation and a
corrupt footer is detected, not silently served.

File layout (all little-endian):

    [data block]*                      entries, prefix-compressed
    [index]    u32 n, n*(u32 klen, first_key, u64 off, u32 blen)
    [bloom]    u64 nbits, u32 nhashes, ceil(nbits/8) bytes
    [tables]   u32 n, n*(u16 len, utf8 name)
    [footer]   u64 index_off, u64 bloom_off, u64 tables_off,
               u64 nrecords, u32 crc32(index..tables), 8s magic

    block entry: uvarint shared, uvarint unshared, u8 flag(1=tombstone),
                 uvarint vlen, key_suffix, value
"""

from __future__ import annotations

import bisect
import hashlib
import os
import struct
import threading
import zlib
from typing import Iterable, Iterator, Optional

from ..analysis import lockcheck as _lc
from ..utils import failpoints as _fp

MAGIC = b"FBTPUSST"
_FOOTER = struct.Struct("<QQQQI8s")
DEFAULT_BLOCK_BYTES = 4096
BLOOM_BITS_PER_KEY = 10
BLOOM_HASHES = 7

_fp.register("storage.sstable.write")

# composite-key plumbing shared with the engine: one sorted key space for
# every table, `<table>\x00<key>` — NUL never appears in table names (they
# are short ASCII identifiers; asserted at write time)
SEP = b"\x00"


def composite_key(table: str, key: bytes) -> bytes:
    tb = table.encode()
    assert SEP not in tb, f"table name {table!r} contains NUL"
    return tb + SEP + key


def split_key(ck: bytes) -> tuple[str, bytes]:
    table, _, key = ck.partition(SEP)
    return table.decode(), key


# -- varint ----------------------------------------------------------------
def _write_uvarint(parts: list, n: int) -> None:
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            parts.append(bytes((b | 0x80,)))
        else:
            parts.append(bytes((b,)))
            return


def _read_uvarint(buf: bytes, off: int) -> tuple[int, int]:
    n = shift = 0
    while True:
        b = buf[off]
        off += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, off
        shift += 7


# -- bloom -----------------------------------------------------------------
def _bloom_hashes(key: bytes) -> tuple[int, int]:
    d = hashlib.blake2b(key, digest_size=16).digest()
    return (int.from_bytes(d[:8], "little"),
            int.from_bytes(d[8:], "little") | 1)


class BloomFilter:
    __slots__ = ("nbits", "k", "bits")

    def __init__(self, nbits: int, k: int = BLOOM_HASHES,
                 bits: Optional[bytearray] = None):
        self.nbits = max(8, nbits)
        self.k = k
        self.bits = bits if bits is not None else \
            bytearray((self.nbits + 7) // 8)

    def add(self, key: bytes) -> None:
        h1, h2 = _bloom_hashes(key)
        for i in range(self.k):
            bit = (h1 + i * h2) % self.nbits
            self.bits[bit >> 3] |= 1 << (bit & 7)

    def may_contain(self, key: bytes) -> bool:
        h1, h2 = _bloom_hashes(key)
        for i in range(self.k):
            bit = (h1 + i * h2) % self.nbits
            if not self.bits[bit >> 3] & (1 << (bit & 7)):
                return False
        return True

    def encode(self) -> bytes:
        return struct.pack("<QI", self.nbits, self.k) + bytes(self.bits)

    @classmethod
    def decode(cls, data: bytes) -> "BloomFilter":
        nbits, k = struct.unpack_from("<QI", data, 0)
        return cls(nbits, k, bytearray(data[12:]))


# -- writer ----------------------------------------------------------------
def write_sstable(path: str,
                  items: Iterable[tuple[bytes, int, bytes]],
                  block_bytes: int = DEFAULT_BLOCK_BYTES) -> dict:
    """Write `items` — (composite_key, flag, value) in STRICTLY increasing
    key order — to `path` (via `.tmp` + rename) and fsync everything.
    Returns {records, bytes, tables}. Tombstones (flag=1) are stored so a
    newer segment can shadow an older one's rows.
    """
    _lc.note_blocking("fsync", "write_sstable")
    _fp.fire("storage.sstable.write")
    tmp = path + ".tmp"
    index: list[tuple[bytes, int, int]] = []
    tables: set[str] = set()
    keys: list[bytes] = []
    nrecords = 0
    with open(tmp, "wb") as f:
        block: list[bytes] = []
        block_first: Optional[bytes] = None
        block_len = 0
        prev_key: Optional[bytes] = None
        off = 0

        def emit_block() -> None:
            nonlocal block, block_first, block_len, off
            if not block:
                return
            data = b"".join(block)
            index.append((block_first, off, len(data)))
            f.write(data)
            off += len(data)
            block, block_first, block_len = [], None, 0

        for ck, flag, value in items:
            if prev_key is not None and ck <= prev_key:
                raise ValueError("sstable items out of order")
            keys.append(ck)
            tables.add(split_key(ck)[0])
            nrecords += 1
            if block_first is None:
                shared = 0
                block_first = ck
            else:
                maxs = min(len(prev_key), len(ck))
                shared = 0
                while shared < maxs and prev_key[shared] == ck[shared]:
                    shared += 1
            parts: list[bytes] = []
            _write_uvarint(parts, shared)
            _write_uvarint(parts, len(ck) - shared)
            parts.append(bytes((flag,)))
            _write_uvarint(parts, len(value))
            parts.append(ck[shared:])
            parts.append(value)
            ent = b"".join(parts)
            block.append(ent)
            block_len += len(ent)
            prev_key = ck
            if block_len >= block_bytes:
                emit_block()
        emit_block()

        bloom = BloomFilter(max(8, len(keys) * BLOOM_BITS_PER_KEY))
        for k in keys:
            bloom.add(k)

        index_off = off
        iparts = [struct.pack("<I", len(index))]
        for first, boff, blen in index:
            iparts.append(struct.pack("<I", len(first)))
            iparts.append(first)
            iparts.append(struct.pack("<QI", boff, blen))
        bloom_off = index_off + sum(len(p) for p in iparts)
        bparts = [bloom.encode()]
        tables_off = bloom_off + len(bparts[0])
        tparts = [struct.pack("<I", len(tables))]
        for t in sorted(tables):
            tb = t.encode()
            tparts.append(struct.pack("<H", len(tb)))
            tparts.append(tb)
        meta = b"".join(iparts) + b"".join(bparts) + b"".join(tparts)
        f.write(meta)
        f.write(_FOOTER.pack(index_off, bloom_off, tables_off, nrecords,
                             zlib.crc32(meta), MAGIC))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    # the rename must be durable before the manifest references the file
    dirfd = os.open(os.path.dirname(path) or ".", os.O_RDONLY)
    try:
        os.fsync(dirfd)
    finally:
        os.close(dirfd)
    return {"records": nrecords, "bytes": os.path.getsize(path),
            "tables": sorted(tables)}


# -- reader ----------------------------------------------------------------
class CorruptSSTable(ValueError):
    pass


class SSTableReader:
    """Thread-safe reader: metadata in RAM, data blocks via os.pread (no
    shared file-position state), tiny decoded-block LRU for scans."""

    BLOCK_CACHE = 32

    def __init__(self, path: str):
        self.path = path
        self._fd = os.open(path, os.O_RDONLY)
        self.file_bytes = os.fstat(self._fd).st_size
        try:
            self._load_meta()
        except Exception:
            os.close(self._fd)
            raise
        self._cache: dict[int, list] = {}
        self._cache_order: list[int] = []
        self._cache_lock = threading.Lock()
        self.pins = 0  # long scans pin the reader against graveyard close
        self._last_key: Optional[bytes] = None  # lazily decoded

    @property
    def first_key(self) -> bytes:
        """Smallest composite key in the segment (b"" when empty)."""
        return self._block_keys[0] if self._block_keys else b""

    @property
    def last_key(self) -> bytes:
        """Largest composite key — decoded from the final block ONCE and
        cached; the engine's leveled compaction selects overlapping-range
        segments by [first_key, last_key] without scanning files."""
        if self._last_key is None:
            if not self._block_keys:
                self._last_key = b""
            else:
                self._last_key = self._block(len(self._block_keys) - 1)[-1][0]
        return self._last_key

    def overlaps(self, lo: bytes, hi: bytes) -> bool:
        """Key-range intersection test against [lo, hi] (inclusive)."""
        return bool(self._block_keys) and \
            self.first_key <= hi and lo <= self.last_key

    def _load_meta(self) -> None:
        if self.file_bytes < _FOOTER.size:
            raise CorruptSSTable(f"{self.path}: truncated")
        foot = os.pread(self._fd, _FOOTER.size,
                        self.file_bytes - _FOOTER.size)
        (index_off, bloom_off, tables_off, nrecords, crc,
         magic) = _FOOTER.unpack(foot)
        if magic != MAGIC:
            raise CorruptSSTable(f"{self.path}: bad magic")
        meta = os.pread(self._fd, self.file_bytes - _FOOTER.size - index_off,
                        index_off)
        if zlib.crc32(meta) != crc:
            raise CorruptSSTable(f"{self.path}: metadata crc mismatch")
        self.nrecords = nrecords
        # index
        off = 0
        (nblocks,) = struct.unpack_from("<I", meta, off)
        off += 4
        self._block_keys: list[bytes] = []
        self._block_pos: list[tuple[int, int]] = []
        for _ in range(nblocks):
            (kl,) = struct.unpack_from("<I", meta, off)
            off += 4
            first = meta[off:off + kl]
            off += kl
            boff, blen = struct.unpack_from("<QI", meta, off)
            off += 12
            self._block_keys.append(first)
            self._block_pos.append((boff, blen))
        # bloom
        boff_rel = bloom_off - index_off
        toff_rel = tables_off - index_off
        self.bloom = BloomFilter.decode(meta[boff_rel:toff_rel])
        # tables
        off = toff_rel
        (ntab,) = struct.unpack_from("<I", meta, off)
        off += 4
        self._tables: list[str] = []
        for _ in range(ntab):
            (tl,) = struct.unpack_from("<H", meta, off)
            off += 2
            self._tables.append(meta[off:off + tl].decode())
            off += tl

    def tables(self) -> list[str]:
        return list(self._tables)

    def _block(self, idx: int) -> list[tuple[bytes, int, bytes]]:
        with self._cache_lock:
            ents = self._cache.get(idx)
            if ents is not None:
                return ents
        boff, blen = self._block_pos[idx]
        raw = os.pread(self._fd, blen, boff)
        if len(raw) != blen:
            raise CorruptSSTable(f"{self.path}: short block read")
        ents = []
        off = 0
        prev = b""
        while off < len(raw):
            shared, off = _read_uvarint(raw, off)
            unshared, off = _read_uvarint(raw, off)
            flag = raw[off]
            off += 1
            vlen, off = _read_uvarint(raw, off)
            key = prev[:shared] + raw[off:off + unshared]
            off += unshared
            value = raw[off:off + vlen]
            off += vlen
            ents.append((key, flag, value))
            prev = key
        with self._cache_lock:
            if idx not in self._cache:
                self._cache[idx] = ents
                self._cache_order.append(idx)
                if len(self._cache_order) > self.BLOCK_CACHE:
                    self._cache.pop(self._cache_order.pop(0), None)
        return ents

    def get(self, ck: bytes) -> Optional[tuple[int, bytes]]:
        """-> (flag, value) or None when the segment has no record.
        Callers needing bloom accounting use `may_contain` first."""
        if not self._block_keys:
            return None
        i = bisect.bisect_right(self._block_keys, ck) - 1
        if i < 0:
            return None
        for key, flag, value in self._block(i):
            if key == ck:
                return flag, value
            if key > ck:
                return None
        return None

    def may_contain(self, ck: bytes) -> bool:
        return self.bloom.may_contain(ck)

    def iter_from(self, start: bytes = b""
                  ) -> Iterator[tuple[bytes, int, bytes]]:
        """All records with key >= start, in order (tombstones included)."""
        if not self._block_keys:
            return
        i = max(0, bisect.bisect_right(self._block_keys, start) - 1)
        for idx in range(i, len(self._block_keys)):
            for key, flag, value in self._block(idx):
                if key >= start:
                    yield key, flag, value

    def close(self) -> None:
        fd, self._fd = self._fd, -1
        if fd >= 0:
            try:
                os.close(fd)
            except OSError:
                pass
