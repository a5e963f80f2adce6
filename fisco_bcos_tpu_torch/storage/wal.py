"""Durable storage: write-ahead log + in-memory index + snapshot compaction.

Fills the RocksDBStorage slot (FISCO-BCOS bcos-storage/bcos-storage/
RocksDBStorage.h:64-68) for single-node deployments: the 2PC `prepare`
stages a changeset, `commit` appends one atomic, checksummed WAL record and
fsyncs — crash recovery replays the log over the last snapshot, and prepared-
but-uncommitted blocks vanish, exactly the semantics the scheduler's
batchBlockCommit relies on (BlockExecutive.cpp:1265). Periodic compaction
writes a full snapshot and truncates the log.

(A C++ LSM engine can slot in behind the same TransactionalStorage contract
for Pro/Max-scale state; the WAL format below is deliberately trivial so the
native engine can share it.)

Record format (all little-endian):
  [u32 crc32 of payload][u64 payload_len][payload]
  payload = u64 block_number, u32 nitems,
            nitems * (u8 deleted, u16 table_len, table, u32 key_len, key,
                      u32 val_len, val)
"""

from __future__ import annotations

import errno
import os
import struct
import zlib
from typing import Iterator, Optional

from ..analysis import lockcheck as lc
from ..utils import failpoints as fp
from .interface import ChangeSet, Entry, EntryStatus, TransactionalStorage

_HDR = struct.Struct("<IQ")

# deterministic fault sites on the durability edges (utils/failpoints.py):
# append fires INSIDE the write/fsync try of both backends, so an injected
# `enospc` exercises the exact errno path a full disk takes
fp.register("storage.wal.append_before_fsync", "storage.wal.rotate",
            "storage.wal.compact")


class _SpaceHealth:
    """Shared ENOSPC -> health plumbing for the WAL-owning backends: report
    `storage.space` degraded on a full disk, self-heal by probing the same
    fsync path, clear on the first successful append."""

    health = None  # a utils.health.Health (or fanout), attached by the node
    _space_faulted = False

    def _space_err(self, exc: BaseException) -> None:
        if isinstance(exc, OSError) and exc.errno == errno.ENOSPC \
                and self.health is not None:
            self._space_faulted = True
            self.health.degraded("storage.space", str(exc),
                                 probe=self.probe_space)

    def _space_ok(self) -> None:
        if self._space_faulted:  # plain-flag guard: zero cost when healthy
            self._space_faulted = False
            if self.health is not None:
                self.health.clear("storage.space")

    def probe_space(self) -> bool:
        """Try the append path with an empty changeset (a ~20-byte record).
        True = the disk accepts writes again (the health ticker clears the
        fault); raises/False = still out of space."""
        raise NotImplementedError


def pack_payload(block_number: int, cs: ChangeSet) -> bytes:
    """One WAL record payload for a changeset (format in the module doc)."""
    parts = [struct.pack("<QI", block_number, len(cs))]
    for (table, key), e in cs.items():
        tb = table.encode()
        parts.append(struct.pack("<BH", 1 if e.deleted else 0, len(tb)))
        parts.append(tb)
        parts.append(struct.pack("<I", len(key)))
        parts.append(key)
        parts.append(struct.pack("<I", len(e.value)))
        parts.append(e.value)
    return b"".join(parts)


def unpack_payload(payload: bytes
                   ) -> tuple[int, list[tuple[bool, str, bytes, bytes]]]:
    """-> (block_number, [(deleted, table, key, value)])."""
    (block_number,) = struct.unpack_from("<Q", payload, 0)
    off = 8
    (n,) = struct.unpack_from("<I", payload, off)
    off += 4
    out = []
    for _ in range(n):
        deleted = payload[off]
        off += 1
        (tl,) = struct.unpack_from("<H", payload, off)
        off += 2
        table = payload[off:off + tl].decode()
        off += tl
        (kl,) = struct.unpack_from("<I", payload, off)
        off += 4
        key = payload[off:off + kl]
        off += kl
        (vl,) = struct.unpack_from("<I", payload, off)
        off += 4
        val = payload[off:off + vl]
        off += vl
        out.append((bool(deleted), table, key, val))
    return block_number, out


def scan_records(raw: bytes) -> tuple[list[bytes], int]:
    """-> (payloads, valid_prefix_len): every checksummed record up to the
    first torn/corrupt one (a kill -9 mid-append leaves a torn tail)."""
    payloads: list[bytes] = []
    off = 0
    while off + _HDR.size <= len(raw):
        crc, ln = _HDR.unpack_from(raw, off)
        if off + _HDR.size + ln > len(raw):
            break
        payload = raw[off + _HDR.size: off + _HDR.size + ln]
        if zlib.crc32(payload) != crc:
            break
        payloads.append(payload)
        off += _HDR.size + ln
    return payloads, off


def truncate_torn_tail(path: str, valid_len: int, total_len: int) -> None:
    """Cut a log back to its valid prefix, preserving the discarded
    suffix aside (unique evidence file per incident) and logging the cut."""
    from ..utils.log import LOG, badge
    corrupt = path + ".corrupt"
    seq = 1
    while os.path.exists(corrupt):
        corrupt = f"{path}.corrupt-{seq}"
        seq += 1
    with open(path, "rb") as f:
        f.seek(valid_len)
        tail = f.read()
    with open(corrupt, "wb") as f:
        f.write(tail)
    LOG.warning(badge("WAL", "torn-tail-truncated", kept=valid_len,
                      dropped=total_len - valid_len, saved=corrupt))
    with open(path, "rb+") as f:
        f.truncate(valid_len)
        f.flush()
        os.fsync(f.fileno())


class WalCorruptionError(RuntimeError):
    """Corruption in the MIDDLE of the WAL stream: durable records exist
    beyond the damage, so replaying past it would silently apply newer
    changesets over a gap of lost committed writes. Boot must refuse
    (wipe + snap-sync is the recovery path), unlike a torn FINAL tail,
    which is routine kill -9 fallout and is truncated."""


def _rewind_append(f, path: str, off: int):
    """Recover an append-mode log file after a failed write: drop any
    buffered/partial bytes by reopening and truncating back to the last
    good record boundary. Returns the fresh append handle."""
    try:
        f.close()  # discards the unflushed buffer; may raise on flush
    except OSError:
        pass
    try:
        with open(path, "rb+") as t:
            t.truncate(off)
            t.flush()
            os.fsync(t.fileno())
    except OSError:
        pass  # truncate needs no space; a failure here leaves the torn
        #       tail for recovery's truncate_torn_tail to cut at boot
    return open(path, "ab")


class SegmentedWal:
    """Rotated WAL segments for the disk engine (storage/engine.py).

    Files are `wal-<seq>.log` in ascending append order. The engine
    rotates at every memtable flush and — once the flush is durable in the
    manifest — retires every segment below the flush floor, so the log
    stops growing without bound between compactions.
    Record format is WalStorage's (shared pack/scan helpers above); a new
    boot always appends to a FRESH segment so recovery never writes behind
    a truncated tail.
    """

    PREFIX = "wal-"
    SUFFIX = ".log"

    def __init__(self, path: str, start_seq: int):
        self.path = path
        self.active_seq = start_seq
        self._f = open(self._segment_path(start_seq), "ab")

    def _segment_path(self, seq: int) -> str:
        return os.path.join(self.path, f"{self.PREFIX}{seq:08d}{self.SUFFIX}")

    @classmethod
    def list_segments(cls, path: str) -> list[tuple[int, str]]:
        out = []
        for name in os.listdir(path):
            if name.startswith(cls.PREFIX) and name.endswith(cls.SUFFIX):
                seq_s = name[len(cls.PREFIX):-len(cls.SUFFIX)]
                if seq_s.isdigit():
                    out.append((int(seq_s), os.path.join(path, name)))
        return sorted(out)

    @classmethod
    def replay(cls, path: str, from_seq: int
               ) -> Iterator[tuple[int, bytes]]:
        """Yield (seq, payload) for every durable record in segments >=
        from_seq. A torn tail on the FINAL segment is routine crash
        fallout and is truncated in place; corruption with later records
        still on disk (mid-segment rot, or a damaged non-final segment)
        raises WalCorruptionError — replaying past the gap would lose
        committed writes silently."""
        segs = [(seq, p) for seq, p in cls.list_segments(path)
                if seq >= from_seq]
        for idx, (seq, seg_path) in enumerate(segs):
            with open(seg_path, "rb") as f:
                raw = f.read()
            payloads, valid = scan_records(raw)
            if valid < len(raw):
                if idx < len(segs) - 1:
                    raise WalCorruptionError(
                        f"{seg_path}: corrupt record at offset {valid} "
                        f"with {len(segs) - 1 - idx} later WAL segment(s) "
                        "present — refusing to replay over lost committed "
                        "records")
                truncate_torn_tail(seg_path, valid, len(raw))
            for p in payloads:
                yield seq, p

    def append(self, block_number: int, cs: ChangeSet) -> None:
        fp.fire("storage.wal.append_before_fsync")
        lc.note_blocking("fsync", "SegmentedWal.append")
        payload = pack_payload(block_number, cs)
        off = os.fstat(self._f.fileno()).st_size  # buffer empty: every
        #     prior append flushed or was rewound, so size IS the offset
        try:
            self._f.write(_HDR.pack(zlib.crc32(payload), len(payload))
                          + payload)
            self._f.flush()
            os.fsync(self._f.fileno())
        except OSError:
            # a SURVIVED write failure (ENOSPC with the health plane
            # keeping the node up) must not leave torn bytes in the log:
            # later appends would land AFTER them and the next restart's
            # replay would stop at the tear, silently dropping every
            # acked commit behind it
            self._f = _rewind_append(self._f,
                                     self._segment_path(self.active_seq),
                                     off)
            raise

    def rotate(self) -> int:
        """Close the active segment and start the next; returns the NEW
        active seq — every record appended before the call lives in
        segments strictly below it."""
        fp.fire("storage.wal.rotate")
        self._f.close()
        self.active_seq += 1
        self._f = open(self._segment_path(self.active_seq), "ab")
        return self.active_seq

    def retire_below(self, floor_seq: int) -> int:
        """Delete segments with seq < floor_seq (never the active one);
        returns how many files were removed."""
        removed = 0
        for seq, seg_path in self.list_segments(self.path):
            if seq < floor_seq and seq != self.active_seq:
                try:
                    os.remove(seg_path)
                    removed += 1
                except OSError:
                    pass
        return removed

    def tail_bytes(self) -> int:
        return sum(os.path.getsize(p)
                   for _, p in self.list_segments(self.path)
                   if os.path.exists(p))

    def close(self) -> None:
        self._f.close()


class WalStorage(TransactionalStorage, _SpaceHealth):
    SNAPSHOT = "snapshot.bin"
    LOG = "wal.log"

    def __init__(self, path: str, compact_every: int = 1024, health=None):
        self.path = path
        self.health = health
        os.makedirs(path, exist_ok=True)
        self._tables: dict[str, dict[bytes, bytes]] = {}
        self._prepared: dict[int, ChangeSet] = {}
        self._lock = lc.make_rlock("wal.state")
        self._commits_since_compact = 0
        self.compact_every = compact_every
        self._recover()
        self._log = open(os.path.join(path, self.LOG), "ab")

    # -- recovery ----------------------------------------------------------
    def _recover(self) -> None:
        snap = os.path.join(self.path, self.SNAPSHOT)
        if os.path.exists(snap):
            with open(snap, "rb") as f:
                data = f.read()
            if len(data) >= 4:
                crc = struct.unpack("<I", data[:4])[0]
                body = data[4:]
                if zlib.crc32(body) == crc:
                    self._load_snapshot(body)
        logp = os.path.join(self.path, self.LOG)
        if os.path.exists(logp):
            with open(logp, "rb") as f:
                raw = f.read()
            payloads, off = scan_records(raw)
            for payload in payloads:
                self._apply_payload(payload)
            if off < len(raw):
                # a kill -9 mid-append leaves a torn/corrupt tail; appends
                # after it would land BEHIND garbage and be unreadable on
                # the next recovery — cut the log back to the valid prefix
                # (suffix preserved aside, cut logged: a few torn bytes are
                # routine crash fallout, a LARGE suffix means mid-file
                # corruption ate committed records and an operator must
                # know)
                truncate_torn_tail(logp, off, len(raw))

    def _load_snapshot(self, body: bytes) -> None:
        off = 0
        (ntab,) = struct.unpack_from("<I", body, off)
        off += 4
        for _ in range(ntab):
            (tl,) = struct.unpack_from("<H", body, off)
            off += 2
            table = body[off : off + tl].decode()
            off += tl
            (nrow,) = struct.unpack_from("<I", body, off)
            off += 4
            rows = {}
            for _ in range(nrow):
                kl, vl = struct.unpack_from("<II", body, off)
                off += 8
                k = body[off : off + kl]
                off += kl
                v = body[off : off + vl]
                off += vl
                rows[k] = v
            self._tables[table] = rows

    def _apply_payload(self, payload: bytes) -> None:
        off = 8  # skip block number
        (n,) = struct.unpack_from("<I", payload, off)
        off += 4
        for _ in range(n):
            deleted = payload[off]
            off += 1
            (tl,) = struct.unpack_from("<H", payload, off)
            off += 2
            table = payload[off : off + tl].decode()
            off += tl
            (kl,) = struct.unpack_from("<I", payload, off)
            off += 4
            key = payload[off : off + kl]
            off += kl
            (vl,) = struct.unpack_from("<I", payload, off)
            off += 4
            val = payload[off : off + vl]
            off += vl
            if deleted:
                self._tables.get(table, {}).pop(key, None)
            else:
                self._tables.setdefault(table, {})[key] = val

    # -- reads/writes (non-transactional direct ops, genesis bootstrap) ----
    def get(self, table: str, key: bytes) -> Optional[bytes]:
        with self._lock:
            return self._tables.get(table, {}).get(key)

    def set(self, table: str, key: bytes, value: bytes) -> None:
        with self._lock:
            self._append_record(0, {(table, key): Entry(value)})
            self._tables.setdefault(table, {})[key] = value

    def remove(self, table: str, key: bytes) -> None:
        with self._lock:
            self._append_record(0, {(table, key): Entry(b"", EntryStatus.DELETED)})
            self._tables.get(table, {}).pop(key, None)

    # batched direct writes: ONE WAL record + ONE fsync per call (the PBFT
    # consensus log writes several keys per phase on the hot worker thread)
    def set_batch(self, table: str, items) -> None:
        items = list(items)
        if not items:
            return
        with self._lock:
            self._append_record(0, {(table, k): Entry(v) for k, v in items})
            rows = self._tables.setdefault(table, {})
            for k, v in items:
                rows[k] = v

    def remove_batch(self, table: str, ks) -> None:
        ks = list(ks)
        if not ks:
            return
        with self._lock:
            self._append_record(0, {(table, k): Entry(b"", EntryStatus.DELETED)
                                    for k in ks})
            rows = self._tables.get(table, {})
            for k in ks:
                rows.pop(k, None)

    def tables(self) -> list[str]:
        """Live table names (operator tooling: storage_tool stats)."""
        with self._lock:
            return sorted(self._tables)

    def keys(self, table: str, prefix: bytes = b"") -> Iterator[bytes]:
        with self._lock:
            ks = sorted(k for k in self._tables.get(table, {})
                        if k.startswith(prefix))
        return iter(ks)

    # -- 2PC ---------------------------------------------------------------
    def prepare(self, block_number: int, changes: ChangeSet) -> None:
        with self._lock:
            self._prepared[block_number] = dict(changes)

    def commit(self, block_number: int) -> None:
        with self._lock:
            cs = self._prepared.pop(block_number)
            self._append_record(block_number, cs)
            for (table, key), entry in cs.items():
                if entry.deleted:
                    self._tables.get(table, {}).pop(key, None)
                else:
                    self._tables.setdefault(table, {})[key] = entry.value
            self._commits_since_compact += 1
            if self._commits_since_compact >= self.compact_every:
                self.compact()

    def rollback(self, block_number: int) -> None:
        with self._lock:
            self._prepared.pop(block_number, None)

    # -- log/snapshot mechanics -------------------------------------------
    def _append_record(self, block_number: int, cs: ChangeSet) -> None:
        try:
            fp.fire("storage.wal.append_before_fsync")
            lc.note_blocking("fsync", "WalStorage._append_record")
            payload = pack_payload(block_number, cs)
            off = os.fstat(self._log.fileno()).st_size
            try:
                self._log.write(_HDR.pack(zlib.crc32(payload),
                                          len(payload)) + payload)
                self._log.flush()
                os.fsync(self._log.fileno())
            except OSError:
                # survived write failure: rewind the torn bytes so later
                # appends (and the next restart's replay) never land
                # behind an unparseable partial record
                self._log = _rewind_append(
                    self._log, os.path.join(self.path, self.LOG), off)
                raise
        except OSError as exc:
            # ENOSPC mid-commit must not kill the node: report, let the
            # 2PC fail cleanly upstream (scheduler rolls back and the
            # height retries), and self-heal via the probe once space
            # returns
            self._space_err(exc)
            raise
        self._space_ok()

    def probe_space(self) -> bool:
        with self._lock:
            self._append_record(0, {})
        return True

    def audit(self) -> list[str]:
        """Coherence problems with the on-disk log/snapshot, [] if clean
        (the invariant auditor's storage check, ops/audit.py).

        Only the size capture holds the storage lock: appends are whole
        records flushed under `_lock`, so every byte below the captured
        size is a complete record — the O(log) read + parse must not
        stall commits for the duration of an RPC-triggered audit."""
        problems: list[str] = []
        logp = os.path.join(self.path, self.LOG)
        with self._lock:
            try:
                self._log.flush()
                size = os.path.getsize(logp)
            except (OSError, ValueError) as exc:  # closed/unreadable
                return [f"wal.log unreadable: {exc}"]
        try:
            with open(logp, "rb") as f:
                raw = f.read(size)
            _, valid = scan_records(raw)
            if valid < len(raw):
                problems.append(
                    f"wal.log: {len(raw) - valid} unparseable byte(s) "
                    f"past offset {valid}")
        except OSError as exc:
            problems.append(f"wal.log unreadable: {exc}")
        snap = os.path.join(self.path, self.SNAPSHOT)
        if os.path.exists(snap):
            try:
                with open(snap, "rb") as f:
                    data = f.read()
                if len(data) < 4 or zlib.crc32(data[4:]) != \
                        struct.unpack("<I", data[:4])[0]:
                    problems.append("snapshot.bin crc mismatch")
            except OSError as exc:
                problems.append(f"snapshot.bin unreadable: {exc}")
        return problems

    def compact(self) -> None:
        """Write a snapshot and truncate the WAL (atomic rename)."""
        fp.fire("storage.wal.compact")
        lc.note_blocking("fsync", "WalStorage.compact")
        with self._lock:
            parts = [struct.pack("<I", len(self._tables))]
            for table, rows in self._tables.items():
                tb = table.encode()
                parts.append(struct.pack("<H", len(tb)))
                parts.append(tb)
                parts.append(struct.pack("<I", len(rows)))
                for k, v in rows.items():
                    parts.append(struct.pack("<II", len(k), len(v)))
                    parts.append(k)
                    parts.append(v)
            body = b"".join(parts)
            tmp = os.path.join(self.path, self.SNAPSHOT + ".tmp")
            with open(tmp, "wb") as f:
                f.write(struct.pack("<I", zlib.crc32(body)) + body)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, os.path.join(self.path, self.SNAPSHOT))
            self._log.close()
            self._log = open(os.path.join(self.path, self.LOG), "wb")
            self._commits_since_compact = 0

    def close(self) -> None:
        with self._lock:
            self._log.close()
