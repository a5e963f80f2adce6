"""KeyPageStorage — packs table rows into pages to cut KV round-trips.

Reference counterpart: FISCO-BCOS bcos-table/src/KeyPageStorage.h:87-99
(rows bucketed into ~10KB pages keyed by their first row; configured by
`storage.key_page_size`, bcos-tool/bcos-tool/NodeConfig.cpp:620). Small
contract-state rows dominate a block's working set; paging them turns N tiny
backend reads into a handful of page reads — the same motivation as the
reference, and on this framework it also batches nicely ahead of device
hashing (fewer, larger host->storage ops).

Layout in the backend:
  * per table, a meta row ``_kp_/meta`` holds the sorted list of page-start
    keys (u32 count, then length-prefixed keys);
  * each page lives at ``_kp_/p/<start-key>`` and holds its rows sorted
    (u32 count, then (u32 klen, key, u32 vlen, val)*).

Row-level 2PC changesets are translated into page-level changesets at
`prepare`, so the wrapped TransactionalStorage (WalStorage / NativeStorage /
DiskStorage) commits pages atomically with everything else.

As the disk engine's value layout (`[storage] key_page_size > 0`,
storage/__init__.py make_storage) this is what makes wide tables cheap:
a `keys(prefix)` range scan touches the pages covering the prefix range —
typically ONE backend read — instead of a per-row walk, and the engine
sees few large values (better block packing, fewer bloom probes).
`stats()` exposes the backend read counters the unit tests pin down.
"""

from __future__ import annotations

import bisect
import struct
import threading
from typing import Iterator, Optional

from .interface import ChangeSet, Entry, EntryStatus, TransactionalStorage

META_KEY = b"_kp_/meta"
PAGE_PREFIX = b"_kp_/p/"


def _pack_page(rows: dict[bytes, bytes]) -> bytes:
    parts = [struct.pack("<I", len(rows))]
    for k in sorted(rows):
        v = rows[k]
        parts.append(struct.pack("<I", len(k)))
        parts.append(k)
        parts.append(struct.pack("<I", len(v)))
        parts.append(v)
    return b"".join(parts)


def _unpack_page(data: bytes) -> dict[bytes, bytes]:
    (n,) = struct.unpack_from("<I", data, 0)
    off = 4
    rows: dict[bytes, bytes] = {}
    for _ in range(n):
        (kl,) = struct.unpack_from("<I", data, off)
        off += 4
        k = data[off:off + kl]
        off += kl
        (vl,) = struct.unpack_from("<I", data, off)
        off += 4
        rows[k] = data[off:off + vl]
        off += vl
    return rows


def _pack_meta(starts: list[bytes]) -> bytes:
    parts = [struct.pack("<I", len(starts))]
    for s in starts:
        parts.append(struct.pack("<I", len(s)))
        parts.append(s)
    return b"".join(parts)


def _unpack_meta(data: bytes) -> list[bytes]:
    (n,) = struct.unpack_from("<I", data, 0)
    off = 4
    out = []
    for _ in range(n):
        (sl,) = struct.unpack_from("<I", data, off)
        off += 4
        out.append(data[off:off + sl])
        off += sl
    return out


class KeyPageStorage(TransactionalStorage):
    """Row-level TransactionalStorage over a page-level backend."""

    def __init__(self, backend: TransactionalStorage,
                 page_size: int = 10 * 1024):
        self.backend = backend
        self.page_size = page_size
        self._lock = threading.RLock()
        self._meta: dict[str, list[bytes]] = {}  # table -> page starts
        self._pages: dict[tuple[str, bytes], dict[bytes, bytes]] = {}  # cache
        self._staged: dict[int, tuple[dict, dict]] = {}  # block -> (meta, pages)
        # read-amplification accounting: backend reads vs rows served —
        # the property the page layout exists for, pinned by unit tests
        self._backend_reads = 0
        self._cache_hits = 0

    # -- page plumbing -----------------------------------------------------
    def _meta_for(self, table: str) -> list[bytes]:
        m = self._meta.get(table)
        if m is None:
            raw = self.backend.get(table, META_KEY)
            self._backend_reads += 1
            m = _unpack_meta(raw) if raw else []
            self._meta[table] = m
        return m

    def _page_rows(self, table: str, start: bytes) -> dict[bytes, bytes]:
        ck = (table, start)
        rows = self._pages.get(ck)
        if rows is None:
            raw = self.backend.get(table, PAGE_PREFIX + start)
            self._backend_reads += 1
            rows = _unpack_page(raw) if raw else {}
            self._pages[ck] = rows
        else:
            self._cache_hits += 1
        return rows

    @staticmethod
    def _page_index(meta: list[bytes], key: bytes) -> int:
        """Index of the page whose range covers `key` (-1 if none)."""
        i = bisect.bisect_right(meta, key) - 1
        return i

    # -- row-level ops (direct, non-transactional path) --------------------
    def get(self, table: str, key: bytes) -> Optional[bytes]:
        with self._lock:
            meta = self._meta_for(table)
            i = self._page_index(meta, key)
            if i < 0:
                return None
            return self._page_rows(table, meta[i]).get(key)

    def set(self, table: str, key: bytes, value: bytes) -> None:
        with self._lock:
            cs = self._translate(
                {(table, key): Entry(value, EntryStatus.NORMAL)},
                self._meta, self._pages)
            for (t, k), e in cs.items():
                if e.deleted:
                    self.backend.remove(t, k)
                else:
                    self.backend.set(t, k, e.value)

    def remove(self, table: str, key: bytes) -> None:
        with self._lock:
            cs = self._translate(
                {(table, key): Entry(b"", EntryStatus.DELETED)},
                self._meta, self._pages)
            for (t, k), e in cs.items():
                if e.deleted:
                    self.backend.remove(t, k)
                else:
                    self.backend.set(t, k, e.value)

    # the port differs here: the JAX package's KeyPageStorage inherits the
    # row-at-a-time batch loops, so each row of a batch repacks and
    # rewrites its whole page through the backend (one WAL record a row):
    # a snapshot prune of one 16,384-tx block's bodies (ledger.py
    # prune_block_data) rewrote pages of thousands of rows 49,152 times.
    # A batch is translated once here, and each touched page is written
    # once, in one backend batch a table. The rows are the same.
    def set_batch(self, table: str, items) -> None:
        self._write_rows({(table, k): Entry(v, EntryStatus.NORMAL)
                          for k, v in items})

    def remove_batch(self, table: str, ks) -> None:
        self._write_rows({(table, k): Entry(b"", EntryStatus.DELETED)
                          for k in ks})

    def _write_rows(self, changes: ChangeSet) -> None:
        if not changes:
            return
        with self._lock:
            cs = self._translate(changes, self._meta, self._pages)
            sets: dict[str, list] = {}
            removes: dict[str, list] = {}
            for (t, k), e in cs.items():
                if e.deleted:
                    removes.setdefault(t, []).append(k)
                else:
                    sets.setdefault(t, []).append((k, e.value))
            # pages and the meta row first: a page left behind by a crash
            # between the two writes is not in the meta row, so no read
            # reaches it
            for t, items in sets.items():
                self.backend.set_batch(t, items)
            for t, ks in removes.items():
                self.backend.remove_batch(t, ks)

    def keys(self, table: str, prefix: bytes = b"") -> Iterator[bytes]:
        with self._lock:
            meta = self._meta_for(table)
            out = []
            start_i = max(0, self._page_index(meta, prefix))
            for s in meta[start_i:]:
                # a page whose start is already past the prefix range can
                # hold no matching row (its rows are >= start) — stop
                # BEFORE paying the read, so a range scan touches exactly
                # the pages covering the prefix
                if prefix and s > prefix and not s.startswith(prefix):
                    break
                rows = self._page_rows(table, s)
                for k in rows:
                    if k.startswith(prefix):
                        out.append(k)
            return iter(sorted(out))

    def tables(self) -> list[str]:
        """Row-level table names == backend table names (pages live inside
        the same table under the `_kp_/` key prefix); snapshot export and
        operator tooling need this passthrough."""
        base_tables = getattr(self.backend, "tables", None)
        return [] if base_tables is None else base_tables()

    def stats(self) -> dict:
        """Read-amplification counters (direct unit-test surface), merged
        with the wrapped backend's stats under `backend_stats` so the ops
        surface (getSystemStatus, storage_tool) still sees the engine's
        level/debt/segment detail when keypage is the default layout."""
        with self._lock:
            out = {"backend_reads": self._backend_reads,
                   "cache_hits": self._cache_hits,
                   "cached_pages": len(self._pages),
                   "tables_cached": len(self._meta),
                   "key_page_size": self.page_size}
        backend_stats = getattr(self.backend, "stats", None)
        if backend_stats is not None:
            out["backend_stats"] = backend_stats()
        return out

    # -- engine passthroughs ----------------------------------------------
    # KeyPageStorage is a LAYOUT, not a lifecycle owner: every operational
    # seam the node discovers by feature detection (ops/audit.py, snapshot
    # export/install, the overload debt signal, storage_tool) must keep
    # working when the disk engine sits behind a page layer — these appear
    # only when the backend provides them, preserving the getattr contract.
    def __getattr__(self, name):
        if name in ("audit", "compaction_debt_bytes", "disk_bytes",
                    "flush", "needs_compaction", "probe_space"):
            return getattr(self.backend, name)
        # the port differs here: the snapshot seams appear only when the
        # backend has them (as the passthroughs above), and they speak
        # ROWS, not pages. The JAX package's capture_rows streamed the
        # page layout (`_kp_/meta`, `_kp_/p/...`), so install_snapshot's
        # binding checks, which look up the checkpoint's header, hash and
        # current-number rows by their row keys, never found them: a
        # key-paged node's snapshot (the disk backend's default) could not
        # be installed anywhere, and over a WalStorage backend, which has
        # neither seam, export raised AttributeError instead of walking
        # keys(). A snapshot now carries the same rows whatever the
        # exporter's layout, and install re-pages them for this layout.
        if name == "capture_rows" and hasattr(self.backend, name):
            return self._capture_rows
        if name == "install_rows" and hasattr(self.backend, name):
            return self._install_rows
        raise AttributeError(name)

    def compact(self) -> None:
        backend_compact = getattr(self.backend, "compact", None)
        if backend_compact is not None:
            backend_compact()

    def _capture_rows(self):
        """Snapshot export: the backend's consistent view (frozen here,
        under the caller's lock) with every page its table's meta row
        lists unpacked into its rows, in key order within a table (the
        meta row sorts first; pages cover ascending, disjoint key ranges,
        and the backend streams them in start-key order)."""
        frozen = self.backend.capture_rows()

        def rows():
            listed: set = set()   # the current table's pages, by its meta row
            for table, key, value in frozen:
                if key == META_KEY:
                    listed = {PAGE_PREFIX + s for s in _unpack_meta(value)}
                elif key.startswith(PAGE_PREFIX):
                    if key in listed:
                        page = _unpack_page(value)
                        for k in sorted(page):
                            yield table, k, page[k]
                else:
                    yield table, key, value
        return rows()

    def _paginate(self, rows: dict) -> dict:
        """A table's rows as this layout's backend rows: pages filled in
        key order up to page_size (a row larger than a page gets its own),
        and the meta row listing their starts."""
        out: dict[bytes, bytes] = {}
        starts: list[bytes] = []
        page: dict[bytes, bytes] = {}
        size = 4
        for k in sorted(rows):
            row = 8 + len(k) + len(rows[k])
            if page and size + row > self.page_size:
                out[PAGE_PREFIX + starts[-1]] = _pack_page(page)
                page, size = {}, 4
            if not page:
                starts.append(k)
            page[k] = rows[k]
            size += row
        if page:
            out[PAGE_PREFIX + starts[-1]] = _pack_page(page)
        if starts:
            out[META_KEY] = _pack_meta(starts)
        return out

    def _install_rows(self, by_table: dict) -> None:
        """Snapshot install: each carried table's rows re-paged, then the
        backend's atomic install (tables the snapshot does not carry keep
        their local pages)."""
        with self._lock:
            self.backend.install_rows(
                {t: self._paginate(rows) for t, rows in by_table.items()})
            # the swapped-in state invalidates every cached page wholesale
            self.flush_caches()

    # -- changeset translation ---------------------------------------------
    def _translate(self, changes: ChangeSet,
                   meta_state: dict[str, list[bytes]],
                   page_state: dict[tuple[str, bytes], dict[bytes, bytes]]
                   ) -> ChangeSet:
        """Apply row changes to (meta_state, page_state) in place; return the
        page-level backend changeset."""
        out: ChangeSet = {}
        touched: dict[str, set[bytes]] = {}
        for (table, key), e in sorted(changes.items()):
            if table not in meta_state:
                meta_state[table] = list(self._meta_for(table))
            meta = meta_state[table]
            i = self._page_index(meta, key)
            if i < 0:
                if not meta:
                    if e.deleted:
                        continue
                    meta.insert(0, key)
                    page_state[(table, key)] = {}
                    touched.setdefault(table, set()).add(key)
                    out[(table, META_KEY)] = Entry(_pack_meta(meta))
                    i = 0
                else:
                    # key sorts before the first page: extend page 0 downward
                    old0 = meta[0]
                    if (table, old0) not in page_state:
                        page_state[(table, old0)] = dict(
                            self._page_rows(table, old0))
                    page_state[(table, key)] = page_state.pop((table, old0))
                    meta[0] = key
                    out[(table, PAGE_PREFIX + old0)] = Entry(
                        b"", EntryStatus.DELETED)
                    out[(table, META_KEY)] = Entry(_pack_meta(meta))
                    touched.setdefault(table, set()).add(key)
                    i = 0
            start = meta[i]
            if (table, start) not in page_state:
                page_state[(table, start)] = dict(self._page_rows(table, start))
            rows = page_state[(table, start)]
            if e.deleted:
                rows.pop(key, None)
            else:
                rows[key] = e.value
            touched.setdefault(table, set()).add(start)

        # split oversized pages / drop empty ones, then emit page writes
        for table, starts in touched.items():
            meta = meta_state[table]
            for start in list(starts):
                rows = page_state.get((table, start), {})
                if not rows and len(meta) > 1:
                    meta.remove(start)
                    page_state.pop((table, start), None)
                    out[(table, PAGE_PREFIX + start)] = Entry(
                        b"", EntryStatus.DELETED)
                    out[(table, META_KEY)] = Entry(_pack_meta(meta))
                    continue
                packed = _pack_page(rows)
                if len(packed) > self.page_size and len(rows) > 1:
                    ks = sorted(rows)
                    mid = len(ks) // 2
                    hi_start = ks[mid]
                    hi_rows = {k: rows[k] for k in ks[mid:]}
                    lo_rows = {k: rows[k] for k in ks[:mid]}
                    page_state[(table, start)] = lo_rows
                    page_state[(table, hi_start)] = hi_rows
                    bisect.insort(meta, hi_start)
                    out[(table, PAGE_PREFIX + start)] = Entry(
                        _pack_page(lo_rows))
                    out[(table, PAGE_PREFIX + hi_start)] = Entry(
                        _pack_page(hi_rows))
                    out[(table, META_KEY)] = Entry(_pack_meta(meta))
                else:
                    out[(table, PAGE_PREFIX + start)] = Entry(packed)
        return out

    # -- 2PC ---------------------------------------------------------------
    def prepare(self, block_number: int, changes: ChangeSet) -> None:
        with self._lock:
            meta_state = {t: list(m) for t, m in self._meta.items()}
            page_state = {k: dict(v) for k, v in self._pages.items()}
            translated = self._translate(changes, meta_state, page_state)
            self._staged[block_number] = (meta_state, page_state)
            self.backend.prepare(block_number, translated)

    def commit(self, block_number: int) -> None:
        with self._lock:
            self.backend.commit(block_number)
            meta_state, page_state = self._staged.pop(block_number)
            self._meta.update(meta_state)
            self._pages.update(page_state)

    def rollback(self, block_number: int) -> None:
        with self._lock:
            self._staged.pop(block_number, None)
            self.backend.rollback(block_number)

    def close(self) -> None:
        self.backend.close()

    def flush_caches(self) -> None:
        with self._lock:
            self._meta.clear()
            self._pages.clear()
