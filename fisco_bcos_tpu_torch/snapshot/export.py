"""Snapshot export — a consistent chunked copy of the state at height H.

The capture holds the backend storage's lock (both WalStorage and
MemoryStorage expose `_lock`) while it walks the tables, so a block commit
cannot interleave half-applied writes into the copy; the chunking and the
single batched hash run OUTSIDE the lock. Storages without a lock get the
optimistic fallback: re-check `current_number` after the walk and retry —
every block commit moves it, so a torn capture is always detected.

All chunk hashing is ONE `suite.hash_batch` call per manifest (the batched
Keccak/SM3 path the paper accelerates); the manifest root is one
`suite.merkle_root` over those digests.

Cost note: the locked walk copies row REFERENCES (no byte copies), so the
commit stall is O(rows) pointer work per checkpoint. On a pruning node
rows ~ state size and this is negligible; an archive node (prune=false)
walks its full tx/receipt history each checkpoint — widen `interval`
there, or prune and delegate history to dedicated archive tooling.
"""

from __future__ import annotations

import contextlib
import time

from ..protocol import BlockHeader
from ..utils import failpoints as _fp
from ..utils.log import LOG, badge, metric
from .manifest import SnapshotManifest, is_private_table, pack_chunks

DEFAULT_CHUNK_BYTES = 1 << 20

# checkpoint fault sites (utils/failpoints.py): export fires before the
# capture, install before any verification/mutation
_fp.register("snapshot.export", "snapshot.install")


class SnapshotExportError(RuntimeError):
    pass


def _storage_tables(storage) -> list[str]:
    tables = getattr(storage, "tables", None)
    if tables is None:
        raise SnapshotExportError(
            f"{type(storage).__name__} cannot enumerate tables; snapshot "
            "export needs a storage with .tables()")
    return list(tables())


def _capture_rows(storage, ledger):
    """-> (height, header_bytes, rows). `rows` is a list for plain
    storages (copied under the caller's lock) but a LAZY stream for the
    disk engine: `capture_rows` freezes a consistent view (memtable copy
    + pinned immutable segments) in O(memtable) under the lock, and the
    actual bytes stream straight from the segments when the chunk packer
    iterates — after the caller has released the lock, so commits keep
    flowing during a multi-second export of a big on-disk state."""
    height = ledger.current_number()
    header = ledger.header_by_number(height)
    cap = getattr(storage, "capture_rows", None)
    if cap is not None:
        rows = (row for row in cap() if not is_private_table(row[0]))
    else:
        rows = []
        for table in sorted(_storage_tables(storage)):
            if is_private_table(table):
                continue
            for key in storage.keys(table):
                value = storage.get(table, key)
                if value is not None:
                    rows.append((table, key, value))
    return height, header.encode() if header else None, rows


def export_snapshot(storage, ledger, suite,
                    chunk_bytes: int = DEFAULT_CHUNK_BYTES,
                    max_attempts: int = 5) -> tuple[SnapshotManifest,
                                                    list[bytes]]:
    """-> (manifest, chunks) for the CURRENT committed height.

    The checkpoint header travels in the manifest with its commit seals, so
    an importer can verify it against its own sealer set before trusting a
    single chunk byte.
    """
    _fp.fire("snapshot.export")
    t0 = time.monotonic()
    lock = getattr(storage, "_lock", None)
    for attempt in range(max_attempts):
        with lock if lock is not None else contextlib.nullcontext():
            height, header_bytes, rows = _capture_rows(storage, ledger)
        if height < 0 or header_bytes is None:
            raise SnapshotExportError("no committed chain to snapshot")
        if lock is None and ledger.current_number() != height:
            continue  # commit raced the walk: torn capture, retry
        chunks = pack_chunks(rows, chunk_bytes)
        # ONE batched hash call for every chunk of the manifest
        chunk_hashes = suite.hash_batch(chunks) if chunks else []
        root = suite.merkle_root(chunk_hashes)
        manifest = SnapshotManifest(
            height=height, header_bytes=header_bytes, root=root,
            chunk_hashes=chunk_hashes,
            total_bytes=sum(len(c) for c in chunks))
        ms = int((time.monotonic() - t0) * 1000)
        LOG.info(badge("SNAP", "exported", number=height,
                       chunks=len(chunks), bytes=manifest.total_bytes,
                       ms=ms))
        metric("snapshot.export", number=height, chunks=len(chunks),
               bytes=manifest.total_bytes, ms=ms)
        return manifest, chunks
    raise SnapshotExportError(
        f"could not capture a consistent snapshot in {max_attempts} "
        "attempts (commits kept racing the table walk)")


def verify_header_binding(manifest: SnapshotManifest) -> BlockHeader:
    """Decode + sanity-check the manifest's checkpoint header."""
    header = BlockHeader.decode(manifest.header_bytes)
    if header.number != manifest.height:
        raise ValueError(
            f"manifest height {manifest.height} != header number "
            f"{header.number}")
    return header
