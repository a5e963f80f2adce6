"""Snapshot manifest + chunk codec — the on-wire/on-disk snapshot format.

A snapshot is the full public KV state at a checkpoint height H, split into
fixed-budget chunks of (table, key, value) records. Integrity is one root
check (the 2407.03511 shape: chunked, Merkle-committed bulk data):

    chunk_hashes = suite.hash_batch(chunks)        # ONE batched call
    root         = suite.merkle_root(chunk_hashes)

and the manifest binds that root to the chain by carrying the checkpoint
BlockHeader (with its commit seals): an importer verifies the seals against
its genesis-rooted sealer set (sync/sync.py `_verify_seals`), then requires
the installed chunk content to contain exactly that header at H — so the
chunk payload is anchored to the sealed `state_root` lineage, and the tail
replay above H re-verifies every subsequent block the normal way.

Wire/disk layout (deterministic codec, codec/wire.py):

  manifest = u16 version | i64 height | blob header (BlockHeader.encode)
           | blob root | u64 total_bytes | seq<blob chunk_hash>
  chunk    = seq< text table | blob key | blob value >
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Iterator

from ..codec.wire import Reader, Writer

MANIFEST_VERSION = 1

# node-private tables never leave the node: a snapshot must carry the state
# of the CHAIN, not the exporter's in-flight PBFT round (installing a peer's
# consensus log would make the importer vote with someone else's memory).
# Exact names, NOT a "c_" prefix: c_balance / c_auth / c_account are
# consensus-replicated chain state (executor/precompiled.py) and MUST
# travel, while c_pbft_log (consensus/pbft/storage.py) must not.
PRIVATE_TABLES = frozenset({"c_pbft_log"})


def is_private_table(table: str) -> bool:
    return table in PRIVATE_TABLES


@dataclasses.dataclass
class SnapshotManifest:
    height: int
    header_bytes: bytes  # checkpoint BlockHeader.encode() (with seals)
    root: bytes  # suite.merkle_root over chunk_hashes
    chunk_hashes: list[bytes]
    total_bytes: int = 0
    version: int = MANIFEST_VERSION

    @property
    def chunk_count(self) -> int:
        return len(self.chunk_hashes)

    def encode(self) -> bytes:
        w = Writer()
        (w.u16(self.version).i64(self.height).blob(self.header_bytes)
         .blob(self.root).u64(self.total_bytes))
        w.seq(self.chunk_hashes, lambda ww, h: ww.blob(h))
        return w.bytes()

    @classmethod
    def decode(cls, data: bytes) -> "SnapshotManifest":
        r = Reader(data)
        version = r.u16()
        if version != MANIFEST_VERSION:
            raise ValueError(f"unknown snapshot manifest version {version}")
        return cls(height=r.i64(), header_bytes=r.blob(), root=r.blob(),
                   total_bytes=r.u64(),
                   chunk_hashes=r.seq(lambda rr: rr.blob()),
                   version=version)


def pack_chunks(rows: Iterable[tuple[str, bytes, bytes]],
                chunk_bytes: int) -> list[bytes]:
    """Pack (table, key, value) rows into encoded chunks of ~chunk_bytes.

    Budget is on the raw row payload (a record's framing overhead is a few
    bytes); every chunk holds at least one row so an oversized value can
    never wedge the packer.
    """
    chunks: list[bytes] = []
    pending: list[tuple[str, bytes, bytes]] = []
    size = 0
    for table, key, value in rows:
        row_sz = len(table) + len(key) + len(value)
        if pending and size + row_sz > chunk_bytes:
            chunks.append(_encode_chunk(pending))
            pending, size = [], 0
        pending.append((table, key, value))
        size += row_sz
    if pending:
        chunks.append(_encode_chunk(pending))
    return chunks


def _encode_chunk(rows: list[tuple[str, bytes, bytes]]) -> bytes:
    w = Writer()
    w.seq(rows, lambda ww, row: ww.text(row[0]).blob(row[1]).blob(row[2]))
    return w.bytes()


def unpack_chunk(chunk: bytes) -> list[tuple[str, bytes, bytes]]:
    return Reader(chunk).seq(lambda rr: (rr.text(), rr.blob(), rr.blob()))


def iter_rows(chunks: Iterable[bytes]) -> Iterator[tuple[str, bytes, bytes]]:
    for chunk in chunks:
        yield from unpack_chunk(chunk)
