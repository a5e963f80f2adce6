"""Snapshot import — verify a manifest + chunks, install the state.

Verification chain (everything a joining node checks before trusting the
bytes, reusing the block-sync seal verifier):

  1. the checkpoint header's commit-seal carriage — the legacy 2f+1
     multi-seal list OR one quorum certificate (consensus/qc.py), which
     the manifest binds by carrying the full header bytes — verifies as
     ONE check against the importer's OWN sealer set (genesis-rooted —
     `verify_seals` is BlockSync._verify_seals, never peer-supplied
     data);
  2. every chunk hash (ONE batched `suite.hash_batch` call) matches the
     manifest, and the Merkle root over them matches `manifest.root`;
  3. the installed rows must contain exactly the seal-verified header at H
     (s_number_2_header / s_hash_2_number) and report current_number == H.

Everything above H is then replayed block-by-block by the normal sync path,
which re-verifies seals and replay hashes per block.

Known limit (bulk-state authentication): the commit seals cover the
checkpoint HEADER only, and `header.state_root` is a per-block CHANGESET
commitment, not a cumulative commitment over every table — so nothing in
the consensus artifacts can bind the full chunk contents. A Byzantine
serving peer could pair a genuine sealed header with forged non-header
rows under its own manifest root; step 3 catches forged chain lineage but
not forged account state, and tail replay detects it only where tail
blocks touch the forged rows. Snap-sync therefore authenticates chain
lineage, not bulk state — operators should snap-sync from peers they
run (see README "Trust model"), until headers carry a cumulative state
commitment or the importer cross-checks manifests across peers.

Known limit (weak subjectivity, like every snap-sync design): the seal
check compares the checkpoint header's sealer_list against the importer's
CURRENT consensus set — genesis, for a fresh joiner. If on-chain governance
changed the sealer set since genesis, a fresh joiner cannot authenticate
the checkpoint and `snap_sync` returns None (graceful replay fallback; if
the fleet also pruned, the operator must seed the node from a trusted
snapshot or an unpruned archive peer). Nodes that were live through the
governance change verify fine — their consensus set already moved.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

from ..codec.wire import Writer
from ..ledger.ledger import T_HASH2NUM, T_HEADER, T_STATE, K_CURRENT, _be8
from ..protocol import BlockHeader
from ..utils.log import LOG, badge, metric
from .export import verify_header_binding
from .manifest import SnapshotManifest, is_private_table, unpack_chunk

# wire ops on ModuleID.SnapshotSync (request payloads)
OP_MANIFEST = 0  # u8 op | i64 height (-1 = latest) | u32 0
OP_CHUNK = 1     # u8 op | i64 height | u32 index

LATEST = -1

# resource caps on peer-supplied manifests: the commit seals cover the
# checkpoint HEADER, not the chunk list, so a Byzantine peer could pair a
# genuine header with an absurd chunk inventory — bound what we are willing
# to fetch before per-chunk hashes are checked against the manifest root
MAX_SNAPSHOT_CHUNKS = 1 << 16
MAX_SNAPSHOT_BYTES = 4 << 30
# floor on the transfer rate an honest peer must sustain: the chunk-fetch
# loop gets a wall-clock deadline of total_bytes at this rate (at least
# SNAP_FETCH_MIN_SECONDS), so a Byzantine peer dribbling one chunk per
# request-timeout cannot wedge the download worker for days
MIN_FETCH_BYTES_PER_SEC = 4 << 20
SNAP_FETCH_MIN_SECONDS = 60.0


class SnapshotVerifyError(ValueError):
    pass


def request_payload(op: int, height: int = LATEST, index: int = 0) -> bytes:
    return Writer().u8(op).i64(height).u32(index).bytes()


def verify_snapshot(manifest: SnapshotManifest, chunks: list[bytes], suite,
                    verify_seals: Callable[[BlockHeader], bool],
                    seals_verified: bool = False) -> BlockHeader:
    """Full integrity check; returns the seal-verified checkpoint header.

    Raises SnapshotVerifyError on ANY mismatch — a snapshot is installed
    whole or not at all. `seals_verified=True` skips the 2f+1 quorum batch
    verification (the expensive crypto op) when the caller already ran it
    on this same manifest-bound header (snap_sync authenticates before
    fetching any chunk).
    """
    header = verify_header_binding(manifest)
    if not header.signature_list:
        raise SnapshotVerifyError("checkpoint header carries no seals")
    if not seals_verified and not verify_seals(header):
        raise SnapshotVerifyError(
            f"checkpoint header {manifest.height} failed seal verification")
    if len(chunks) != manifest.chunk_count:
        raise SnapshotVerifyError(
            f"chunk count {len(chunks)} != manifest {manifest.chunk_count}")
    # ONE batched hash call across every fetched chunk
    hashes = suite.hash_batch(chunks) if chunks else []
    for i, (got, want) in enumerate(zip(hashes, manifest.chunk_hashes)):
        if got != want:
            raise SnapshotVerifyError(f"chunk {i} hash mismatch")
    if suite.merkle_root(hashes) != manifest.root:
        raise SnapshotVerifyError("manifest root mismatch")
    return header


def install_snapshot(manifest: SnapshotManifest, chunks: list[bytes],
                     storage, suite,
                     verify_seals: Callable[[BlockHeader], bool],
                     seals_verified: bool = False) -> BlockHeader:
    """Verify then atomically install the snapshot into `storage`.

    On a TransactionalStorage the whole install — every table's rows plus
    tombstones for local rows the snapshot does not carry (a genesis-
    bootstrapped row must not shadow snapshot state) — is ONE prepare/
    commit changeset (one WAL record on WalStorage), so a kill -9 mid-
    install can never leave current_number pointing at half-written
    tables. Plain storages fall back to per-table batches.
    """
    from ..utils import failpoints as fp
    fp.fire("snapshot.install")
    header = verify_snapshot(manifest, chunks, suite, verify_seals,
                             seals_verified=seals_verified)
    hh = header.hash(suite)

    # chunk hashes matching the manifest proves integrity of the TRANSFER,
    # not well-formedness of the content — a Byzantine peer can hash
    # garbage; every decode below must surface as SnapshotVerifyError so
    # the caller's reject-whole/backoff path engages instead of the error
    # escaping to the worker loop
    by_table: dict[str, dict[bytes, bytes]] = {}
    try:
        for chunk in chunks:
            for table, key, value in unpack_chunk(chunk):
                if is_private_table(table):
                    raise SnapshotVerifyError(
                        f"snapshot carries private table {table!r}")
                by_table.setdefault(table, {})[key] = value
    except SnapshotVerifyError:
        raise
    except ValueError as exc:
        raise SnapshotVerifyError(f"malformed chunk content: {exc}") from exc

    # binding checks BEFORE any write touches storage
    head_row = by_table.get(T_HEADER, {}).get(_be8(manifest.height))
    if head_row is None:
        raise SnapshotVerifyError("snapshot lacks its own checkpoint header")
    try:
        head_matches = BlockHeader.decode(head_row).hash(suite) == hh
    except ValueError:
        head_matches = False
    if not head_matches:
        raise SnapshotVerifyError(
            "snapshot header row does not match the seal-verified header")
    if by_table.get(T_HASH2NUM, {}).get(hh) != _be8(manifest.height):
        raise SnapshotVerifyError("snapshot hash->number row inconsistent")
    cur = by_table.get(T_STATE, {}).get(K_CURRENT)
    if cur is None or int.from_bytes(cur, "big") != manifest.height:
        raise SnapshotVerifyError(
            "snapshot current_number does not match the checkpoint height")

    fast = getattr(storage, "install_rows", None)
    if fast is not None:
        # disk engine: rows become fresh sorted segments and ONE manifest
        # edge swaps the entire state — no WAL round-trip of the full
        # snapshot through RAM, and kill -9 anywhere leaves either the
        # old state or exactly the snapshot
        fast(by_table)
        LOG.info(badge("SNAP", "installed", number=manifest.height,
                       chunks=len(chunks), bytes=manifest.total_bytes))
        metric("snapshot.install", number=manifest.height,
               chunks=len(chunks))
        return header

    from ..storage.interface import (Entry, EntryStatus,
                                     TransactionalStorage)
    changes: dict = {}
    for table, rows in by_table.items():
        for k in storage.keys(table):
            if k not in rows:
                changes[(table, k)] = Entry(b"", EntryStatus.DELETED)
        for k, v in rows.items():
            changes[(table, k)] = Entry(v)
    if isinstance(storage, TransactionalStorage):
        # the scheduler's 2PC slots are keyed by block number and a node
        # this far behind cannot be committing the checkpoint height, so
        # the slot is free
        storage.prepare(manifest.height, changes)
        storage.commit(manifest.height)
    else:
        for table, rows in by_table.items():
            stale = [k for k in storage.keys(table) if k not in rows]
            if stale:
                storage.remove_batch(table, stale)
            storage.set_batch(table, rows.items())
    LOG.info(badge("SNAP", "installed", number=manifest.height,
                   chunks=len(chunks), bytes=manifest.total_bytes))
    metric("snapshot.install", number=manifest.height, chunks=len(chunks))
    return header


def snap_sync(front, peer: bytes, storage, suite,
              verify_seals: Callable[[BlockHeader], bool],
              current_number: int, request_timeout: float = 5.0,
              should_abort: Optional[Callable[[], bool]] = None,
              pre_install: Optional[Callable[[], None]] = None,
              registry=None,
              ) -> Optional[tuple[SnapshotManifest, list[bytes]]]:
    """Fetch + verify + install a snapshot from `peer` over the
    ModuleID.SnapshotSync front module.

    Returns (manifest, chunks) on success (so the caller can re-serve the
    snapshot to the next joiner), None when the peer has nothing newer or
    any fetch/verify step fails — the caller falls back to block replay.

    `should_abort` is polled between chunk fetches and before the install
    writes storage: the multi-minute fetch loop must yield to Node.stop()
    — an abandoned download thread that outlives shutdown would otherwise
    commit the install into a WAL the daemon already flushed and closed.
    """
    from ..net.moduleid import ModuleID

    t0 = time.monotonic()
    raw = front.request(ModuleID.SnapshotSync, peer,
                        request_payload(OP_MANIFEST),
                        timeout=request_timeout)
    if not raw:
        return None
    try:
        manifest = SnapshotManifest.decode(raw)
        header = verify_header_binding(manifest)
    except ValueError:
        LOG.warning(badge("SNAP", "bad-manifest", peer=peer[:8].hex()))
        return None
    if manifest.height <= current_number:
        return None  # nothing to gain over our own chain
    # authenticate BEFORE fetching a single chunk byte: the seals prove the
    # header is canonical, and the resource caps bound what an attacker can
    # make us download against a forged chunk inventory
    if not header.signature_list or not verify_seals(header):
        LOG.warning(badge("SNAP", "unsealed-manifest", peer=peer[:8].hex(),
                          number=manifest.height))
        return None
    if (manifest.chunk_count > MAX_SNAPSHOT_CHUNKS
            or manifest.total_bytes > MAX_SNAPSHOT_BYTES):
        LOG.warning(badge("SNAP", "manifest-too-large",
                          chunks=manifest.chunk_count,
                          bytes=manifest.total_bytes))
        return None
    chunks: list[bytes] = []
    fetched = 0
    deadline = t0 + max(SNAP_FETCH_MIN_SECONDS,
                        manifest.total_bytes / MIN_FETCH_BYTES_PER_SEC)
    for i in range(manifest.chunk_count):
        if should_abort is not None and should_abort():
            LOG.info(badge("SNAP", "fetch-aborted", number=manifest.height,
                           index=i))
            return None
        if time.monotonic() > deadline:
            # seals cover the header, not the chunk inventory — a peer
            # trickling forged chunks must not hold the worker hostage
            LOG.warning(badge("SNAP", "fetch-deadline",
                              number=manifest.height, index=i,
                              bytes=fetched))
            return None
        chunk = front.request(ModuleID.SnapshotSync, peer,
                              request_payload(OP_CHUNK, manifest.height, i),
                              timeout=request_timeout)
        if not chunk:
            LOG.warning(badge("SNAP", "chunk-fetch-failed",
                              number=manifest.height, index=i))
            return None
        fetched += len(chunk)
        if fetched > manifest.total_bytes:
            # the peer is serving more bytes than its manifest declared —
            # the hash check would reject it anyway; stop paying for it
            LOG.warning(badge("SNAP", "chunk-overrun",
                              number=manifest.height, index=i))
            return None
        chunks.append(chunk)
    if should_abort is not None and should_abort():
        # last exit before storage writes: never install into a storage
        # that shutdown is about to (or already did) flush and close
        LOG.info(badge("SNAP", "install-aborted", number=manifest.height))
        return None
    if pre_install is not None:
        # serving caches must be empty BEFORE the install commit publishes
        # the new state — the post-install invalidation (external_commit)
        # alone leaves a window where a reader sees the installed head but
        # a cache still serves pre-install blocks. (The second, post-
        # install invalidation fences out renders in flight across the
        # commit.)
        pre_install()
    try:
        # the quorum was batch-verified on this same header pre-fetch —
        # don't pay for it a second time on the install path
        install_snapshot(manifest, chunks, storage, suite, verify_seals,
                         seals_verified=True)
    except SnapshotVerifyError as exc:
        LOG.warning(badge("SNAP", "verify-failed", peer=peer[:8].hex(),
                          error=str(exc)))
        return None
    secs = time.monotonic() - t0
    metric("snapshot.snap_sync", number=manifest.height,
           ms=int(secs * 1000))
    from ..utils.metrics import REGISTRY
    (registry or REGISTRY).set_gauge("bcos_snap_sync_seconds",
                                     round(secs, 3))
    return manifest, chunks
