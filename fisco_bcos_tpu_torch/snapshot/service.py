"""SnapshotService — periodic checkpoint worker + SnapshotSync server.

The node-side home of the snapshot subsystem: every `interval` committed
blocks it exports a chunked snapshot (export.py), persists it in the
SnapshotStore, enforces `retention`, and — when `prune` is on — drops block
bodies below the checkpoint and compacts the WAL, turning disk growth from
O(history) into O(state + retention * snapshot).

It also serves the `ModuleID.SnapshotSync` front module so lagging peers
can snap-sync instead of replaying the chain (importer.py is the client
side, driven by sync/sync.py).
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from ..codec.wire import Reader
from ..utils.log import LOG, badge
from ..utils.metrics import REGISTRY
from ..utils.worker import Worker
from .export import DEFAULT_CHUNK_BYTES, SnapshotExportError, export_snapshot
from .importer import LATEST, OP_CHUNK, OP_MANIFEST
from .manifest import SnapshotManifest
from .store import SnapshotStore


class SnapshotService(Worker):
    # blocks of replayable history kept above the prune floor: a peer only
    # a few blocks behind must catch up via cheap tail replay, not a full
    # O(state) snapshot transfer — two BlockSync request windows by default
    DEFAULT_KEEP_TAIL = 64

    def __init__(self, storage, ledger, suite, front=None,
                 interval: int = 0, retention: int = 2,
                 chunk_bytes: int = DEFAULT_CHUNK_BYTES,
                 prune: bool = False, keep_tail: int = DEFAULT_KEEP_TAIL,
                 keep_nonces: Optional[int] = None,
                 store_dir: Optional[str] = None, registry=None):
        super().__init__("snapshot", idle_wait=0.25)
        # metrics sink: multi-group nodes pass a group-labeled view
        self._reg = registry if registry is not None else REGISTRY
        self.storage = storage
        self.ledger = ledger
        self.suite = suite
        self.interval = interval
        self.retention = max(1, retention)
        self.chunk_bytes = chunk_bytes
        self.prune = prune
        self.keep_tail = max(0, keep_tail)
        self.keep_nonces = keep_nonces
        self.store = SnapshotStore(store_dir)
        self._lock = threading.Lock()
        self._last_export_ms: Optional[int] = None
        if front is not None:
            from ..net.moduleid import ModuleID
            front.register_module(ModuleID.SnapshotSync, self._on_message)
        latest = self.store.latest()
        if latest is not None:
            self._publish_gauges(latest)

    # -- periodic checkpointing -------------------------------------------
    def execute_worker(self) -> None:
        if self.interval <= 0:
            return
        current = self.ledger.current_number()
        last = self.store.latest_height()
        due = (last is None and current >= self.interval) or \
            (last is not None and current >= last + self.interval)
        if due:
            self.checkpoint()

    def checkpoint(self) -> Optional[SnapshotManifest]:
        """Export + persist a snapshot at the current height; prune below
        it when pruning is enabled. Safe to call directly (ops tooling)."""
        with self._lock:
            t0 = time.monotonic()
            try:
                manifest, chunks = export_snapshot(
                    self.storage, self.ledger, self.suite, self.chunk_bytes)
            except SnapshotExportError as exc:
                LOG.warning(badge("SNAP", "export-failed", error=str(exc)))
                return None
            self.store.save(manifest, chunks)
            self.store.retain(self.retention)
            self._last_export_ms = int((time.monotonic() - t0) * 1000)
            prune_floor = manifest.height - self.keep_tail
            if self.prune and prune_floor > 0:
                # the snapshot is durable — history below it is redundant;
                # keep_tail blocks stay replayable so slightly-lagging
                # peers never get forced into a full snap-sync
                self.ledger.prune_block_data(
                    prune_floor, keep_nonces=self.keep_nonces)
                compact = getattr(self.storage, "compact", None)
                if compact is not None:
                    compact()  # rewrite the snapshot file, truncate the WAL
            self._publish_gauges(manifest)
            return manifest

    def _publish_gauges(self, manifest: SnapshotManifest) -> None:
        self._reg.set_gauge("bcos_snapshot_last_number", manifest.height)
        self._reg.set_gauge("bcos_snapshot_chunks", manifest.chunk_count)
        self._reg.set_gauge("bcos_snapshot_bytes", manifest.total_bytes)
        self._reg.set_gauge("bcos_snapshot_pruned_below",
                           self.ledger.pruned_below())
        if self._last_export_ms is not None:
            self._reg.observe("bcos_snapshot_export_seconds",
                             self._last_export_ms / 1000.0)

    # -- SnapshotSync serving ----------------------------------------------
    def _on_message(self, src: bytes, payload: bytes, respond) -> None:
        if respond is None:
            return  # module is request/response only
        try:
            r = Reader(payload)
            op, height, index = r.u8(), r.i64(), r.u32()
        except ValueError:
            return
        if op == OP_MANIFEST:
            if height == LATEST:
                h = self.store.latest_height()
                height = h if h is not None else LATEST
            manifest = self.store.manifest(height) \
                if height != LATEST else None
            respond(manifest.encode() if manifest else b"")
        elif op == OP_CHUNK:
            chunk = self.store.chunk(height, index)
            respond(chunk if chunk is not None else b"")

    # -- adopted snapshots (snap-synced nodes become servers) --------------
    def adopt(self, manifest: SnapshotManifest, chunks: list[bytes]) -> None:
        """Persist a snapshot this node just installed FROM a peer, so the
        next joiner can fetch it from us (pruned chains stay servable
        end-to-end)."""
        self.store.save(manifest, chunks)
        self.store.retain(self.retention)
        self._publish_gauges(manifest)

    # -- observability -----------------------------------------------------
    def status(self) -> dict:
        latest = self.store.latest()
        return {
            "enabled": self.interval > 0,
            "interval": self.interval,
            "retention": self.retention,
            "prune": self.prune,
            "snapshotHeights": self.store.heights(),
            "lastSnapshotNumber": latest.height if latest else None,
            "chunks": latest.chunk_count if latest else 0,
            "bytes": latest.total_bytes if latest else 0,
            "root": "0x" + latest.root.hex() if latest else None,
            "prunedBelow": self.ledger.pruned_below(),
            "lastExportMs": self._last_export_ms,
        }
