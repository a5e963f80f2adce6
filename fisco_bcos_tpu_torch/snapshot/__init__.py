"""State snapshot / checkpoint subsystem.

Turns "join/recover" from O(chain length) block replay into O(state size)
batched hashing: a node exports chunked, Merkle-committed snapshots of its
state at checkpoint heights (export.py -> store.py), serves them over the
`ModuleID.SnapshotSync` front module (service.py), lets far-behind joiners
verify + install them in one batched hash pass (importer.py, driven by
sync/sync.py's snap-sync mode), and prunes block bodies below durable
checkpoints so disks stop growing without bound.
"""

from .export import export_snapshot, SnapshotExportError
from .importer import (install_snapshot, snap_sync, verify_snapshot,
                       SnapshotVerifyError)
from .manifest import SnapshotManifest, pack_chunks, unpack_chunk
from .service import SnapshotService
from .store import SnapshotStore

__all__ = [
    "SnapshotManifest", "SnapshotService", "SnapshotStore",
    "SnapshotExportError", "SnapshotVerifyError",
    "export_snapshot", "install_snapshot", "snap_sync", "verify_snapshot",
    "pack_chunks", "unpack_chunk",
]
