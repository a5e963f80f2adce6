"""SnapshotStore — durable (or in-memory) home for exported snapshots.

Disk layout (under `<dir>/`):

    <height>/manifest.bin
    <height>/chunk-<index>.bin

Writes go through a `.tmp` directory + atomic rename so a crash mid-export
can never leave a half-snapshot that a peer would serve; `latest()` only
ever sees fully-renamed snapshot dirs. In-memory mode (dir=None) backs
embedded/test nodes with the same API.
"""

from __future__ import annotations

import os
import shutil
import threading
from typing import Optional

from ..analysis import lockcheck as _lc
from ..utils import failpoints as _fp
from ..utils.log import LOG, badge
from .manifest import SnapshotManifest

_fp.register("snapshot.store.save")


class SnapshotStore:
    def __init__(self, directory: Optional[str] = None):
        self.directory = directory
        self._lock = threading.Lock()
        self._mem: dict[int, tuple[SnapshotManifest, list[bytes]]] = {}
        if directory:
            os.makedirs(directory, exist_ok=True)
            # a crashed export leaves only .tmp dirs — sweep them
            for name in os.listdir(directory):
                if name.endswith(".tmp"):
                    shutil.rmtree(os.path.join(directory, name),
                                  ignore_errors=True)

    # -- writes ------------------------------------------------------------
    def save(self, manifest: SnapshotManifest, chunks: list[bytes]) -> None:
        if self.directory is None:
            with self._lock:
                self._mem[manifest.height] = (manifest, list(chunks))
            return
        _lc.note_blocking("fsync", "SnapshotStore.save")
        _fp.fire("snapshot.store.save")
        final = os.path.join(self.directory, str(manifest.height))
        if os.path.isdir(final):
            return  # idempotent: same height == same content
        # the slow part — per-chunk write+fsync, multi-second for a large
        # state — runs OUTSIDE the lock: a joiner mid-snap-sync must keep
        # getting chunk() answers while the checkpoint worker persists, or
        # its 5 s request timeouts abort the whole transfer. The tmp name
        # is per-thread so concurrent saves never collide; only the atomic
        # publish takes the lock.
        tmp = f"{final}.{threading.get_ident()}.tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        # every byte fsynced BEFORE the rename publishes the snapshot:
        # the service prunes history the moment save() returns, so a
        # torn chunk after power loss would leave a chain that can
        # neither serve replay (pruned) nor snap-sync (corrupt)
        for i, chunk in enumerate(chunks):
            with open(os.path.join(tmp, f"chunk-{i}.bin"), "wb") as f:
                f.write(chunk)
                f.flush()
                os.fsync(f.fileno())
        with open(os.path.join(tmp, "manifest.bin"), "wb") as f:
            f.write(manifest.encode())
            f.flush()
            os.fsync(f.fileno())
        with self._lock:
            if os.path.isdir(final):  # lost a same-height race: same content
                shutil.rmtree(tmp, ignore_errors=True)
                return
            os.replace(tmp, final)
            dirfd = os.open(self.directory, os.O_RDONLY)
            try:
                os.fsync(dirfd)  # persist the rename itself
            finally:
                os.close(dirfd)

    def retain(self, keep: int) -> list[int]:
        """Drop all but the newest `keep` snapshots; returns dropped heights."""
        with self._lock:
            heights = sorted(self._heights())
            drop = heights[:-keep] if keep > 0 else heights
            for h in drop:
                if self.directory is None:
                    self._mem.pop(h, None)
                else:
                    shutil.rmtree(os.path.join(self.directory, str(h)),
                                  ignore_errors=True)
        if drop:
            LOG.info(badge("SNAP", "retention", dropped=drop, keep=keep))
        return drop

    # -- reads -------------------------------------------------------------
    def _heights(self) -> list[int]:
        if self.directory is None:
            return list(self._mem)
        out = []
        for name in os.listdir(self.directory):
            if name.isdigit() and os.path.isfile(
                    os.path.join(self.directory, name, "manifest.bin")):
                out.append(int(name))
        return out

    def heights(self) -> list[int]:
        with self._lock:
            return sorted(self._heights())

    def latest_height(self) -> Optional[int]:
        hs = self.heights()
        return hs[-1] if hs else None

    def manifest(self, height: int) -> Optional[SnapshotManifest]:
        with self._lock:
            if self.directory is None:
                ent = self._mem.get(height)
                return ent[0] if ent else None
            path = os.path.join(self.directory, str(height), "manifest.bin")
            try:
                with open(path, "rb") as f:
                    return SnapshotManifest.decode(f.read())
            except (OSError, ValueError):
                return None

    def chunk(self, height: int, index: int) -> Optional[bytes]:
        with self._lock:
            if self.directory is None:
                ent = self._mem.get(height)
                if ent is None or not 0 <= index < len(ent[1]):
                    return None
                return ent[1][index]
            path = os.path.join(self.directory, str(height),
                                f"chunk-{index}.bin")
            try:
                with open(path, "rb") as f:
                    return f.read()
            except OSError:
                return None

    def latest(self) -> Optional[SnapshotManifest]:
        h = self.latest_height()
        return self.manifest(h) if h is not None else None
