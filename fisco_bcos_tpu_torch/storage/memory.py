"""In-memory transactional storage (tests + light deployments).

Counterpart of the reference's StateStorage-as-backend test pattern
(bcos-framework/bcos-framework/testutils/faker/FakeKVStorage.h) and the
cache layer in libinitializer/StorageInitializer.h.
"""

from __future__ import annotations

from typing import Iterator, Optional

from ..analysis import lockcheck as lc
from .interface import ChangeSet, TransactionalStorage


class MemoryStorage(TransactionalStorage):
    def __init__(self):
        self._tables: dict[str, dict[bytes, bytes]] = {}
        self._prepared: dict[int, ChangeSet] = {}
        self._lock = lc.make_rlock("storage.memory")

    # -- reads/writes ------------------------------------------------------
    def get(self, table: str, key: bytes) -> Optional[bytes]:
        with self._lock:
            return self._tables.get(table, {}).get(key)

    def set(self, table: str, key: bytes, value: bytes) -> None:
        with self._lock:
            self._tables.setdefault(table, {})[key] = value

    def remove(self, table: str, key: bytes) -> None:
        with self._lock:
            self._tables.get(table, {}).pop(key, None)

    def keys(self, table: str, prefix: bytes = b"") -> Iterator[bytes]:
        with self._lock:
            ks = sorted(k for k in self._tables.get(table, {})
                        if k.startswith(prefix))
        return iter(ks)

    def tables(self) -> list[str]:
        """Live table names (snapshot export, operator tooling)."""
        with self._lock:
            return sorted(self._tables)

    # -- 2PC ---------------------------------------------------------------
    def prepare(self, block_number: int, changes: ChangeSet) -> None:
        with self._lock:
            self._prepared[block_number] = dict(changes)

    def commit(self, block_number: int) -> None:
        with self._lock:
            cs = self._prepared.pop(block_number)
            for (table, key), entry in cs.items():
                if entry.deleted:
                    self._tables.get(table, {}).pop(key, None)
                else:
                    self._tables.setdefault(table, {})[key] = entry.value

    def rollback(self, block_number: int) -> None:
        with self._lock:
            self._prepared.pop(block_number, None)
