"""Storage interfaces: table/KV model + two-phase commit contract.

The reference models state as named tables of rows behind
StorageInterface (asyncGetRow/asyncSetRow/asyncGetRows) with a transactional
extension for block commits (asyncPrepare/asyncCommit/asyncRollback,
FISCO-BCOS bcos-framework/bcos-framework/storage/StorageInterface.h:
126-141). Python-side the core is synchronous (KV ops are microseconds;
async belongs at the network layer) — the node's executors/ledger call these
directly, and the scheduler drives 2PC across storage + executors at commit
(bcos-scheduler/src/BlockExecutive.cpp:1265 batchBlockCommit).
"""

from __future__ import annotations

import abc
import dataclasses
import enum
from typing import Iterable, Iterator, Optional


class EntryStatus(enum.IntEnum):
    NORMAL = 0
    DELETED = 1


@dataclasses.dataclass
class Entry:
    """A table row. `value` is opaque bytes (protocol objects serialize
    themselves); DELETED entries are tombstones in overlays/changesets."""

    value: bytes = b""
    status: EntryStatus = EntryStatus.NORMAL

    @property
    def deleted(self) -> bool:
        return self.status == EntryStatus.DELETED


# A changeset maps (table, key) -> Entry (tombstones included).
ChangeSet = dict[tuple[str, bytes], Entry]


class StorageInterface(abc.ABC):
    """Read/write view over named tables."""

    @abc.abstractmethod
    def get(self, table: str, key: bytes) -> Optional[bytes]:
        """Value or None (missing or deleted)."""

    @abc.abstractmethod
    def set(self, table: str, key: bytes, value: bytes) -> None: ...

    @abc.abstractmethod
    def remove(self, table: str, key: bytes) -> None: ...

    @abc.abstractmethod
    def keys(self, table: str, prefix: bytes = b"") -> Iterator[bytes]:
        """Live keys under a prefix (sorted)."""

    # -- batch conveniences (single-call hot paths) ------------------------
    def get_batch(self, table: str, ks: Iterable[bytes]) -> list[Optional[bytes]]:
        return [self.get(table, k) for k in ks]

    def set_batch(self, table: str, items: Iterable[tuple[bytes, bytes]]) -> None:
        for k, v in items:
            self.set(table, k, v)

    def remove_batch(self, table: str, ks: Iterable[bytes]) -> None:
        for k in ks:
            self.remove(table, k)


class TransactionalStorage(StorageInterface):
    """Two-phase commit: stage a changeset per block, then commit/rollback.

    Contract (matching the reference's 2PC over RocksDB/TiKV): after
    `prepare(n, cs)` returns, `commit(n)` must durably apply cs atomically;
    `rollback(n)` discards it. One in-flight prepared block at a time per
    storage (the scheduler serialises block commits).
    """

    @abc.abstractmethod
    def prepare(self, block_number: int, changes: ChangeSet) -> None: ...

    @abc.abstractmethod
    def commit(self, block_number: int) -> None: ...

    @abc.abstractmethod
    def rollback(self, block_number: int) -> None: ...
