"""NamespacedStorage — per-group table namespace over one shared storage.

Multi-group deployments (init/group.py GroupManager, the daemon's [groups]
wiring) run G independent ledgers in one process. Giving each group its own
view over ONE underlying `TransactionalStorage` (one WAL file, one fsync
stream, one crash-recovery pass) is the reference's storage layering for
multi-group nodes: tables are prefixed `g/<group>/`, and the 2PC block ids
are folded into a per-group id space so two groups preparing the same
height never collide. Everything behind the wrapper — WAL replay, 2PC
semantics, compaction — is the base storage's, untouched.
"""

from __future__ import annotations

import zlib
from typing import Iterable, Iterator, Optional

from .interface import ChangeSet, TransactionalStorage

_PREFIX = "g/"


def namespace_block_id(namespace: str, block_number: int) -> int:
    """Fold a group namespace into the 2PC block id: the base storage keys
    its prepared changesets by int, and two groups legitimately prepare
    the same height concurrently. The crc is a stable 16-bit group tag;
    heights stay ordered within a group (WAL records are informational
    about the number, replay order is append order)."""
    tag = zlib.crc32(namespace.encode()) & 0xFFFF
    return (tag << 47) | (block_number & ((1 << 47) - 1))


class NamespacedStorage(TransactionalStorage):
    def __init__(self, base: TransactionalStorage, namespace: str):
        self.base = base
        self.namespace = namespace
        self._p = f"{_PREFIX}{namespace}/"

    def _t(self, table: str) -> str:
        return self._p + table

    # -- reads/writes ------------------------------------------------------
    def get(self, table: str, key: bytes) -> Optional[bytes]:
        return self.base.get(self._t(table), key)

    def set(self, table: str, key: bytes, value: bytes) -> None:
        self.base.set(self._t(table), key, value)

    def remove(self, table: str, key: bytes) -> None:
        self.base.remove(self._t(table), key)

    def keys(self, table: str, prefix: bytes = b"") -> Iterator[bytes]:
        return self.base.keys(self._t(table), prefix)

    def get_batch(self, table: str, ks: Iterable[bytes]):
        return self.base.get_batch(self._t(table), ks)

    def set_batch(self, table: str, items) -> None:
        self.base.set_batch(self._t(table), items)

    def remove_batch(self, table: str, ks) -> None:
        self.base.remove_batch(self._t(table), ks)

    def tables(self) -> list[str]:
        """This group's live tables, namespace stripped (snapshot export
        and operator tooling see the same names a dedicated store shows)."""
        base_tables = getattr(self.base, "tables", None)
        if base_tables is None:
            return []
        return sorted(t[len(self._p):] for t in base_tables()
                      if t.startswith(self._p))

    # -- 2PC ---------------------------------------------------------------
    def prepare(self, block_number: int, changes: ChangeSet) -> None:
        ns = {(self._t(t), k): e for (t, k), e in changes.items()}
        self.base.prepare(namespace_block_id(self.namespace, block_number),
                          ns)

    def commit(self, block_number: int) -> None:
        self.base.commit(namespace_block_id(self.namespace, block_number))

    def rollback(self, block_number: int) -> None:
        self.base.rollback(namespace_block_id(self.namespace, block_number))
