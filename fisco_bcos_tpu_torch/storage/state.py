"""StateStorage — an MVCC write overlay over a backend storage.

Counterpart of the reference's bcos-table/src/StateStorage.h: executors and
the ledger write a block's worth of mutations into an overlay; reads fall
through to the backend; at the end the overlay exports a changeset for the
2PC prepare (BlockExecutive.cpp:1265). Nested savepoints give per-transaction
revert (the reference reverts a tx's writes on EVM revert via Recoder —
bcos-table's recoder pattern).
"""

from __future__ import annotations

from typing import Iterator, Optional, Sequence

from .interface import ChangeSet, Entry, EntryStatus, StorageInterface


class StateStorage(StorageInterface):
    def __init__(self, backend: StorageInterface):
        self.backend = backend
        self._writes: ChangeSet = {}
        # savepoint journal: list of (key, previous Entry-or-None) frames
        self._journal: list[list[tuple[tuple[str, bytes], Optional[Entry]]]] = []

    # -- reads -------------------------------------------------------------
    def get(self, table: str, key: bytes) -> Optional[bytes]:
        e = self._writes.get((table, key))
        if e is not None:
            return None if e.deleted else e.value
        return self.backend.get(table, key)

    # -- writes ------------------------------------------------------------
    def _record(self, tk: tuple[str, bytes]) -> None:
        if self._journal:
            prev = self._writes.get(tk)
            self._journal[-1].append(
                (tk, Entry(prev.value, prev.status) if prev else None))

    def set(self, table: str, key: bytes, value: bytes) -> None:
        tk = (table, key)
        self._record(tk)
        self._writes[tk] = Entry(value, EntryStatus.NORMAL)

    def remove(self, table: str, key: bytes) -> None:
        tk = (table, key)
        self._record(tk)
        self._writes[tk] = Entry(b"", EntryStatus.DELETED)

    def keys(self, table: str, prefix: bytes = b"") -> Iterator[bytes]:
        base = set(self.backend.keys(table, prefix))
        for (t, k), e in self._writes.items():
            if t != table or not k.startswith(prefix):
                continue
            if e.deleted:
                base.discard(k)
            else:
                base.add(k)
        return iter(sorted(base))

    # -- savepoints (per-tx revert) ----------------------------------------
    def savepoint(self) -> int:
        self._journal.append([])
        return len(self._journal) - 1

    def rollback_to(self, sp: int) -> None:
        while len(self._journal) > sp:
            frame = self._journal.pop()
            for tk, prev in reversed(frame):
                if prev is None:
                    self._writes.pop(tk, None)
                else:
                    self._writes[tk] = prev

    def release(self, sp: int) -> None:
        """Discard savepoint sp (and any above) keeping its writes; undo
        records fold into the enclosing savepoint, if any."""
        merged: list = []
        while len(self._journal) > sp:
            merged = self._journal.pop() + merged
        if self._journal:
            self._journal[-1].extend(merged)

    # -- export ------------------------------------------------------------
    def changeset(self) -> ChangeSet:
        return dict(self._writes)

    def clear(self) -> None:
        self._writes.clear()
        self._journal.clear()


class StackedStorageView(StorageInterface):
    """Read-only view of committed storage plus a stack of not-yet-committed
    block changesets (oldest first).

    This is what lets the scheduler execute block N+1 speculatively while
    block N's 2PC commit (and WAL fsync) is still in flight: N+1's
    StateStorage overlay reads THROUGH N's changeset, so N+1's own
    changeset — and therefore its per-changeset `state_root` — comes out
    byte-identical to what a strictly serial execute-after-commit would
    have produced. The stack holds plain dict snapshots captured at
    execution end, so a commit that lands (applying the same entries to
    the backend) or fails mid-read can never tear a lookup.
    """

    def __init__(self, backend: StorageInterface,
                 changesets: Sequence[ChangeSet]):
        self.backend = backend
        self._stack = list(changesets)

    def get(self, table: str, key: bytes) -> Optional[bytes]:
        tk = (table, key)
        for cs in reversed(self._stack):
            e = cs.get(tk)
            if e is not None:
                return None if e.deleted else e.value
        return self.backend.get(table, key)

    def keys(self, table: str, prefix: bytes = b"") -> Iterator[bytes]:
        base = set(self.backend.keys(table, prefix))
        for cs in self._stack:
            for (t, k), e in cs.items():
                if t != table or not k.startswith(prefix):
                    continue
                if e.deleted:
                    base.discard(k)
                else:
                    base.add(k)
        return iter(sorted(base))

    def set(self, table: str, key: bytes, value: bytes) -> None:
        raise RuntimeError("StackedStorageView is read-only: block writes "
                           "belong in the StateStorage overlay above it")

    def remove(self, table: str, key: bytes) -> None:
        raise RuntimeError("StackedStorageView is read-only: block writes "
                           "belong in the StateStorage overlay above it")
