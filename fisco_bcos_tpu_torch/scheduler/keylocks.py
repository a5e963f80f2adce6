"""GraphKeyLocks — cross-contract key locking with deadlock detection.

Reference counterpart: FISCO-BCOS bcos-scheduler/src/GraphKeyLocks.cpp
(+ test/testKeyLocks.cpp semantics): DMC execution shards transactions by
contract; when a transaction's call chain crosses into another contract it
must hold that contract's key locks, and a cycle in the wait-for graph means
deadlock — the scheduler reverts one participant and re-runs it in a later
round (BlockExecutive.cpp:861 DMCExecute loop).

Locks are (contract, key) -> holder tx. A tx may hold many keys (re-entrant
per tx). `acquire` either grants, or registers a wait edge and reports
whether waiting would close a cycle (deadlock): the *requesting* tx is then
the designated victim, matching the reference's revert-the-requester
strategy.
"""

from __future__ import annotations

import threading
from typing import Hashable, Optional

LockId = tuple[bytes, bytes]  # (contract, key)


class DeadlockError(Exception):
    def __init__(self, tx: Hashable, cycle: list[Hashable]):
        super().__init__(f"deadlock: tx {tx!r} in cycle {cycle!r}")
        self.tx = tx
        self.cycle = cycle


class GraphKeyLocks:
    def __init__(self):
        self._holders: dict[LockId, Hashable] = {}
        self._held: dict[Hashable, set[LockId]] = {}
        self._waiting: dict[Hashable, LockId] = {}  # tx -> lock it waits on
        self._cv = threading.Condition()

    # -- wait-for graph ----------------------------------------------------
    def _would_deadlock(self, tx: Hashable, lock: LockId) -> Optional[list]:
        """Follow holder->waiting edges from `lock`; a path back to tx is a
        cycle."""
        path = [tx]
        cur = self._holders.get(lock)
        while cur is not None:
            if cur == tx:
                return path
            path.append(cur)
            nxt = self._waiting.get(cur)
            if nxt is None:
                return None
            cur = self._holders.get(nxt)
        return None

    # -- public API --------------------------------------------------------
    def try_acquire(self, tx: Hashable, contract: bytes, key: bytes) -> bool:
        """Non-blocking: grant if free or already ours; False if held."""
        lock = (contract, key)
        with self._cv:
            holder = self._holders.get(lock)
            if holder is None or holder == tx:
                self._holders[lock] = tx
                self._held.setdefault(tx, set()).add(lock)
                return True
            return False

    def acquire(self, tx: Hashable, contract: bytes, key: bytes,
                timeout: float = 5.0) -> None:
        """Blocking acquire; raises DeadlockError if waiting closes a cycle
        (the caller must revert tx and release its locks)."""
        lock = (contract, key)
        with self._cv:
            while True:
                holder = self._holders.get(lock)
                if holder is None or holder == tx:
                    self._holders[lock] = tx
                    self._held.setdefault(tx, set()).add(lock)
                    self._waiting.pop(tx, None)
                    return
                cycle = self._would_deadlock(tx, lock)
                if cycle is not None:
                    self._waiting.pop(tx, None)
                    raise DeadlockError(tx, cycle)
                self._waiting[tx] = lock
                if not self._cv.wait(timeout):
                    self._waiting.pop(tx, None)
                    raise TimeoutError(f"key lock wait timed out: {lock!r}")

    def release_all(self, tx: Hashable) -> None:
        with self._cv:
            for lock in self._held.pop(tx, set()):
                if self._holders.get(lock) == tx:
                    del self._holders[lock]
            self._waiting.pop(tx, None)
            self._cv.notify_all()

    def holder_of(self, contract: bytes, key: bytes) -> Optional[Hashable]:
        with self._cv:
            return self._holders.get((contract, key))

    def held_by(self, tx: Hashable) -> set[LockId]:
        with self._cv:
            return set(self._held.get(tx, set()))
