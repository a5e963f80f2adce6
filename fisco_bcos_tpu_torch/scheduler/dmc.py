"""DMC — deterministic multi-contract sharded block execution.

Reference counterpart: FISCO-BCOS bcos-scheduler/src/DmcExecutor.h:38-80
(per-contract message queue: submit/prepare/go), BlockExecutive.cpp:861
DMCExecute (iterative rounds until every executor reports FINISHED), and
GraphKeyLocks.cpp (cross-contract key locks + deadlock revert). In the
reference this shards transactions **by contract address** across executor
processes (Max mode scales executors horizontally, TarsExecutorManager.cpp).

Determinism first (replicas must derive identical state roots), so the
design composes the reference's two mechanisms differently:

  1. **Static wave planning** (the DAG side, CriticalFields.h:45): txs are
     laid into waves such that any two txs in the same wave either share a
     shard (then they run serially, in block order) or have disjoint
     declared conflict keys (then order cannot matter). Txs whose key set
     is unknowable statically (EVM calls — they may CALL anywhere) are
     global barriers, exactly like the reference's non-parallelizable txs.
  2. **Runtime key locks** (GraphKeyLocks): each tx acquires its declared
     keys before executing — a failed acquisition inside a wave means the
     planner's disjointness was violated (a handler touched an undeclared
     key); the tx is deferred and re-run serially after the wave, in block
     order, so the result is still deterministic. This is the DMC
     revert-and-retry loop with the deadlock case planned away.

Shards execute concurrently (thread pool); per-tx state mutation is
serialised on a state lock because the overlay is shared — the structure
(per-shard serial queues + waves + key locks) is what carries over to the
Pro/Max split where shards become processes owning partitioned state.

Receipts return in block order; the changeset equals the serial schedule's.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

from ..protocol import Receipt, Transaction
from ..storage.state import StateStorage
from ..utils.log import LOG, badge, metric
from .keylocks import GraphKeyLocks


class DmcExecutor:
    """Wave-planned, shard-parallel execution over a TransactionExecutor."""

    def __init__(self, executor, suite, max_workers: int = 8):
        self.executor = executor
        self.suite = suite
        self.max_workers = max_workers

    # -- planning ----------------------------------------------------------
    def plan(self, txs: Sequence[Transaction]) -> list[list[int]]:
        """Waves of tx indices: same-wave txs are shard-serial or
        key-disjoint; opaque txs get singleton waves (global barriers)."""
        waves: list[list[int]] = []
        # per key: (wave of last toucher, its shard); waves are monotone
        last_of_key: dict[bytes, tuple[int, bytes]] = {}
        last_of_shard: dict[bytes, int] = {}
        barrier = -1
        for i, tx in enumerate(txs):
            keys = self.executor._conflict_keys(tx)
            if keys is None:
                w = len(waves)
                waves.append([i])
                barrier = w
                last_of_key.clear()
                last_of_shard.clear()
                continue
            # same shard may share a wave (serial, block order inside the
            # shard); a key shared across shards forces the next wave
            w = max(barrier + 1, last_of_shard.get(tx.to, 0))
            for k in keys:
                lw, lsh = last_of_key.get(k, (-1, tx.to))
                w = max(w, lw if lsh == tx.to else lw + 1)
            while w >= len(waves):
                waves.append([])
            waves[w].append(i)
            last_of_shard[tx.to] = w
            for k in keys:
                last_of_key[k] = (w, tx.to)
        return [wv for wv in waves if wv]

    # -- execution ---------------------------------------------------------
    def execute_block(self, txs: Sequence[Transaction], state: StateStorage,
                      block_number: int, timestamp: int) -> list[Receipt]:
        receipts: list[Optional[Receipt]] = [None] * len(txs)
        locks = GraphKeyLocks()
        state_lock = threading.RLock()
        waves = self.plan(txs)
        deferred_total = 0

        def run_one(i: int) -> bool:
            """Execute tx i if its declared keys are free; False = defer."""
            tx = txs[i]
            token = ("tx", i)
            keys = self.executor._conflict_keys(tx) or []
            # global key scope: declared keys already embed their table
            for k in sorted(keys):
                if not locks.try_acquire(token, b"", k):
                    locks.release_all(token)
                    return False
            try:
                with state_lock:
                    receipts[i] = self.executor.execute_transaction(
                        tx, state, block_number, timestamp)
                return True
            finally:
                locks.release_all(token)

        pool = ThreadPoolExecutor(max_workers=self.max_workers)
        try:
            for wave in waves:
                # group by shard; shards run concurrently, shard-serial inside
                by_shard: dict[bytes, list[int]] = {}
                for i in wave:
                    by_shard.setdefault(txs[i].to, []).append(i)
                deferred: list[int] = []
                dlock = threading.Lock()

                def run_shard(idxs: list[int]):
                    for i in idxs:
                        if not run_one(i):
                            with dlock:
                                deferred.append(i)

                if len(by_shard) <= 1:
                    for idxs in by_shard.values():
                        run_shard(idxs)
                else:
                    futs = [pool.submit(run_shard, idxs)
                            for idxs in by_shard.values()]
                    for f in futs:
                        f.result()
                # planner violation fallback: strictly serial, block order
                for i in sorted(deferred):
                    deferred_total += 1
                    with state_lock:
                        receipts[i] = self.executor.execute_transaction(
                            txs[i], state, block_number, timestamp)
        finally:
            pool.shutdown(wait=True)
        if deferred_total:
            LOG.warning(badge("DMC", "undeclared-conflicts",
                              n=deferred_total))
        metric("dmc.execute", n=len(txs), waves=len(waves),
               deferred=deferred_total)
        return [r for r in receipts]