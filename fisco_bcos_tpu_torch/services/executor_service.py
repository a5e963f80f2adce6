"""Executor as a service: block execution in a separate process.

Reference counterpart: Max-mode's scale-out executors —
bcos-scheduler/src/ExecutorManager.cpp + TarsExecutorManager.cpp manage a
pool of remote ParallelTransactionExecutorInterface servants
(fisco-bcos-tars-service/ExecutorService/); the scheduler ships transaction
batches over RPC and drives 2PC. Here `ExecutorServer` hosts a
TransactionExecutor (+ DMC wave scheduling) against any storage — typically
a RemoteStorage pointing at the storage service — and `RemoteExecutor`
is the scheduler-side proxy with the executor-manager's seq/term switching
hook (SwitchExecutorManager.h): a bumped term discards cached state, the
recovery path after an executor crash/restart.

Protocol: execute ships encoded txs + block context, returns encoded
receipts and the state changeset (the scheduler owns the commit 2PC, as in
Pro mode where storage is node-local).

The frame carries no senders, so the server recovers the block's senders
in one batch (`batch_recover_senders`: one recovery launch a suite chunk
on a device suite) before it executes. The JAX package's server leaves
that to `execute_transaction`, which recovers each sender alone (one
1-lane launch a tx on a device suite); the receipts and the changeset are
the same either way.
"""

from __future__ import annotations

from typing import Sequence

from ..codec.wire import Reader, Writer
from ..executor.executor import TransactionExecutor
from ..protocol import Receipt, Transaction, batch_recover_senders
from ..scheduler.dmc import DmcExecutor
from ..storage.interface import StorageInterface
from ..storage.state import StateStorage
from .rpc import ServiceClient, ServiceServer
from .storage_service import _read_changeset, _write_changeset


class ExecutorServer:
    def __init__(self, suite, storage: StorageInterface,
                 host: str = "127.0.0.1", port: int = 0,
                 use_dmc: bool = True):
        self.suite = suite
        self.storage = storage
        self.executor = TransactionExecutor(suite)
        self.dmc = DmcExecutor(self.executor, suite) if use_dmc else None
        self.term = 0
        self.server = ServiceServer("executor", host, port)
        self.server.register("status", self._status)
        self.server.register("execute", self._execute)
        self.server.register("call", self._call)

    @property
    def port(self) -> int:
        return self.server.port

    def start(self) -> None:
        self.server.start()

    def stop(self) -> None:
        self.server.stop()

    # -- handlers ----------------------------------------------------------
    def _status(self, r: Reader, w: Writer) -> None:
        w.u64(self.term)

    def _execute(self, r: Reader, w: Writer) -> None:
        term = r.u64()
        number = r.i64()
        timestamp = r.i64()
        txs = [Transaction.decode(b)
               for b in r.seq(lambda rr: rr.blob())]
        self.term = max(self.term, term)
        if txs:
            batch_recover_senders(txs, self.suite)
        state = StateStorage(self.storage)
        if self.dmc is not None:
            receipts = self.dmc.execute_block(txs, state, number, timestamp)
        else:
            receipts = self.executor.execute_block_serial(
                txs, state, number, timestamp)
        w.seq(receipts, lambda ww, rc: ww.blob(rc.encode()))
        _write_changeset(w, state.changeset())

    def _call(self, r: Reader, w: Writer) -> None:
        tx = Transaction.decode(r.blob())
        number = r.i64()
        timestamp = r.i64()
        state = StateStorage(self.storage)
        rc = self.executor.execute_transaction(tx, state, number, timestamp)
        w.blob(rc.encode())


class RemoteExecutor:
    """Scheduler-side proxy; bump_term() implements the switch/recovery
    semantics of SwitchExecutorManager (stale executors are re-seeded by
    the next execute carrying a higher term)."""

    def __init__(self, host: str, port: int, timeout: float = 120.0):
        self.client = ServiceClient(host, port, timeout)
        self.term = 1

    def bump_term(self) -> None:
        self.term += 1

    def status(self) -> int:
        return self.client.call("status").u64()

    def execute_block(self, txs: Sequence[Transaction], number: int,
                      timestamp: int) -> tuple[list[Receipt], dict]:
        enc = [t.encode() for t in txs]

        def build(w: Writer) -> None:
            w.u64(self.term).i64(number).i64(timestamp)
            w.seq(enc, lambda ww, b: ww.blob(b))

        r = self.client.call("execute", build)
        receipts = [Receipt.decode(b) for b in r.seq(lambda rr: rr.blob())]
        changes = _read_changeset(r)
        return receipts, changes

    def call(self, tx: Transaction, number: int, timestamp: int) -> Receipt:
        r = self.client.call(
            "call", lambda w: w.blob(tx.encode()).i64(number).i64(timestamp))
        return Receipt.decode(r.blob())

    def close(self) -> None:
        self.client.close()
