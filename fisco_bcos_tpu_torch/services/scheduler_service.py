"""Scheduler as a service: block execution/commit over service RPC.

Reference counterpart: Max mode's SchedulerService slot
(fisco-bcos-tars-service/SchedulerService/ + bcos-tars-protocol client
proxies): consensus runs in one process and drives block execution in
another — the scheduler process owns the storage/executor plane, the
consensus process sees only headers and receipts. `RemoteScheduler`
duck-types the surface PBFT/sync consume (execute_block -> finalised
header, commit_block, call); execution state never crosses the wire, the
finished header's identity (hash) is the 2PC handle, exactly like the
reference's ExecutionMessage-level split.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from ..codec.wire import Reader, Writer
from ..protocol import Block, BlockHeader, Receipt, Transaction, \
    TransactionStatus
from ..utils.log import LOG, badge
from .rpc import ServiceClient, ServiceRemoteError, ServiceServer


@dataclasses.dataclass
class RemoteExecutionResult:
    """What consensus needs from a remote execution: the finalised header
    (roots filled) + receipts; state stays with the scheduler process."""

    header: BlockHeader
    receipts: list[Receipt]


class SchedulerServer:
    def __init__(self, scheduler, host: str = "127.0.0.1", port: int = 0):
        self.scheduler = scheduler
        self.server = ServiceServer("scheduler", host, port)
        s = self.server
        s.register("executeBlock", self._execute)
        s.register("commitBlock", self._commit)
        s.register("dropExecuted", self._drop_executed)
        s.register("call", self._call)

    @property
    def port(self) -> int:
        return self.server.port

    def start(self) -> None:
        self.server.start()

    def stop(self) -> None:
        self.server.stop()

    def _execute(self, r: Reader, w: Writer) -> None:
        block = Block.decode(r.blob())
        has_sealers = r.u8()
        sealer_list = (r.seq(lambda rr: rr.blob()) if has_sealers else None)
        result = self.scheduler.execute_block(block, sealer_list)
        if result is None:
            w.u8(0)
            return
        w.u8(1)
        w.blob(result.header.encode())
        w.seq(result.receipts, lambda ww, rc: ww.blob(rc.encode()))

    def _commit(self, r: Reader, w: Writer) -> None:
        header = BlockHeader.decode(r.blob())
        w.u8(1 if self.scheduler.commit_block(header) else 0)

    def _drop_executed(self, r: Reader, w: Writer) -> None:
        self.scheduler.drop_executed(BlockHeader.decode(r.blob()))
        w.u8(1)

    def _call(self, r: Reader, w: Writer) -> None:
        rc = self.scheduler.call(Transaction.decode(r.blob()))
        w.blob(rc.encode())


class RemoteScheduler:
    """Scheduler proxy for a consensus/sync process (Max split)."""

    def __init__(self, host: str, port: int, timeout: float = 300.0):
        self.client = ServiceClient(host, port, timeout)
        # NOTE: deliberately NO `on_commit` attribute — commit notifications
        # are process-local to the scheduler service (the reference pushes
        # block numbers via the txpool channel, not the scheduler proxy);
        # wiring EventSub against this proxy fails loudly instead of
        # silently never firing

    def execute_block(self, block: Block,
                      sealer_list: Optional[Sequence[bytes]] = None
                      ) -> Optional[RemoteExecutionResult]:
        def build(w: Writer) -> None:
            w.blob(block.encode())
            w.u8(1 if sealer_list is not None else 0)
            if sealer_list is not None:
                w.seq(list(sealer_list), lambda ww, nid: ww.blob(nid))

        # retry=False: execution mutates scheduler state (pending results);
        # a blind resend could double-execute a proposal. Transport/remote
        # failures map to the in-process contract (None) so PBFT/sync state
        # machines keep their failure paths instead of catching exceptions.
        try:
            r = self.client.call("executeBlock", build, retry=False)
        except (ConnectionError, OSError, ServiceRemoteError) as exc:
            LOG.warning(badge("SCHED-SVC", "execute-failed", err=str(exc)))
            return None
        if not r.u8():
            return None
        header = BlockHeader.decode(r.blob())
        receipts = r.seq(lambda rr: Receipt.decode(rr.blob()))
        return RemoteExecutionResult(header, receipts)

    def commit_block(self, header: BlockHeader) -> bool:
        try:
            r = self.client.call("commitBlock",
                                 lambda w: w.blob(header.encode()),
                                 retry=False)
        except (ConnectionError, OSError, ServiceRemoteError) as exc:
            LOG.warning(badge("SCHED-SVC", "commit-failed", err=str(exc)))
            return False
        return bool(r.u8())

    def drop_executed(self, header: BlockHeader) -> None:
        try:
            self.client.call("dropExecuted",
                             lambda w: w.blob(header.encode()))
        except (ConnectionError, OSError, ServiceRemoteError):
            pass  # server-side entry expires with the process; best effort

    def call(self, tx: Transaction) -> Receipt:
        try:
            r = self.client.call("call", lambda w: w.blob(tx.encode()))
        except (ConnectionError, OSError, ServiceRemoteError) as exc:
            rc = Receipt()
            rc.status = int(TransactionStatus.EXECUTION_ABORTED)
            rc.message = f"scheduler service unreachable: {exc}"
            return rc
        return Receipt.decode(r.blob())

    def close(self) -> None:
        self.client.close()
