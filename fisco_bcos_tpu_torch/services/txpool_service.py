"""TxPool as a service: the pool's module surface over service RPC.

Reference counterpart: FISCO-BCOS fisco-bcos-tars-service/
TxPoolService/ (TxPoolServiceServer wrapping the in-process TxPool behind
the Tars servant) with the client proxy in bcos-tars-protocol/client/
TxPoolServiceClient.h. `TxPoolServer` exposes a node's pool; `RemoteTxPool`
duck-types the pool surface the sealer/PBFT/scheduler consume
(submit/seal/fill/verify), so a consensus service in another process binds
it exactly like the in-process object.
"""

from __future__ import annotations

from typing import Optional, Sequence

from ..codec.wire import Reader, Writer
from ..protocol import Block, Transaction, TransactionStatus
from ..txpool.txpool import TxSubmitResult
from .rpc import ServiceClient, ServiceServer


def _write_txs(w: Writer, txs: Sequence[Transaction]) -> None:
    w.seq(list(txs), lambda ww, t: ww.blob(t.encode()))


def _read_txs(r: Reader) -> list[Transaction]:
    return r.seq(lambda rr: Transaction.decode(rr.blob()))


class TxPoolServer:
    def __init__(self, txpool, host: str = "127.0.0.1", port: int = 0):
        self.txpool = txpool
        self.server = ServiceServer("txpool", host, port)
        s = self.server
        s.register("submitBatch", self._submit_batch)
        s.register("seal", self._seal)
        s.register("unseal", self._unseal)
        s.register("fillBlock", self._fill_block)
        s.register("verifyProposal", self._verify_proposal)
        s.register("missingHashes", self._missing)
        s.register("pendingCount", self._pending)
        s.register("onCommitted", self._on_committed)
        s.register("waitReceipt", self._wait_receipt)

    @property
    def port(self) -> int:
        return self.server.port

    def start(self) -> None:
        self.server.start()

    def stop(self) -> None:
        self.server.stop()

    def _submit_batch(self, r: Reader, w: Writer) -> None:
        txs = _read_txs(r)
        results = self.txpool.submit_batch(txs)
        w.seq(results, lambda ww, res: ww.blob(res.tx_hash)
              .u32(int(res.status)))

    def _seal(self, r: Reader, w: Writer) -> None:
        txs, hashes = self.txpool.seal(r.u32())
        _write_txs(w, txs)
        w.seq(hashes, lambda ww, h: ww.blob(h))

    def _unseal(self, r: Reader, w: Writer) -> None:
        self.txpool.unseal(r.seq(lambda rr: rr.blob()))
        w.u8(1)

    def _fill_block(self, r: Reader, w: Writer) -> None:
        txs = self.txpool.fill_block(r.seq(lambda rr: rr.blob()))
        w.u8(1 if txs is not None else 0)
        _write_txs(w, txs or [])

    def _verify_proposal(self, r: Reader, w: Writer) -> None:
        w.u8(1 if self.txpool.verify_proposal(Block.decode(r.blob())) else 0)

    def _missing(self, r: Reader, w: Writer) -> None:
        missing = self.txpool.missing_hashes(r.seq(lambda rr: rr.blob()))
        w.seq(missing, lambda ww, h: ww.blob(h))

    def _pending(self, r: Reader, w: Writer) -> None:
        w.u32(self.txpool.pending_count())

    def _on_committed(self, r: Reader, w: Writer) -> None:
        number = r.i64()
        hashes = r.seq(lambda rr: rr.blob())
        nonces = r.seq(lambda rr: rr.text())
        self.txpool.on_block_committed(number, hashes, nonces)
        w.u8(1)

    def _wait_receipt(self, r: Reader, w: Writer) -> None:
        from ..txpool.txpool import TxDropped
        tx_hash = r.blob()
        timeout = min(r.u32(), 25)  # bounded park; client re-polls
        try:
            rc = self.txpool.wait_for_receipt(tx_hash, timeout)
        except TxDropped:
            rc = None  # wire keeps the empty-blob shape; the submitter
            #            learned the typed status from its own submit
        w.blob(rc.encode() if rc is not None else b"")


class RemoteTxPool:
    """Pool proxy for services in other processes (sealer/PBFT-side)."""

    def __init__(self, host: str, port: int, timeout: float = 60.0):
        self.client = ServiceClient(host, port, timeout)
        # receipt waits park server-side for up to 25 s; give them their
        # own connection so they never serialize pool operations behind
        # the shared client's per-call lock
        self._wait_client = ServiceClient(host, port, timeout)

    def submit_batch(self, txs: Sequence[Transaction]
                     ) -> list[TxSubmitResult]:
        # retry=False: a resend after a broken connection would re-admit —
        # the server's dedup then reports ALREADY_IN_TXPOOL for txs that
        # were in fact accepted, misleading the caller
        r = self.client.call("submitBatch", lambda w: _write_txs(w, txs),
                             retry=False)
        return r.seq(lambda rr: TxSubmitResult(
            rr.blob(), TransactionStatus(rr.u32())))

    def submit(self, tx: Transaction) -> TxSubmitResult:
        return self.submit_batch([tx])[0]

    def seal(self, max_txs: int):
        # retry=False: seal mutates pool state; a blind resend after a
        # broken connection could seal a second batch and strand the first
        r = self.client.call("seal", lambda w: w.u32(max_txs), retry=False)
        return _read_txs(r), r.seq(lambda rr: rr.blob())

    def unseal(self, hashes: Sequence[bytes]) -> None:
        self.client.call("unseal",
                         lambda w: w.seq(list(hashes),
                                         lambda ww, h: ww.blob(h)))

    def fill_block(self, hashes: Sequence[bytes]
                   ) -> Optional[list[Transaction]]:
        r = self.client.call("fillBlock",
                             lambda w: w.seq(list(hashes),
                                             lambda ww, h: ww.blob(h)))
        ok = r.u8()
        txs = _read_txs(r)
        return txs if ok else None

    def verify_proposal(self, block: Block) -> bool:
        r = self.client.call("verifyProposal",
                             lambda w: w.blob(block.encode()))
        return bool(r.u8())

    def missing_hashes(self, hashes: Sequence[bytes]) -> list[bytes]:
        r = self.client.call("missingHashes",
                             lambda w: w.seq(list(hashes),
                                             lambda ww, h: ww.blob(h)))
        return r.seq(lambda rr: rr.blob())

    def pending_count(self) -> int:
        return self.client.call("pendingCount").u32()

    def on_block_committed(self, number: int, hashes, nonces) -> None:
        self.client.call(
            "onCommitted",
            lambda w: (w.i64(number)
                       .seq(list(hashes), lambda ww, h: ww.blob(h))
                       .seq(list(nonces), lambda ww, n: ww.text(n))))

    def wait_for_receipt(self, tx_hash: bytes, timeout: float = 30.0):
        """Server-side park (bounded), client-side re-poll loop."""
        import time as _time

        from ..protocol import Receipt

        deadline = _time.monotonic() + timeout
        while True:
            budget = max(1, int(min(25, deadline - _time.monotonic())))
            raw = self._wait_client.call(
                "waitReceipt",
                lambda w: w.blob(tx_hash).u32(budget)).blob()
            if raw:
                return Receipt.decode(raw)
            if _time.monotonic() >= deadline:
                return None

    def close(self) -> None:
        self.client.close()
        self._wait_client.close()
