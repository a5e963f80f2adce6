"""Ledger as a service: chain reads + config over service RPC.

Reference counterpart: FISCO-BCOS fisco-bcos-tars-service/
LedgerService-style access used by Pro/Max services that need chain data
without owning the storage (RPC service answering queries, sync serving
peers). Write paths stay with the scheduler/storage services (2PC), so
this surface is read-only plus config.
"""

from __future__ import annotations

from typing import Optional

from ..codec.wire import Reader, Writer
from ..ledger.ledger import ConsensusNode, LedgerConfig
from ..protocol import BlockHeader, Receipt, Transaction
from .rpc import ServiceClient, ServiceServer


class LedgerServer:
    def __init__(self, ledger, host: str = "127.0.0.1", port: int = 0):
        self.ledger = ledger
        self.server = ServiceServer("ledger", host, port)
        s = self.server
        s.register("currentNumber", self._number)
        s.register("totalTxCount", self._total)
        s.register("headerByNumber", self._header)
        s.register("txHashesByNumber", self._tx_hashes)
        s.register("transaction", self._tx)
        s.register("receipt", self._receipt)
        s.register("noncesByNumber", self._nonces)
        s.register("systemConfig", self._sys_config)
        s.register("consensusNodes", self._nodes)
        s.register("blockByNumber", self._block)
        s.register("numberByHash", self._num_by_hash)
        s.register("totalFailedCount", self._total_failed)
        s.register("txProof", self._tx_proof)
        s.register("receiptProof", self._receipt_proof)
        s.register("ledgerConfig", self._ledger_config)

    @property
    def port(self) -> int:
        return self.server.port

    def start(self) -> None:
        self.server.start()

    def stop(self) -> None:
        self.server.stop()

    def _number(self, r: Reader, w: Writer) -> None:
        w.i64(self.ledger.current_number())

    def _total(self, r: Reader, w: Writer) -> None:
        w.i64(self.ledger.total_tx_count())

    def _header(self, r: Reader, w: Writer) -> None:
        h = self.ledger.header_by_number(r.i64())
        w.blob(h.encode() if h else b"")

    def _tx_hashes(self, r: Reader, w: Writer) -> None:
        w.seq(self.ledger.tx_hashes_by_number(r.i64()),
              lambda ww, h: ww.blob(h))

    def _tx(self, r: Reader, w: Writer) -> None:
        t = self.ledger.transaction(r.blob())
        w.blob(t.encode() if t else b"")

    def _receipt(self, r: Reader, w: Writer) -> None:
        rc = self.ledger.receipt(r.blob())
        w.blob(rc.encode() if rc else b"")

    def _nonces(self, r: Reader, w: Writer) -> None:
        w.seq(self.ledger.nonces_by_number(r.i64()),
              lambda ww, n: ww.text(n))

    def _sys_config(self, r: Reader, w: Writer) -> None:
        cfg = self.ledger.system_config(r.text())  # None when unset
        w.u8(1 if cfg is not None else 0)
        value, enable = cfg if cfg is not None else ("", -1)
        w.text(value)
        w.i64(enable)

    def _nodes(self, r: Reader, w: Writer) -> None:
        nodes = self.ledger.consensus_nodes()
        w.seq(nodes, lambda ww, n: ww.blob(n.node_id).u64(n.weight)
              .text(n.node_type).i64(n.enable_number))

    def _block(self, r: Reader, w: Writer) -> None:
        n, with_txs = r.i64(), bool(r.u8())
        blk = self.ledger.block_by_number(n, with_txs)
        w.blob(blk.encode() if blk else b"")

    def _num_by_hash(self, r: Reader, w: Writer) -> None:
        n = self.ledger.number_by_hash(r.blob())
        w.i64(-1 if n is None else n)

    def _total_failed(self, r: Reader, w: Writer) -> None:
        w.i64(self.ledger.total_failed_count())

    @staticmethod
    def _write_proof(w: Writer, pr) -> None:
        if pr is None:
            w.u8(0)
            return
        proof, root = pr
        w.u8(1)
        w.blob(root)
        w.seq(proof, lambda ww, lvl: ww.seq(
            lvl[0], lambda www, s: www.blob(s)).u32(lvl[1]))

    def _tx_proof(self, r: Reader, w: Writer) -> None:
        self._write_proof(w, self.ledger.tx_proof(r.blob()))

    def _receipt_proof(self, r: Reader, w: Writer) -> None:
        self._write_proof(w, self.ledger.receipt_proof(r.blob()))

    @staticmethod
    def _write_nodes(w: Writer, nodes) -> None:
        w.seq(nodes, lambda ww, n: ww.blob(n.node_id).u64(n.weight)
              .text(n.node_type).i64(n.enable_number))

    def _ledger_config(self, r: Reader, w: Writer) -> None:
        cfg = self.ledger.ledger_config()
        self._write_nodes(w, cfg.consensus_nodes)
        self._write_nodes(w, cfg.observer_nodes)
        w.i64(cfg.block_number)
        w.blob(cfg.block_hash)
        w.u32(cfg.block_tx_count_limit)
        w.u32(cfg.leader_switch_period)


class RemoteLedger:
    """Read-only ledger proxy (duck-types the query surface)."""

    def __init__(self, host: str, port: int, timeout: float = 30.0):
        self.client = ServiceClient(host, port, timeout)

    def current_number(self) -> int:
        return self.client.call("currentNumber").i64()

    def total_tx_count(self) -> int:
        return self.client.call("totalTxCount").i64()

    def header_by_number(self, n: int) -> Optional[BlockHeader]:
        raw = self.client.call("headerByNumber", lambda w: w.i64(n)).blob()
        return BlockHeader.decode(raw) if raw else None

    def tx_hashes_by_number(self, n: int) -> list[bytes]:
        r = self.client.call("txHashesByNumber", lambda w: w.i64(n))
        return r.seq(lambda rr: rr.blob())

    def transaction(self, h: bytes) -> Optional[Transaction]:
        raw = self.client.call("transaction", lambda w: w.blob(h)).blob()
        return Transaction.decode(raw) if raw else None

    def receipt(self, h: bytes) -> Optional[Receipt]:
        raw = self.client.call("receipt", lambda w: w.blob(h)).blob()
        return Receipt.decode(raw) if raw else None

    def nonces_by_number(self, n: int) -> list[str]:
        r = self.client.call("noncesByNumber", lambda w: w.i64(n))
        return r.seq(lambda rr: rr.text())

    def system_config(self, key: str) -> Optional[tuple[str, int]]:
        """Drop-in for Ledger.system_config: None when the key is unset,
        (value, enable_number) otherwise — empty string preserved."""
        r = self.client.call("systemConfig", lambda w: w.text(key))
        present = r.u8()
        value = r.text()
        enable = r.i64()
        return (value, enable) if present else None

    def consensus_nodes(self) -> list[ConsensusNode]:
        r = self.client.call("consensusNodes")
        return r.seq(lambda rr: ConsensusNode(rr.blob(), rr.u64(),
                                              rr.text(), rr.i64()))

    def block_by_number(self, n: int, with_txs: bool = True):
        from ..protocol import Block

        raw = self.client.call(
            "blockByNumber",
            lambda w: w.i64(n).u8(1 if with_txs else 0)).blob()
        return Block.decode(raw) if raw else None

    def number_by_hash(self, h: bytes) -> Optional[int]:
        n = self.client.call("numberByHash", lambda w: w.blob(h)).i64()
        return None if n < 0 else n

    def total_failed_count(self) -> int:
        return self.client.call("totalFailedCount").i64()

    @staticmethod
    def _read_proof(r: Reader):
        if not r.u8():
            return None
        root = r.blob()
        proof = r.seq(lambda rr: (rr.seq(lambda www: www.blob()), rr.u32()))
        return proof, root

    def tx_proof(self, tx_hash: bytes):
        return self._read_proof(
            self.client.call("txProof", lambda w: w.blob(tx_hash)))

    def receipt_proof(self, tx_hash: bytes):
        return self._read_proof(
            self.client.call("receiptProof", lambda w: w.blob(tx_hash)))

    def ledger_config(self) -> LedgerConfig:
        r = self.client.call("ledgerConfig")

        def nodes(rr):
            return rr.seq(lambda x: ConsensusNode(x.blob(), x.u64(),
                                                  x.text(), x.i64()))

        return LedgerConfig(consensus_nodes=nodes(r),
                            observer_nodes=nodes(r),
                            block_number=r.i64(),
                            block_hash=r.blob(),
                            block_tx_count_limit=r.u32(),
                            leader_switch_period=r.u32())

    def close(self) -> None:
        self.client.close()
