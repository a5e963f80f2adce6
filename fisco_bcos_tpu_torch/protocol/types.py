"""Protocol objects with deterministic encoding and lazy hash/sender caches.

Mirrors the reference's data model (field-for-field where it matters for
capability parity) but with a batch-first identity pipeline:

* `Transaction` — fields per bcos-tars-protocol/tars/Transaction.tars
  (version, chainID, groupID, blockLimit, nonce, to, input, abi) + signature.
  `hash` is H(unsigned encoding) cached lazily, like TransactionImpl's cached
  hash (bcos-tars-protocol/bcos-tars-protocol/protocol/TransactionImpl.h).
  `verify()` (hash + recover + sender derive, the reference's per-tx hot path
  Transaction.h:68-82) exists as the degenerate single case of
  `batch_recover_senders`, which pushes whole proposals through the CUDA
  recover kernel.
* `Receipt` — status/output/logs/gasUsed + contractAddress
  (TransactionReceipt.tars).
* `BlockHeader` — parentInfo/txsRoot/receiptsRoot/stateRoot/number/gasUsed/
  timestamp/sealer/sealerList/extraData/signatureList (BlockHeader.tars);
  `hash` is H(encoding without signatureList) so commit seals sign the header
  identity, and signatureList travels with the block for sync verification
  (BlockValidator.cpp:141 checkSignatureList).
* `Block` — header + full txs and/or tx-hash metadata + receipts, covering
  the reference's CompleteBlock/WithTransactionsHash flags (Block.tars).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Sequence

from ..codec.wire import Reader, Writer

ADDR = 20
DIGEST = 32


class TransactionStatus(enum.IntEnum):
    """Execution status codes (subset of the reference's
    bcos-protocol/bcos-protocol/TransactionStatus.h)."""

    OK = 0
    OUT_OF_GAS = 2
    BAD_INSTRUCTION = 10
    BAD_JUMP = 11
    STACK_OVERFLOW = 12
    STACK_UNDERFLOW = 13
    REVERT = 14
    NOT_ENOUGH_CASH = 7
    PRECOMPILED_ERROR = 15
    EXECUTION_ABORTED = 17
    CALL_ADDRESS_ERROR = 16
    PERMISSION_DENIED = 18
    CONTRACT_FROZEN = 21
    ACCOUNT_FROZEN = 22
    NONCE_CHECK_FAIL = 10000
    BLOCK_LIMIT_CHECK_FAIL = 10001
    TXPOOL_FULL = 10003
    ALREADY_IN_TXPOOL = 10005
    ALREADY_KNOWN = 10004
    INVALID_CHAINID = 10006
    INVALID_GROUPID = 10007
    INVALID_SIGNATURE = 10008
    REQUEST_NOT_BELIEVABLE = 10009
    # typed write-shed signal from the health plane (utils/health.py): the
    # node is degraded — reads still serve, writes are refused so clients
    # fail fast and retry another node instead of feeding a sick pipeline
    NODE_DEGRADED = 10010
    # overload-control plane (utils/overload.py + txpool watermarks):
    # TXPOOL_EVICTED — the tx WAS admitted but a higher-priority tx
    # reclaimed its slot at the high watermark; DEADLINE_UNMEETABLE — the
    # pool is congested past the low watermark and this tx's block_limit
    # leaves too little lifetime to realistically seal before expiry, so
    # admitting it would only burn verify + pool slots it can never repay
    TXPOOL_EVICTED = 10011
    DEADLINE_UNMEETABLE = 10012


@dataclasses.dataclass
class Transaction:
    version: int = 0
    chain_id: str = "chain0"
    group_id: str = "group0"
    block_limit: int = 0
    nonce: str = ""
    to: bytes = b""  # 20-byte address or empty for create
    input: bytes = b""
    abi: str = ""
    signature: bytes = b""
    import_time: int = 0  # ms; not part of the signed payload
    attribute: int = 0

    _hash: Optional[bytes] = dataclasses.field(default=None, repr=False)
    _sender: Optional[bytes] = dataclasses.field(default=None, repr=False)
    # wire-encoding caches, set by decode()/encode(): a tx is re-encoded on
    # every hop of its life (gossip, proposal persist, ledger prewrite) and
    # the bytes are canonical — pay the Writer walk once. sign() clears
    # them (the only mutation the codebase performs after decode).
    _wire: Optional[bytes] = dataclasses.field(default=None, repr=False)
    _unsigned: Optional[bytes] = dataclasses.field(default=None, repr=False)

    # -- encoding ----------------------------------------------------------
    def encode_unsigned(self) -> bytes:
        if self._unsigned is None:
            w = Writer()
            (w.u16(self.version).text(self.chain_id).text(self.group_id)
             .i64(self.block_limit).text(self.nonce).blob(self.to)
             .blob(self.input).text(self.abi))
            self._unsigned = w.bytes()
        return self._unsigned

    def encode(self) -> bytes:
        if self._wire is None:
            w = Writer()
            w.blob(self.encode_unsigned()).blob(self.signature)
            w.i64(self.import_time).u32(self.attribute)
            self._wire = w.bytes()
        return self._wire

    @classmethod
    def decode(cls, data: bytes) -> "Transaction":
        r = Reader(data)
        unsigned = r.blob()
        sig = r.blob()
        import_time = r.i64()
        attribute = r.u32()
        u = Reader(unsigned)
        tx = cls(version=u.u16(), chain_id=u.text(), group_id=u.text(),
                 block_limit=u.i64(), nonce=u.text(), to=u.blob(),
                 input=u.blob(), abi=u.text(), signature=sig,
                 import_time=import_time, attribute=attribute)
        # cache ONLY canonical input: wire bytes with trailing garbage (or a
        # padded unsigned blob) must keep the old re-serialise-from-fields
        # behavior so hash identity stays canonical for any wire variant
        if r.done() and u.done():
            tx._wire = bytes(data) if not isinstance(data, bytes) else data
            tx._unsigned = unsigned
        return tx

    # -- identity ----------------------------------------------------------
    def hash(self, suite) -> bytes:
        if self._hash is None:
            self._hash = suite.hash(self.encode_unsigned())
        return self._hash

    def sender(self, suite) -> Optional[bytes]:
        """Recover + cache the sender address; None if the sig is invalid."""
        if self._sender is None:
            addrs, _ = suite.recover_addresses([self.hash(suite)],
                                               [self.signature])
            self._sender = addrs[0]
        return self._sender

    def set_sender(self, addr: bytes) -> None:
        """Install a batch-recovered sender (txpool batch path)."""
        self._sender = addr

    def sign(self, suite, keypair) -> "Transaction":
        self.signature = suite.sign(keypair, self.hash(suite))
        self._sender = keypair.address
        return self

    # mechanical cache invalidation: ANY payload-field mutation after
    # decode()/encode() must drop the cached bytes, or gossip/persist would
    # silently re-emit stale encodings (the caches are an optimisation,
    # never an alternate source of truth)
    _UNSIGNED_FIELDS = frozenset({
        "version", "chain_id", "group_id", "block_limit", "nonce", "to",
        "input", "abi"})
    _SIGNED_FIELDS = frozenset({"signature", "import_time", "attribute"})

    def __setattr__(self, name, value):
        object.__setattr__(self, name, value)
        if name in Transaction._UNSIGNED_FIELDS:
            object.__setattr__(self, "_unsigned", None)
            object.__setattr__(self, "_wire", None)
            object.__setattr__(self, "_hash", None)
            object.__setattr__(self, "_sender", None)
        elif name in Transaction._SIGNED_FIELDS:
            object.__setattr__(self, "_wire", None)
            if name == "signature":
                object.__setattr__(self, "_sender", None)


@dataclasses.dataclass
class LogEntry:
    address: bytes = b""
    topics: Sequence[bytes] = dataclasses.field(default_factory=list)
    data: bytes = b""

    def encode_to(self, w: Writer) -> None:
        w.blob(self.address)
        w.seq(list(self.topics), lambda ww, t: ww.blob(t))
        w.blob(self.data)

    @classmethod
    def decode_from(cls, r: Reader) -> "LogEntry":
        return cls(address=r.blob(), topics=r.seq(lambda rr: rr.blob()),
                   data=r.blob())


@dataclasses.dataclass
class Receipt:
    version: int = 0
    gas_used: int = 0
    contract_address: bytes = b""
    status: int = int(TransactionStatus.OK)
    output: bytes = b""
    logs: list[LogEntry] = dataclasses.field(default_factory=list)
    block_number: int = 0
    message: str = ""  # revert/error detail, not part of the hashed payload

    _hash: Optional[bytes] = dataclasses.field(default=None, repr=False)

    def encode(self) -> bytes:
        w = Writer()
        (w.u16(self.version).u64(self.gas_used).blob(self.contract_address)
         .u32(self.status).blob(self.output))
        w.seq(self.logs, lambda ww, log: log.encode_to(ww))
        w.i64(self.block_number)
        return w.bytes()

    @classmethod
    def decode(cls, data: bytes) -> "Receipt":
        r = Reader(data)
        return cls(version=r.u16(), gas_used=r.u64(),
                   contract_address=r.blob(), status=r.u32(), output=r.blob(),
                   logs=r.seq(LogEntry.decode_from), block_number=r.i64())

    def hash(self, suite) -> bytes:
        if self._hash is None:
            self._hash = suite.hash(self.encode())
        return self._hash


@dataclasses.dataclass
class ParentInfo:
    number: int
    hash: bytes

    def encode_to(self, w: Writer) -> None:
        w.i64(self.number).blob(self.hash)

    @classmethod
    def decode_from(cls, r: Reader) -> "ParentInfo":
        return cls(number=r.i64(), hash=r.blob())


@dataclasses.dataclass
class BlockHeader:
    version: int = 0
    parent_info: list[ParentInfo] = dataclasses.field(default_factory=list)
    txs_root: bytes = b"\x00" * DIGEST
    receipts_root: bytes = b"\x00" * DIGEST
    state_root: bytes = b"\x00" * DIGEST
    number: int = 0
    gas_used: int = 0
    timestamp: int = 0  # ms
    sealer: int = 0  # index into sealer_list
    sealer_list: list[bytes] = dataclasses.field(default_factory=list)  # node pubkeys
    extra_data: bytes = b""
    consensus_weights: list[int] = dataclasses.field(default_factory=list)
    # commit seals: (sealer_index, signature over header hash)
    signature_list: list[tuple[int, bytes]] = dataclasses.field(default_factory=list)

    _hash: Optional[bytes] = dataclasses.field(default=None, repr=False)

    def encode_core(self) -> bytes:
        """Encoding without signature_list — the signed/hashed identity."""
        w = Writer()
        w.u16(self.version)
        w.seq(self.parent_info, lambda ww, p: p.encode_to(ww))
        (w.blob(self.txs_root).blob(self.receipts_root).blob(self.state_root)
         .i64(self.number).u64(self.gas_used).i64(self.timestamp)
         .i64(self.sealer))
        w.seq(self.sealer_list, lambda ww, pk: ww.blob(pk))
        w.blob(self.extra_data)
        w.seq(self.consensus_weights, lambda ww, x: ww.u64(x))
        return w.bytes()

    def encode(self) -> bytes:
        w = Writer()
        w.blob(self.encode_core())
        w.seq(self.signature_list,
              lambda ww, iv: ww.i64(iv[0]).blob(iv[1]))
        return w.bytes()

    @classmethod
    def decode(cls, data: bytes) -> "BlockHeader":
        r = Reader(data)
        core = Reader(r.blob())
        sigs = r.seq(lambda rr: (rr.i64(), rr.blob()))
        h = cls(version=core.u16(),
                parent_info=core.seq(ParentInfo.decode_from),
                txs_root=core.blob(), receipts_root=core.blob(),
                state_root=core.blob(), number=core.i64(),
                gas_used=core.u64(), timestamp=core.i64(), sealer=core.i64(),
                sealer_list=core.seq(lambda rr: rr.blob()),
                extra_data=core.blob(),
                consensus_weights=core.seq(lambda rr: rr.u64()),
                signature_list=sigs)
        return h

    def hash(self, suite) -> bytes:
        if self._hash is None:
            self._hash = suite.hash(self.encode_core())
        return self._hash

    def invalidate(self) -> None:
        self._hash = None


@dataclasses.dataclass
class Block:
    header: BlockHeader = dataclasses.field(default_factory=BlockHeader)
    transactions: list[Transaction] = dataclasses.field(default_factory=list)
    receipts: list[Receipt] = dataclasses.field(default_factory=list)
    tx_hashes: list[bytes] = dataclasses.field(default_factory=list)  # metadata-only form

    def encode(self) -> bytes:
        w = Writer()
        w.blob(self.header.encode())
        w.seq(self.transactions, lambda ww, t: ww.blob(t.encode()))
        w.seq(self.receipts, lambda ww, rc: ww.blob(rc.encode()))
        w.seq(self.tx_hashes, lambda ww, h: ww.blob(h))
        return w.bytes()

    @classmethod
    def decode(cls, data: bytes) -> "Block":
        r = Reader(data)
        header = BlockHeader.decode(r.blob())
        txs = r.seq(lambda rr: Transaction.decode(rr.blob()))
        rcs = r.seq(lambda rr: Receipt.decode(rr.blob()))
        hashes = r.seq(lambda rr: rr.blob())
        return cls(header=header, transactions=txs, receipts=rcs,
                   tx_hashes=hashes)

    # -- roots (device Merkle; BlockImpl.h:111,156) ---------------------------
    def calculate_txs_root(self, suite) -> bytes:
        leaves = self.tx_hashes or batch_hash(self.transactions, suite)
        return suite.merkle_root(leaves)

    def calculate_receipts_root(self, suite) -> bytes:
        # batch-hash the uncached receipts in one call (one FFI crossing /
        # one device dispatch instead of per-receipt singles)
        prefill_hashes(self.receipts, lambda rc: rc.encode(), suite)
        return suite.merkle_root([rc.hash(suite) for rc in self.receipts])


# ---------------------------------------------------------------------------
# batch identity pipeline (the batch replacement for per-tx verify loops)
# ---------------------------------------------------------------------------

def prefill_hashes(objs, encode_fn, suite) -> None:
    """Fill the `_hash` cache of every object lacking one with ONE batched
    hash call over `encode_fn(obj)` — the shared identity-cache contract
    for Transaction (encode_unsigned), Receipt (encode) and PBFTMessage
    (encode_core)."""
    todo = [o for o in objs if o._hash is None]
    if todo:
        for o, d in zip(todo, suite.hash_batch(
                [encode_fn(o) for o in todo])):
            o._hash = d


def batch_hash(txs: Sequence[Transaction], suite) -> list[bytes]:
    """Hash every tx in one device call; fills each tx's cache."""
    prefill_hashes(txs, lambda t: t.encode_unsigned(), suite)
    return [t._hash for t in txs]


def batch_recover_senders(txs: Sequence[Transaction], suite):
    """Recover all senders in one recover-kernel call.

    Replaces the reference's tbb::parallel_for over tx->verify
    (TransactionSync.cpp:516-537). Returns (senders, ok) aligned with txs;
    caches senders on each valid tx.
    """
    hashes = batch_hash(txs, suite)
    todo = [i for i, t in enumerate(txs) if t._sender is None]
    if not todo:
        import numpy as np
        return [t._sender for t in txs], np.ones(len(txs), bool)
    addrs, ok = suite.recover_addresses([hashes[i] for i in todo],
                                        [txs[i].signature for i in todo])
    for i, a in zip(todo, addrs):
        if a is not None:
            txs[i]._sender = a
    import numpy as np
    allok = np.ones(len(txs), bool)
    for j, i in enumerate(todo):
        allok[i] = bool(ok[j])
    return [t._sender for t in txs], allok
