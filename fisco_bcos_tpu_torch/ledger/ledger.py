"""Ledger — the chain data schema over transactional storage.

Reference counterpart: FISCO-BCOS bcos-ledger/src/libledger/Ledger.cpp
(asyncPrewriteBlock Ledger.h:53, Merkle proofs :759-844, getReceiptProof
:1437) and the table layout it maintains. Tables (names kept close to the
reference's s_* schema for operator familiarity):

  s_number_2_header   : number(be8)        -> BlockHeader bytes
  s_hash_2_number     : block hash         -> number(be8)
  s_number_2_txs      : number(be8)        -> tx-hash list bytes
  s_hash_2_tx         : tx hash            -> Transaction bytes
  s_hash_2_receipt    : tx hash            -> Receipt bytes
  s_number_2_nonces   : number(be8)        -> nonce list bytes
  s_current_state     : {current_number, total_tx_count, total_failed_txs}
  s_config            : key -> (value, enable_number)  [on-chain sys config]
  s_consensus         : nodeID -> (type, weight, enable_number)

Block commit is `prewrite` into a StateStorage overlay (the scheduler merges
it with execution state and drives the storage 2PC), mirroring
asyncPrewriteBlock's role in BlockExecutive::batchBlockCommit (:1265).

Merkle proofs are served from the host-level tree (ops.merkle.merkle_proof);
roots themselves come from the device kernel via CryptoSuite.merkle_root.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from ..codec.wire import Reader, Writer
from ..protocol import Block, BlockHeader, Receipt, Transaction, batch_hash
from ..storage.interface import StorageInterface
from ..utils.log import LOG, badge

T_HEADER = "s_number_2_header"
T_HASH2NUM = "s_hash_2_number"
T_NUM2TXS = "s_number_2_txs"
T_TX = "s_hash_2_tx"
T_RECEIPT = "s_hash_2_receipt"
T_NONCES = "s_number_2_nonces"
T_STATE = "s_current_state"
SYS_CONFIG = "s_config"
SYS_CONSENSUS = "s_consensus"
# snapshot/pruning bookkeeping (snapshot/ subsystem): blocks with
# number < pruned_below keep only their header + hash->number row
T_SNAPSHOT = "s_snapshot_state"
# ZK proof plane (zk/proof.py): number(be8) -> the block's state-proof
# index [(table, key, leaf_digest)] — the sorted changeset's leaf digests
# as computed for header.state_root. DERIVED data (written after the root,
# never covered by it); pruned with the block bodies.
T_STATEIDX = "s_number_2_statehash"

K_CURRENT = b"current_number"
K_TOTAL_TX = b"total_transaction_count"
K_TOTAL_FAILED = b"total_failed_transaction_count"
K_PRUNED_BELOW = b"pruned_below"

GENESIS_EXTRA = b"bcos-tpu genesis"

# on-chain mutable system config keys (LedgerTypeDef.h:39-42)
SYSTEM_KEY_TX_COUNT_LIMIT = "tx_count_limit"
SYSTEM_KEY_LEADER_PERIOD = "consensus_leader_period"
SYSTEM_KEY_GAS_LIMIT = "tx_gas_limit"
# feature-gating chain version (LedgerTypeDef.h:42 SYSTEM_KEY_COMPATIBILITY_
# VERSION): every node switches gated behavior at the same height because
# the value is on-chain state with next-block enablement — the rolling-
# upgrade mechanism (upgrade binaries first, then raise the version by
# governance vote once the whole fleet understands it)
SYSTEM_KEY_COMPATIBILITY_VERSION = "compatibility_version"
DEFAULT_COMPATIBILITY_VERSION = "1.1.0"


def parse_version(s: str) -> tuple[int, int, int]:
    """'X.Y.Z' -> (X, Y, Z); raises ValueError on anything else."""
    parts = s.strip().split(".")
    if len(parts) != 3 or not all(p.isdigit() for p in parts):
        # strict digit check: bare int() accepts '1_1' and '+1', which a
        # governance fat-finger would then store on-chain irreversibly
        # (downgrades are refused)
        raise ValueError(f"not a X.Y.Z version: {s!r}")
    x, y, z = (int(p) for p in parts)
    return (x, y, z)


def _be8(n: int) -> bytes:
    return n.to_bytes(8, "big")


@dataclasses.dataclass
class ConsensusNode:
    node_id: bytes  # node public key bytes
    weight: int = 1
    node_type: str = "consensus_sealer"  # or consensus_observer
    enable_number: int = 0


@dataclasses.dataclass
class LedgerConfig:
    """The live chain config consensus needs each block — the reference's
    LedgerConfig fetched by LedgerConfigFetcher at boot and refreshed per
    block."""

    consensus_nodes: list[ConsensusNode]
    observer_nodes: list[ConsensusNode]
    block_number: int
    block_hash: bytes
    block_tx_count_limit: int = 1000
    leader_switch_period: int = 1
    gas_limit: int = 3_000_000_000
    compatibility_version: tuple[int, int, int] = (1, 1, 0)


class Ledger:
    def __init__(self, storage: StorageInterface, suite):
        self.storage = storage
        self.suite = suite

    # -- genesis -----------------------------------------------------------
    def build_genesis(self, sealers: Sequence[ConsensusNode],
                      tx_count_limit: int = 1000,
                      leader_period: int = 1,
                      gas_limit: int = 3_000_000_000,
                      compatibility_version: str = DEFAULT_COMPATIBILITY_VERSION,
                      extra: bytes = GENESIS_EXTRA) -> BlockHeader:
        """Idempotent genesis bootstrap (LedgerInitializer's buildGenesisBlock)."""
        existing = self.header_by_number(0)
        if existing is not None:
            return existing
        header = BlockHeader(number=0, extra_data=extra,
                             sealer_list=[n.node_id for n in sealers],
                             consensus_weights=[n.weight for n in sealers])
        st = self.storage
        st.set(T_HEADER, _be8(0), header.encode())
        st.set(T_HASH2NUM, header.hash(self.suite), _be8(0))
        st.set(T_STATE, K_CURRENT, _be8(0))
        st.set(T_STATE, K_TOTAL_TX, _be8(0))
        st.set(T_STATE, K_TOTAL_FAILED, _be8(0))
        self._set_config_direct(SYSTEM_KEY_TX_COUNT_LIMIT, str(tx_count_limit), 0)
        self._set_config_direct(SYSTEM_KEY_LEADER_PERIOD, str(leader_period), 0)
        self._set_config_direct(SYSTEM_KEY_GAS_LIMIT, str(gas_limit), 0)
        parse_version(compatibility_version)  # refuse a malformed genesis
        self._set_config_direct(SYSTEM_KEY_COMPATIBILITY_VERSION,
                                compatibility_version, 0)
        for node in sealers:
            self._set_consensus_direct(node)
        LOG.info(badge("LEDGER", "genesis", hash=header.hash(self.suite).hex()))
        return header

    def _set_config_direct(self, key: str, value: str, enable: int) -> None:
        w = Writer()
        w.text(value).i64(enable)
        self.storage.set(SYS_CONFIG, key.encode(), w.bytes())

    def _set_consensus_direct(self, node: ConsensusNode) -> None:
        w = Writer()
        w.text(node.node_type).u64(node.weight).i64(node.enable_number)
        self.storage.set(SYS_CONSENSUS, node.node_id, w.bytes())

    # -- block writes ------------------------------------------------------
    def prewrite_block(self, block: Block, state: StorageInterface) -> None:
        """Stage chain-data writes for a block into `state` (an overlay);
        commit happens via the storage 2PC driven by the scheduler.

        The header itself (T_HEADER / T_HASH2NUM) is written by the scheduler
        at commit time: its hash is only final after state_root is set."""
        header = block.header
        n = header.number
        tx_hashes = batch_hash(block.transactions, self.suite) \
            if block.transactions else list(block.tx_hashes)
        w = Writer()
        w.seq(tx_hashes, lambda ww, h: ww.blob(h))
        state.set(T_NUM2TXS, _be8(n), w.bytes())

        nonces = []
        for tx, th in zip(block.transactions, tx_hashes):
            state.set(T_TX, th, tx.encode())
            nonces.append(tx.nonce)
        for rc, th in zip(block.receipts, tx_hashes):
            rc.block_number = n
            state.set(T_RECEIPT, th, rc.encode())
        wn = Writer()
        wn.seq(nonces, lambda ww, s: ww.text(s))
        state.set(T_NONCES, _be8(n), wn.bytes())

        failed = sum(1 for rc in block.receipts if rc.status != 0)
        state.set(T_STATE, K_CURRENT, _be8(n))
        state.set(T_STATE, K_TOTAL_TX,
                  _be8(self.total_tx_count(state) + len(tx_hashes)))
        state.set(T_STATE, K_TOTAL_FAILED,
                  _be8(self.total_failed_count(state) + failed))

    # -- reads -------------------------------------------------------------
    def current_number(self, st: Optional[StorageInterface] = None) -> int:
        v = (st or self.storage).get(T_STATE, K_CURRENT)
        return int.from_bytes(v, "big") if v else -1

    def total_tx_count(self, st: Optional[StorageInterface] = None) -> int:
        v = (st or self.storage).get(T_STATE, K_TOTAL_TX)
        return int.from_bytes(v, "big") if v else 0

    def total_failed_count(self, st: Optional[StorageInterface] = None) -> int:
        v = (st or self.storage).get(T_STATE, K_TOTAL_FAILED)
        return int.from_bytes(v, "big") if v else 0

    def header_by_number(self, n: int) -> Optional[BlockHeader]:
        v = self.storage.get(T_HEADER, _be8(n))
        return BlockHeader.decode(v) if v else None

    def number_by_hash(self, h: bytes) -> Optional[int]:
        v = self.storage.get(T_HASH2NUM, h)
        return int.from_bytes(v, "big") if v else None

    def tx_hashes_by_number(self, n: int) -> list[bytes]:
        v = self.storage.get(T_NUM2TXS, _be8(n))
        if not v:
            return []
        return Reader(v).seq(lambda rr: rr.blob())

    def transaction(self, tx_hash: bytes) -> Optional[Transaction]:
        v = self.storage.get(T_TX, tx_hash)
        return Transaction.decode(v) if v else None

    def receipt(self, tx_hash: bytes) -> Optional[Receipt]:
        v = self.storage.get(T_RECEIPT, tx_hash)
        return Receipt.decode(v) if v else None

    def nonces_by_number(self, n: int) -> list[str]:
        v = self.storage.get(T_NONCES, _be8(n))
        if not v:
            return []
        return Reader(v).seq(lambda rr: rr.text())

    def block_by_number(self, n: int, with_txs: bool = True) -> Optional[Block]:
        header = self.header_by_number(n)
        if header is None:
            return None
        hashes = self.tx_hashes_by_number(n)
        blk = Block(header=header, tx_hashes=hashes)
        if with_txs:
            for h in hashes:
                tx = self.transaction(h)
                if tx is not None:
                    blk.transactions.append(tx)
                rc = self.receipt(h)
                if rc is not None:
                    blk.receipts.append(rc)
        return blk

    # -- history pruning (snapshot subsystem) ------------------------------
    def pruned_below(self) -> int:
        """Blocks below this height have no bodies (headers remain). 0 when
        nothing was ever pruned."""
        v = self.storage.get(T_SNAPSHOT, K_PRUNED_BELOW)
        return int.from_bytes(v, "big") if v else 0

    # nonce rows outlive the rest of a pruned block's body by this many
    # blocks: the txpool's duplicate-nonce filter (block_limit_range,
    # default 600) is rebuilt from T_NONCES after a snap-sync jump — prune
    # them too early and a recently-committed tx could be re-admitted
    NONCE_RETAIN_BLOCKS = 600
    # blocks swept per remove_batch round (bounds sweep memory + WAL record
    # size on the first prune of a long chain)
    PRUNE_SWEEP_BLOCKS = 256

    def prune_block_data(self, below: int,
                         keep_nonces: Optional[int] = None) -> int:
        """Drop tx bodies/receipts/nonces for blocks < `below` (headers and
        hash->number rows stay: seal verification and proofs-of-lineage
        survive pruning; nonce rows are kept for an extra `keep_nonces`
        blocks — see NONCE_RETAIN_BLOCKS). Returns the number of blocks
        swept. Idempotent.

        Crash-safe ordering: the floor is persisted FIRST (range serving
        refuses `lo < floor` from that instant, so no peer can ever be
        served a half-pruned body); each sweep then derives its work from
        the LIVE keys of the table it prunes, and within every batch
        T_NUM2TXS — the work list the tx/receipt sweep depends on — is
        removed LAST. A kill -9 anywhere mid-sweep leaves orphan rows that
        the next checkpoint's sweep picks up, never a stale floor over
        missing bodies."""
        if keep_nonces is None:
            keep_nonces = self.NONCE_RETAIN_BLOCKS
        lo = self.pruned_below()
        below = min(below, self.current_number() + 1)
        if below > lo:
            self.storage.set(T_SNAPSHOT, K_PRUNED_BELOW, _be8(below))
        floor = max(below, lo)
        body_keys = sorted(k for k in self.storage.keys(T_NUM2TXS)
                           if int.from_bytes(k, "big") < floor)
        # sweep in bounded batches: the first prune of a long archive chain
        # covers millions of txs — one remove_batch over all of them would
        # hold O(history) hashes in memory and fsync one giant WAL record
        # while commits wait on the storage lock
        step = self.PRUNE_SWEEP_BLOCKS
        txs = 0
        for s in range(0, len(body_keys), step):
            batch = body_keys[s:s + step]
            tx_keys: list[bytes] = []
            for key in batch:
                tx_keys.extend(self.tx_hashes_by_number(
                    int.from_bytes(key, "big")))
            txs += len(tx_keys)
            self.storage.remove_batch(T_TX, tx_keys)
            self.storage.remove_batch(T_RECEIPT, tx_keys)
            self.storage.remove_batch(T_STATEIDX, batch)
            self.storage.remove_batch(T_NUM2TXS, batch)
        nonce_floor = floor - keep_nonces
        nonce_keys = [k for k in self.storage.keys(T_NONCES)
                      if int.from_bytes(k, "big") < nonce_floor]
        for s in range(0, len(nonce_keys), step):
            self.storage.remove_batch(T_NONCES, nonce_keys[s:s + step])
        if body_keys:
            LOG.info(badge("LEDGER", "pruned", below=floor,
                           blocks=len(body_keys), txs=txs))
        return len(body_keys)

    # -- proofs (Ledger.cpp:759-844) --------------------------------------
    def tx_proof(self, tx_hash: bytes):
        """-> (proof, root) for the tx's inclusion in its block, or None
        (unknown hash, or body rows lost to a concurrent prune sweep)."""
        from ..ops import merkle as m
        rc = self.receipt(tx_hash)
        if rc is None:
            return None
        hashes = self.tx_hashes_by_number(rc.block_number)
        if tx_hash not in hashes:
            return None
        header = self.header_by_number(rc.block_number)
        if header is None:
            return None
        idx = hashes.index(tx_hash)
        proof = m.merkle_proof(hashes, idx, self.suite.hash_name)
        return proof, header.txs_root

    def receipt_proof(self, tx_hash: bytes):
        from ..ops import merkle as m
        rc = self.receipt(tx_hash)
        if rc is None:
            return None
        hashes = self.tx_hashes_by_number(rc.block_number)
        if tx_hash not in hashes:
            return None  # body rows raced a prune sweep: typed, not a tear
        receipts = [self.receipt(h) for h in hashes]
        header = self.header_by_number(rc.block_number)
        if header is None or any(r is None for r in receipts):
            return None
        from ..protocol import prefill_hashes
        prefill_hashes(receipts, lambda r: r.encode(), self.suite)
        leaves = [r.hash(self.suite) for r in receipts]
        idx = hashes.index(tx_hash)
        proof = m.merkle_proof(leaves, idx, self.suite.hash_name)
        return proof, header.receipts_root

    # -- state-changeset proofs (ZK proof plane) ---------------------------
    def write_state_index(self, state: StorageInterface, n: int,
                          entries: Sequence[tuple[str, bytes, bytes]]
                          ) -> None:
        """Stage block n's state-proof index [(table, key, leaf_digest)]
        into the commit overlay (scheduler calls this AFTER computing
        header.state_root — the row is derived data the root does not
        cover, identical on every node running the same schedule)."""
        w = Writer()
        w.seq(entries, lambda ww, e: (
            ww.text(e[0]), ww.blob(e[1]), ww.blob(e[2])))
        state.set(T_STATEIDX, _be8(n), w.bytes())

    def state_leaf_index(self, n: int
                         ) -> Optional[list[tuple[str, bytes, bytes]]]:
        """Block n's [(table, key, leaf_digest)] or None (pre-feature
        block, pruned, or state indexing disabled)."""
        v = self.storage.get(T_STATEIDX, _be8(n))
        if not v:
            return None
        r = Reader(v)
        return r.seq(lambda rr: (rr.text(), rr.blob(), rr.blob()))

    def state_proofs(self, n: int,
                     keys: Sequence[tuple[str, bytes]]):
        """Changeset-inclusion proofs that block n wrote each (table,
        key): -> [ (proof, state_root, leaf_digest, leaf_index) | None
        (key not written in block n) ] aligned with `keys`, or None
        when NO index exists for the block (pruned / pre-feature /
        zk_proofs off — proves nothing about any key). BATCHED: one
        index decode and one tree-level build serve every requested key.
        The VALUE is not part of a proof — a verifier recomputes the
        leaf digest from the claimed value via
        executor.state_leaf_payload and checks it equals `leaf_digest`
        before walking the proof."""
        from ..ops import merkle as m
        entries = self.state_leaf_index(n)
        header = self.header_by_number(n)
        if not entries or header is None:
            return None
        pos = {(t, k): i for i, (t, k, _d) in enumerate(entries)}
        digests = [d for _t, _k, d in entries]
        levels = None
        out = []
        for table, key in keys:
            idx = pos.get((table, key))
            if idx is None:
                out.append(None)
                continue
            if levels is None:  # built once, first hit
                levels = m.merkle_levels_host(digests,
                                              self.suite.hash_name)
            out.append((m.proof_from_levels(levels, idx),
                        header.state_root, digests[idx], idx))
        return out

    def state_proof(self, n: int, table: str, key: bytes):
        """Single-key convenience over `state_proofs`."""
        got = self.state_proofs(n, [(table, key)])
        return got[0] if got else None

    # -- system config / consensus-node tables -----------------------------
    def set_system_config(self, state: StorageInterface, key: str, value: str,
                          enable_number: int) -> None:
        w = Writer()
        w.text(value).i64(enable_number)
        state.set(SYS_CONFIG, key.encode(), w.bytes())

    def system_config(self, key: str,
                      st: Optional[StorageInterface] = None) -> Optional[tuple[str, int]]:
        v = (st or self.storage).get(SYS_CONFIG, key.encode())
        if not v:
            return None
        r = Reader(v)
        return r.text(), r.i64()

    def consensus_nodes(self, st: Optional[StorageInterface] = None
                        ) -> list[ConsensusNode]:
        stg = st or self.storage
        out = []
        for k in stg.keys(SYS_CONSENSUS):
            r = Reader(stg.get(SYS_CONSENSUS, k))
            out.append(ConsensusNode(node_id=k, node_type=r.text(),
                                     weight=r.u64(), enable_number=r.i64()))
        return out

    def ledger_config(self) -> LedgerConfig:
        nodes = self.consensus_nodes()
        n = self.current_number()
        header = self.header_by_number(n)
        cfg = LedgerConfig(
            # next-block effectiveness of governance changes falls out of
            # commit visibility: the write (enable_number = block+1) only
            # becomes readable here once its block committed
            consensus_nodes=[x for x in nodes
                             if x.node_type == "consensus_sealer"],
            observer_nodes=[x for x in nodes
                            if x.node_type == "consensus_observer"],
            block_number=n,
            block_hash=header.hash(self.suite) if header else b"\x00" * 32,
        )
        v = self.system_config(SYSTEM_KEY_TX_COUNT_LIMIT)
        if v:
            cfg.block_tx_count_limit = int(v[0])
        v = self.system_config(SYSTEM_KEY_LEADER_PERIOD)
        if v:
            cfg.leader_switch_period = int(v[0])
        v = self.system_config(SYSTEM_KEY_GAS_LIMIT)
        if v:
            cfg.gas_limit = int(v[0])
        v = self.system_config(SYSTEM_KEY_COMPATIBILITY_VERSION)
        if v:
            try:
                cfg.compatibility_version = parse_version(v[0])
            except ValueError:
                pass  # pre-versioning chain: keep the default
        return cfg
