"""The port's ledger on memory storage (ledger/ledger.py, storage/) against
the JAX package's, exactly: genesis rows, a block committed the way the
scheduler commits one (prewrite into a StateStorage overlay, the header
rows, the storage 2PC), reads, tx and receipt proofs, and a chain the JAX
ledger started carried across with storage_from_jax and continued on the
port. The port's block roots come from its CPU tensor path, the JAX
package's from its host suite.
"""

import importlib

import numpy as np
import pytest
import torch

import test_torch_columnar as frames  # tests/ is on sys.path under pytest
from fisco_bcos_tpu_torch.storage import storage_from_jax

TX_COUNT_LIMIT = 64


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Side:
    """One package's node planes above the suite (the JAX package's or the
    port's, by module root), on that package's suite: memory storage, a
    ledger with genesis over `sealers` and, with pool_limit, a txpool."""

    def __init__(self, root: str, suite, sealers, pool_limit=None, storage=None):
        def m(name):
            return importlib.import_module(f"{root}.{name}")

        self.suite = suite
        self.T = m("protocol.types")
        self.columnar = m("protocol.columnar")
        self.L = m("ledger.ledger")
        self.iface = m("storage.interface")
        self.state_mod = m("storage.state")
        self.txpool_mod = m("txpool")
        self.storage = storage if storage is not None else m("storage.memory").MemoryStorage()
        self.ledger = self.L.Ledger(self.storage, suite)
        self.genesis = self.ledger.build_genesis(
            [self.L.ConsensusNode(p) for p in sealers], tx_count_limit=TX_COUNT_LIMIT)
        self.sealers = list(sealers)
        self.pool = (self.txpool_mod.TxPool(suite, self.ledger, pool_limit=pool_limit)
                     if pool_limit else None)

    def rows(self) -> dict:
        st = self.storage
        return {t: {k: st.get(t, k) for k in st.keys(t)} for t in st.tables()}

    def commit_block(self, number: int, txs, seed: int = 5):
        """Commit `txs` as block `number` by the scheduler's two commit
        steps (scheduler/scheduler.py:300-306 prewrite and roots, :591-606
        header rows and 2PC), with seeded receipts standing in for
        execution; then tell the pool. -> the committed header."""
        T, L, suite = self.T, self.L, self.suite
        rng = np.random.default_rng(seed + number)
        parent = self.ledger.header_by_number(number - 1)
        header = T.BlockHeader(number=number, timestamp=1_700_000_000_000 + number,
                               parent_info=[T.ParentInfo(number - 1, parent.hash(suite))],
                               sealer_list=list(self.sealers))
        block = T.Block(header=header, transactions=list(txs))
        block.receipts = [T.Receipt(gas_used=int(rng.integers(21000, 10 ** 6)),
                                    status=int(rng.integers(0, 4)) % 3,
                                    output=rng.bytes(32), block_number=number)
                          for _ in txs]
        header.txs_root = block.calculate_txs_root(suite)
        header.receipts_root = block.calculate_receipts_root(suite)
        state = self.state_mod.StateStorage(self.storage)
        self.ledger.prewrite_block(block, state)
        changes = state.changeset()
        changes[(L.T_HEADER, L._be8(number))] = self.iface.Entry(header.encode())
        changes[(L.T_HASH2NUM, header.hash(suite))] = self.iface.Entry(L._be8(number))
        self.storage.prepare(number, changes)
        self.storage.commit(number)
        if self.pool is not None:
            self.pool.on_block_committed(number, [t.hash(suite) for t in txs],
                                         [t.nonce for t in txs])
        return header


def pair(kind: str, pool_limit=None):
    port, jax = frames.suites(kind)
    jkeys, _ = frames.sender_keys(kind)
    sealers = [k.pub_bytes for k in jkeys]
    return (Side("fisco_bcos_tpu_torch", port, sealers, pool_limit),
            Side("fisco_bcos_tpu", jax, sealers, pool_limit))


def block_txs(side: Side, kind: str, n: int = 24, seed: int = 11, tag: str = "a"):
    """wire_frames' rows that a pool would admit, decoded on `side`."""
    wires, txs = frames.wire_frames(kind, n=n, seed=seed, tag=tag)
    keep = [i for i, t in enumerate(txs) if t is not None
            and frames.SPECIAL.get(i) not in ("foreign-chain", "foreign-group", "repeat",
                                               "bad-signature", "short-signature")]
    return [side.T.Transaction.decode(wires[i]) for i in keep]


@pytest.mark.parametrize("kind", frames.CHAINS)
def test_genesis_rows_match_jax(kind):
    p, j = pair(kind)
    assert p.rows() == j.rows()
    assert p.genesis.encode() == j.genesis.encode()
    assert p.ledger.current_number() == j.ledger.current_number() == 0
    pc, jc = p.ledger.ledger_config(), j.ledger.ledger_config()
    assert pc.block_hash == jc.block_hash
    assert pc.block_tx_count_limit == jc.block_tx_count_limit == TX_COUNT_LIMIT
    assert [n.node_id for n in pc.consensus_nodes] == [n.node_id for n in jc.consensus_nodes]
    # idempotent
    assert p.ledger.build_genesis([]).encode() == p.genesis.encode()


@pytest.mark.parametrize("kind", frames.CHAINS)
def test_committed_block_rows_reads_and_proofs_match_jax(kind):
    p, j = pair(kind)
    ptx, jtx = block_txs(p, kind), block_txs(j, kind)
    ph, jh = p.commit_block(1, ptx), j.commit_block(1, jtx)
    assert ph.encode() == jh.encode()
    assert p.rows() == j.rows()
    assert p.ledger.current_number() == 1
    assert p.ledger.total_tx_count() == len(ptx) == j.ledger.total_tx_count()
    assert p.ledger.total_failed_count() == j.ledger.total_failed_count()
    assert p.ledger.nonces_by_number(1) == j.ledger.nonces_by_number(1)
    assert p.ledger.number_by_hash(ph.hash(p.suite)) == 1
    pb, jb = p.ledger.block_by_number(1), j.ledger.block_by_number(1)
    assert [t.encode() for t in pb.transactions] == [t.encode() for t in jb.transactions]
    assert [r.encode() for r in pb.receipts] == [r.encode() for r in jb.receipts]
    from fisco_bcos_tpu_torch.ops import merkle as pm

    for t in ptx:
        h = t.hash(p.suite)
        assert p.ledger.transaction(h).encode() == t.encode()
        assert p.ledger.receipt(h).encode() == j.ledger.receipt(h).encode()
        tp, rp = p.ledger.tx_proof(h), p.ledger.receipt_proof(h)
        assert tp == j.ledger.tx_proof(h) and rp == j.ledger.receipt_proof(h)
        assert tp[1] == ph.txs_root and rp[1] == ph.receipts_root
        assert pm.verify_merkle_proof(h, tp[0], tp[1], p.suite.hash_name)
        leaf = p.ledger.receipt(h).hash(p.suite)
        assert pm.verify_merkle_proof(leaf, rp[0], rp[1], p.suite.hash_name)
    assert p.ledger.tx_proof(b"\x01" * 32) is None is j.ledger.tx_proof(b"\x01" * 32)


@pytest.mark.parametrize("kind", frames.CHAINS)
def test_chain_carried_from_jax_continues_on_the_port(kind):
    """Genesis and block 1 on the JAX ledger; its rows carried across with
    storage_from_jax; block 2 commits to identical rows on both sides."""
    port, _ = frames.suites(kind)
    _, j = pair(kind)
    j.commit_block(1, block_txs(j, kind, seed=12, tag="b"))
    st = storage_from_jax(j.rows())
    p = Side("fisco_bcos_tpu_torch", port, j.sealers, storage=st)
    assert p.rows() == j.rows() and p.ledger.current_number() == 1
    ph = p.commit_block(2, block_txs(p, kind, seed=13, tag="c"))
    jh = j.commit_block(2, block_txs(j, kind, seed=13, tag="c"))
    assert ph.encode() == jh.encode()
    assert p.rows() == j.rows()
    assert p.ledger.current_number() == 2
    with pytest.raises(TypeError):
        storage_from_jax({"t": {"k": b"v"}})
