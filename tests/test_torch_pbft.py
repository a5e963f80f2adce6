"""The port's PBFT engine (consensus/pbft/) against the JAX package's:
PBFTMessage encodings of every packet type, signed on both suites (RFC
6979 nonces, so byte for byte), packed message lists and their decode
caps; the durable consensus log's rows after the same writes; and 4-node
chains of each package's own Node over a FakeGateway in the `cert` and
`aggregate` seal modes and across a view change after the height's
leader is partitioned. A chain is compared by every committed block's
roots and the c_balance rows (header hashes carry the seal time), and
within a chain by the header hashes across nodes.

The chains run on crypto_backend "auto" (the port's suite on the CPU:
these batches sit below device_min_batch, so the host path), as a tensor
path at every PBFT packet would stall on this CPU. Deadlines wait on a
condition for up to 120 s and return as soon as it holds; every cluster
is stopped in `finally`.
"""

import importlib
import time

import numpy as np
import pytest
import torch

import test_torch_columnar as frames  # tests/ is on sys.path under pytest
import test_torch_node_seam as seam
from fisco_bcos_tpu.crypto import suite as jsuite
from fisco_bcos_tpu_torch.crypto import suite as psuite

ROOTS = ("fisco_bcos_tpu", "fisco_bcos_tpu_torch")
DEADLINE = 120.0


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def mod(root: str, name: str):
    return importlib.import_module(f"{root}.{name}")


def wait_until(pred, timeout=DEADLINE):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if pred():
            return True
        time.sleep(0.01)
    return False


def host_suites(kind: str):
    """(JAX host suite, port suite on "auto" on the CPU)."""
    sm = kind == "sm"
    return (jsuite.make_suite(sm, backend="host"),
            psuite.make_suite(sm, backend="auto", device="cpu"))


def node_keys(kind: str, n: int = 4):
    """(JAX key pairs, port key pairs) of the same secrets."""
    j, p = host_suites(kind)
    jkeys = [j.generate_keypair(bytes([i + 1]) * 16) for i in range(n)]
    return jkeys, [p.keypair_from_secret(k.secret) for k in jkeys]


def chain_state(root: str, node):
    """Every committed block's (number, state, tx, receipt roots) and the
    c_balance rows of a node of the package at `root`."""
    pc = mod(root, "executor.precompiled")
    heads = []
    for k in range(1, node.ledger.current_number() + 1):
        h = node.ledger.header_by_number(k)
        heads.append((k, h.state_root, h.txs_root, h.receipts_root))
    st = node.storage
    return heads, {k: st.get(pc.T_BALANCE, k) for k in st.keys(pc.T_BALANCE)}


class Cluster:
    """n Nodes of one package (the JAX package's or the port's, by module
    root) in PBFT mode over one FakeGateway, the genesis over all n keys.
    `storages` restarts the nodes on carried storage."""

    def __init__(self, root: str, kind: str, n: int = 4, seal_mode: str = "multi",
                 view_timeout: float = 2.0, storages=None, agg_registry=None):
        self.root = root
        self.T = mod(root, "protocol")
        node_mod = mod(root, "init.node")
        L = mod(root, "ledger.ledger")
        jkeys, pkeys = node_keys(kind, n)
        self.keys = jkeys if root == "fisco_bcos_tpu" else pkeys
        self.gateway = mod(root, "net.gateway").FakeGateway()
        kw = dict(consensus="pbft", sm_crypto=kind == "sm", crypto_backend="auto",
                  min_seal_time=0.0, view_timeout=view_timeout, seal_mode=seal_mode,
                  agg_registry=agg_registry, profile_hz=0, scheduler_workers=0)
        if root == "fisco_bcos_tpu_torch":
            kw["device"] = "cpu"
        self.nodes = []
        for i, kp in enumerate(self.keys):
            node = node_mod.Node(node_mod.NodeConfig(**kw), keypair=kp, gateway=self.gateway,
                                 storage=None if storages is None else storages[i])
            if storages is None:
                node.build_genesis([L.ConsensusNode(k.pub_bytes) for k in self.keys])
            self.nodes.append(node)

    def start(self):
        for node in self.nodes:
            node.start()
        return self

    def stop(self):
        for node in self.nodes:
            node.stop()
        self.gateway.stop()

    def by_index(self, idx: int):
        """The node at consensus index idx (sorted by public key)."""
        order = sorted(range(len(self.keys)), key=lambda i: self.keys[i].pub_bytes)
        return self.nodes[order[idx]]

    def submit(self, wires, nodes=None):
        """The frames into every node's pool (the first admits them; gossip
        may have brought them to the others already)."""
        ok = {0, int(self.T.TransactionStatus.ALREADY_IN_TXPOOL)}
        for k, node in enumerate(nodes or self.nodes):
            res = node.txpool.submit_batch([self.T.Transaction.decode(w) for w in wires])
            got = {int(r.status) for r in res}
            assert got == {0} or (k > 0 and got <= ok), got

    def wait(self, height: int, nodes=None) -> None:
        nodes = nodes or self.nodes
        assert wait_until(lambda: all(n.ledger.current_number() >= height for n in nodes)), \
            [n.ledger.current_number() for n in self.nodes]

    def state(self, node):
        return chain_state(self.root, node)

    def header_hashes(self, node):
        return [node.ledger.header_by_number(k).hash(node.suite)
                for k in range(1, node.ledger.current_number() + 1)]

    def rows(self, node):
        st = node.storage
        return {t: {k: st.get(t, k) for k in st.keys(t)} for t in st.tables()}


def run_chain(root: str, kind: str, blocks, **kw):
    """Each batch of frames to every node, then its height on every node.
    -> (each node's state, each node's header hashes, each node's
    consensus status)."""
    c = Cluster(root, kind, **kw).start()
    try:
        for k, wires in enumerate(blocks):
            c.submit(wires)
            c.wait(k + 1)
        return ([c.state(n) for n in c.nodes], [c.header_hashes(n) for n in c.nodes],
                [n.consensus.status() for n in c.nodes],
                [n.ledger.header_by_number(k + 1) for n in c.nodes[:1]
                 for k in range(len(blocks))])
    finally:
        c.stop()


# -- messages ---------------------------------------------------------------


def _messages(root: str, kind: str):
    """Seeded packets of every type, signed by the node keys."""
    pb = mod(root, "consensus.pbft")
    msgs = mod(root, "consensus.pbft.messages")
    j, p = host_suites(kind)
    suite = j if root == "fisco_bcos_tpu" else p
    jkeys, pkeys = node_keys(kind)
    keys = jkeys if root == "fisco_bcos_tpu" else pkeys
    rng = np.random.default_rng(5)
    out = []
    for t in msgs.PacketType:
        for k in range(2):
            m = pb.PBFTMessage(packet_type=int(t), view=int(rng.integers(0, 2 ** 40)),
                               number=int(rng.integers(0, 2 ** 40)),
                               timestamp=1_700_000_000_000 + k, from_idx=k,
                               proposal_hash=rng.bytes(32), payload=rng.bytes(int(t) * 97))
            out.append(m.sign(suite, keys[k]))
    return out, msgs, suite


@pytest.mark.parametrize("kind", frames.CHAINS)
def test_pbft_messages_are_byte_equal(kind):
    """encode_core, the packet hash, the signature and the wire form of
    every packet type; pack_messages of all of them; each package decodes
    the other's bytes to the same fields; the decode cap holds."""
    (jm, jmsgs, js), (pm, pmsgs, ps) = (_messages(r, kind) for r in ROOTS)
    assert [m.encode_core() for m in jm] == [m.encode_core() for m in pm]
    assert [m.hash(js) for m in jm] == [m.hash(ps) for m in pm]
    assert [m.encode() for m in jm] == [m.encode() for m in pm]
    packed = pmsgs.pack_messages(pm)
    assert packed == jmsgs.pack_messages(jm)
    back = pmsgs.unpack_messages(jmsgs.pack_messages(jm))
    assert [m.encode() for m in back] == [m.encode() for m in pm]
    assert [m.encode() for m in jmsgs.unpack_messages(packed)] == [m.encode() for m in jm]
    for m in pm:
        assert ps.verify(ps_pub(kind, m.from_idx), m.hash(ps), m.signature)
    with pytest.raises(ValueError):
        pmsgs.unpack_messages(packed, max_count=len(pm) - 1)
    with pytest.raises(ValueError):
        jmsgs.unpack_messages(packed, max_count=len(pm) - 1)
    made = [mod(r, "consensus.pbft.messages").make_packet(
        mod(r, "consensus.pbft.messages").PacketType.CHECKPOINT, 3, 9, 2, b"h" * 32, b"seal")
        for r in ROOTS]
    for m in made:
        m.timestamp = 0
    assert made[0].encode() == made[1].encode()


def ps_pub(kind: str, idx: int) -> bytes:
    return node_keys(kind)[1][idx].pub_bytes


def _log_rows(root: str, kind: str):
    """The same writes through each package's PBFTLog on its memory
    storage: a view, three heights' proposals and votes, a prune, a view
    change's clear, a later proposal; the rows after each step."""
    st = mod(root, "storage.memory").MemoryStorage()
    plog = mod(root, "consensus.pbft.storage")
    log = plog.PBFTLog(st)
    (msgs, _, _) = _messages(root, kind)

    def rows():
        return {t: {k: st.get(t, k) for k in st.keys(t)} for t in st.tables()}

    trail = [log.load_view()]
    log.save_view(3)
    for n in (5, 6, 7):
        log.save_proposal(n, msgs[n % len(msgs)].encode(), b"block %d" % n)
        log.save_packet(n, plog.TAG_PREPARE, msgs[(n + 1) % len(msgs)].encode())
        if n != 6:
            log.save_packet(n, plog.TAG_COMMIT, msgs[(n + 2) % len(msgs)].encode())
    trail += [rows(), log.load_view(), log.load_height(6)]
    log.prune(6)
    trail += [rows(), log.load_height(5), log.load_height(7)]
    log.save_view(4)
    log.clear_heights()
    trail += [rows(), log.load_view()]
    log.save_proposal(8, msgs[0].encode(), b"block 8")
    trail.append(rows())
    return trail


@pytest.mark.parametrize("kind", frames.CHAINS)
def test_pbft_log_rows_are_equal(kind):
    j, p = (_log_rows(r, kind) for r in ROOTS)
    assert j == p
    assert p[0] == 0 and p[2] == 3 and p[-2] == 4
    assert set(p[3]) == {b"pp", b"bk", b"pv"}


# -- chains -----------------------------------------------------------------


@pytest.mark.parametrize("kind", frames.CHAINS)
def test_cert_mode_chain_commits_the_jax_chain(kind):
    """seal_mode cert: both packages' 4-node chains commit the same roots
    and rows; every header carries one certificate of a 2f+1 quorum,
    judged true by the port's seal judge."""
    blocks = seam.batches(kind)
    want = run_chain("fisco_bcos_tpu", kind, blocks, seal_mode="cert")
    got = run_chain("fisco_bcos_tpu_torch", kind, blocks, seal_mode="cert")
    assert got[0] == want[0]
    assert all(s == got[0][0] for s in got[0]) and all(h == got[1][0] for h in got[1])
    qc = mod("fisco_bcos_tpu_torch", "consensus.qc")
    keys = sorted(k.pub_bytes for k in node_keys(kind)[1])
    _, port = host_suites(kind)
    for h in got[3]:
        cert = qc.extract(h)
        assert len(h.signature_list) == 1 and cert.mode == qc.MODE_CERT
        assert cert.signer_count() >= 3
    assert all(qc.verify_spans(got[3], keys, port))
    assert {s["sealMode"] for s in got[2]} == {"cert"}
    assert len(got[0][0][0]) == 2
    assert got[0][0][1] == {b"alice": (998).to_bytes(16, "big"),
                            b"bob": (12).to_bytes(16, "big")}


def test_aggregate_mode_chain_commits_the_jax_chain():
    """seal_mode aggregate on the default chain: the BLS aggregate seal of
    PoP-registered keys, the same roots and rows as the JAX chain, the
    certificate judged true by the port's seal judge."""
    kind = "ecdsa"
    blocks = seam.batches(kind)[:1]
    jkeys, pkeys = node_keys(kind)
    regs = [mod(r, "crypto.agg").AggKeyRegistry.from_seeds(
        [(k.pub_bytes, k.secret.to_bytes(32, "big")) for k in keys])
        for r, keys in zip(ROOTS, (jkeys, pkeys))]
    want = run_chain("fisco_bcos_tpu", kind, blocks, seal_mode="aggregate",
                     view_timeout=30.0, agg_registry=regs[0])
    got = run_chain("fisco_bcos_tpu_torch", kind, blocks, seal_mode="aggregate",
                    view_timeout=30.0, agg_registry=regs[1])
    assert got[0] == want[0]
    assert all(h == got[1][0] for h in got[1])
    qc = mod("fisco_bcos_tpu_torch", "consensus.qc")
    h = got[3][0]
    cert = qc.extract(h)
    assert cert is not None and cert.mode == qc.MODE_AGGREGATE and cert.signer_count() >= 3
    _, port = host_suites(kind)
    assert qc.verify_spans([h], sorted(k.pub_bytes for k in pkeys), port,
                           agg_registry=regs[1])[0]
    assert {s["sealMode"] for s in got[2]} == {"aggregate"}


def _view_change_chain(root: str, kind: str):
    """Height 1's leader partitioned before the txs go in: the three live
    nodes change view and commit; the leader, healed, catches up by block
    sync to the same header. -> (states, header hashes, views, sealer)."""
    c = Cluster(root, kind).start()
    try:
        leader = c.by_index(1)  # (number 1 // leader_period 1 + view 0) % 4
        live = [n for n in c.nodes if n is not leader]
        c.gateway.partition(leader.keypair.pub_bytes)
        c.submit(seam.batches(kind)[0], nodes=live)
        c.wait(1, nodes=live)
        views = [n.consensus.view for n in live]
        recovered = []
        inner = leader.suite.recover_addresses

        def recording(digests, sigs):
            recovered.append(len(digests))
            return inner(digests, sigs)

        leader.suite.recover_addresses = recording
        c.gateway.partition(leader.keypair.pub_bytes, isolated=False)
        c.wait(1)
        return ([c.state(n) for n in c.nodes], [c.header_hashes(n) for n in c.nodes],
                views, live[0].ledger.header_by_number(1).sealer, recovered)
    finally:
        c.stop()


def test_view_change_after_the_leader_is_partitioned_matches_jax():
    """The chain and the healed leader's block sync match the JAX Nodes';
    the port's sync replay recovers the fetched txs' senders in one batch
    where the JAX package's executor recovers them one tx at a time (a
    port difference, ROADMAP.md C: the same senders)."""
    kind = "sm"
    want = _view_change_chain("fisco_bcos_tpu", kind)
    got = _view_change_chain("fisco_bcos_tpu_torch", kind)
    assert got[0] == want[0]
    assert all(s == got[0][0] for s in got[0]) and all(h == got[1][0] for h in got[1])
    assert min(got[2]) >= 1 and min(want[2]) >= 1
    assert got[3] != 1 and want[3] != 1
    ntx = len(seam.batches(kind)[0])
    assert got[4] == [ntx] and want[4] == [1] * ntx
