"""The port's P2P socket gateway (net/p2p.py) against the JAX package's:
tests/test_p2p.py's cases on the port's Nodes and gateways (a 4-node PBFT
chain over TCP, multi-hop routing with compression on a line, the peer
ACLs, the zstd/zlib negotiation); gateways of the two packages linked in
one mesh, each carrying the other's DATA frames and ROUTE vectors; and a
4-node chain of each package over loopback TCP (the default chain on
plain TCP, the SM chain over SM-TLS, as chip_smoke.py phase 16 wires
them) whose roots and c_balance rows are equal.

The Nodes run crypto_backend "host" (the JAX package's) and "auto" on
device "cpu" (the port's: these batches sit below device_min_batch).
Every gateway and node is stopped in `finally`.
"""

import time

import pytest
import torch

import test_torch_columnar as frames  # tests/ is on sys.path under pytest
import test_torch_node_seam as seam
import test_torch_pbft as pb
from fisco_bcos_tpu_torch.crypto.suite import make_suite
from fisco_bcos_tpu_torch.executor import precompiled as pc
from fisco_bcos_tpu_torch.init.node import Node, NodeConfig
from fisco_bcos_tpu_torch.ledger.ledger import ConsensusNode
from fisco_bcos_tpu_torch.net import p2p
from fisco_bcos_tpu_torch.net.p2p import P2PGateway
from fisco_bcos_tpu_torch.protocol import Transaction, TransactionStatus

PORT = "fisco_bcos_tpu_torch"


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def wait_until(pred, timeout=30.0):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if pred():
            return True
        time.sleep(0.05)
    return False


def _nodes(keypairs, gateways, view_timeout):
    sealers = [ConsensusNode(kp.pub_bytes) for kp in keypairs]
    nodes = []
    for kp, gw in zip(keypairs, gateways):
        node = Node(NodeConfig(consensus="pbft", crypto_backend="host", device="cpu",
                               min_seal_time=0.0, view_timeout=view_timeout, profile_hz=0),
                    keypair=kp, gateway=gw)
        node.build_genesis(sealers)
        nodes.append(node)
    return nodes


def _register(suite, kp, tag: bytes, nonce: str):
    return Transaction(to=pc.BALANCE_ADDRESS,
                       input=pc.encode_call("register", lambda w: w.blob(tag).u64(9)),
                       nonce=nonce, block_limit=100).sign(suite, kp)


# -- tests/test_p2p.py's cases on the port ------------------------------------

def test_four_node_pbft_over_tcp():
    suite = make_suite(backend="host")
    keypairs = [suite.generate_keypair(bytes([i + 40]) * 16) for i in range(4)]
    gateways = [P2PGateway(kp.pub_bytes) for kp in keypairs]
    for i, gw in enumerate(gateways):
        for j, other in enumerate(gateways):
            if i != j:
                gw.add_peer(other.host, other.port)
    nodes = []
    try:
        nodes = _nodes(keypairs, gateways, 5.0)
        for node in nodes:
            node.start()
            assert node.lightnode_server is not None
        assert wait_until(lambda: all(len(gw.peers()) == 3 for gw in gateways)), \
            [len(gw.peers()) for gw in gateways]
        tx = _register(suite, suite.generate_keypair(b"tcp-user"), b"tcp", "t1")
        assert nodes[0].send_transaction(tx).status == TransactionStatus.OK
        assert wait_until(lambda: all(n.ledger.current_number() >= 1 for n in nodes)), \
            [n.ledger.current_number() for n in nodes]
        assert len({n.ledger.header_by_number(1).hash(suite) for n in nodes}) == 1
        for n in nodes:
            rc = n.ledger.receipt(tx.hash(suite))
            assert rc is not None and rc.status == 0
    finally:
        for node in nodes:
            node.stop()
        for gw in gateways:
            gw.stop()


def test_multi_hop_routing_compression_line_topology():
    suite = make_suite(backend="host")
    keypairs = [suite.generate_keypair(bytes([i + 60]) * 16) for i in range(4)]
    gateways = [P2PGateway(kp.pub_bytes, compress_threshold=256) for kp in keypairs]
    for i in range(3):
        gateways[i].add_peer(gateways[i + 1].host, gateways[i + 1].port)
        gateways[i + 1].add_peer(gateways[i].host, gateways[i].port)
    nodes = []
    try:
        nodes = _nodes(keypairs, gateways, 8.0)
        for node in nodes:
            node.start()
        assert wait_until(lambda: all(len(gw.peers()) == 3 for gw in gateways)), \
            [len(gw.peers()) for gw in gateways]
        assert len(gateways[0]._sessions) == 1 and len(gateways[3]._sessions) == 1
        tx = _register(suite, suite.generate_keypair(b"hop-user"), b"hop", "hop1")
        assert nodes[0].send_transaction(tx).status == TransactionStatus.OK
        assert wait_until(lambda: all(n.ledger.current_number() >= 1 for n in nodes)), \
            [n.ledger.current_number() for n in nodes]
        assert len({n.ledger.header_by_number(1).hash(suite) for n in nodes}) == 1
    finally:
        for n in nodes:
            n.stop()
        for gw in gateways:
            gw.stop()


class StubFront:
    def __init__(self):
        self.got = []

    def on_network_message(self, src, data):
        self.got.append((src, data))


def test_peer_acl_allow_and_deny():
    suite = make_suite(backend="host")
    kps = [suite.generate_keypair(bytes([i + 80]) * 16) for i in range(3)]
    gw0 = P2PGateway(kps[0].pub_bytes, allow_list={kps[2].pub_bytes},
                     deny_list={kps[1].pub_bytes})
    gw1 = P2PGateway(kps[1].pub_bytes)
    gw2 = P2PGateway(kps[2].pub_bytes)
    fronts = [StubFront() for _ in range(3)]
    try:
        for gw, kp, fr in zip((gw0, gw1, gw2), kps, fronts):
            gw.register_front(kp.pub_bytes, fr)
        gw0.add_peer(gw1.host, gw1.port)
        gw1.add_peer(gw0.host, gw0.port)
        gw0.add_peer(gw2.host, gw2.port)
        gw2.add_peer(gw0.host, gw0.port)
        assert wait_until(lambda: kps[2].pub_bytes in gw0.peers(), 10)
        time.sleep(1.5)  # give the denied link time to (not) form
        assert kps[1].pub_bytes not in gw0.peers()
        blob = b"Z" * 50_000
        assert gw0.send(kps[0].pub_bytes, kps[2].pub_bytes, blob)
        assert wait_until(lambda: len(fronts[2].got) >= 1, 10)
        assert fronts[2].got[0] == (kps[0].pub_bytes, blob)
    finally:
        for gw in (gw0, gw1, gw2):
            gw.stop()


def test_zstd_codec_negotiation():
    """zstd frames only when every session negotiated CAP_ZSTD (this
    sandbox has zstandard); one legacy peer downgrades the mesh to zlib."""
    suite = make_suite(backend="host")
    kps = [suite.generate_keypair(bytes([i + 90]) * 16) for i in range(2)]
    gws = [P2PGateway(kp.pub_bytes, compress_threshold=64) for kp in kps]
    for gw, kp in zip(gws, kps):
        gw.register_front(kp.pub_bytes, StubFront())
    gws[0].add_peer(gws[1].host, gws[1].port)
    gws[1].add_peer(gws[0].host, gws[0].port)
    try:
        assert wait_until(lambda: all(len(g._sessions) == 1 for g in gws))
        flag, payload = gws[0]._encode_payload(b"z" * 512)
        assert flag == p2p.FLAG_ZSTD
        assert p2p._zstd.ZstdDecompressor().decompress(
            payload, max_output_size=1 << 16) == b"z" * 512
        with gws[0]._lock:
            for s in gws[0]._sessions.values():
                s.caps = 0
            gws[0]._recompute_codec_locked()
        flag, payload = gws[0]._encode_payload(b"z" * 512)
        assert flag == p2p.FLAG_COMPRESSED
    finally:
        for g in gws:
            g.stop()


# -- a mesh of both packages' gateways ----------------------------------------

@pytest.mark.parametrize("middle", pb.ROOTS)
def test_gateways_of_both_packages_route_and_deliver(middle):
    """A line A - B - C, the ends of one package and the middle of the
    other: the ends learn each other from B's ROUTE vectors and exchange
    DATA frames (raw, zstd and zlib) through B in transit, and B
    exchanges DATA frames with each end directly."""
    ends = [r for r in pb.ROOTS if r != middle][0]
    ids = [bytes([0x30 + i]) * 64 for i in range(3)]
    mods = [pb.mod(r, "net.p2p") for r in (ends, middle, ends)]
    gws = [m.P2PGateway(i, compress_threshold=256) for m, i in zip(mods, ids)]
    fronts = [StubFront() for _ in gws]
    for a, b in ((0, 1), (1, 2)):
        gws[a].add_peer(gws[b].host, gws[b].port)
        gws[b].add_peer(gws[a].host, gws[a].port)
    try:
        for gw, i, fr in zip(gws, ids, fronts):
            gw.register_front(i, fr)
        assert wait_until(lambda: all(len(g.peers()) == 2 for g in gws)), \
            [g.peers() for g in gws]
        assert [len(g._sessions) for g in gws] == [1, 2, 1]
        assert gws[0]._router.next_hop(ids[2]) == ids[1] == gws[2]._router.next_hop(ids[0])
        sent = {}
        for k, (s, d) in enumerate(((0, 2), (2, 0), (0, 1), (1, 0), (1, 2), (2, 1))):
            for n in (17, 300, 70_000):   # raw, then compressed
                payload = bytes([k]) * n + b"|%d>%d" % (s, d)
                assert gws[s].send(ids[s], ids[d], payload)
                sent.setdefault(d, []).append((ids[s], payload))
        assert wait_until(lambda: all(len(fronts[d].got) == len(v) for d, v in sent.items()))
        for d, v in sent.items():
            assert sorted(fronts[d].got) == sorted(v)
        # the zlib fallback: a peer that negotiated no zstd
        with gws[1]._lock:
            for s in gws[1]._sessions.values():
                s.caps = 0
            gws[1]._recompute_codec_locked()
        assert gws[1]._encode_payload(b"q" * 512)[0] == p2p.FLAG_COMPRESSED
        assert gws[1].send(ids[1], ids[0], b"q" * 512)
        assert wait_until(lambda: (ids[1], b"q" * 512) in fronts[0].got)
    finally:
        for g in gws:
            g.stop()


# -- a 4-node chain of each package over TCP ----------------------------------

CHAINS = {"ecdsa": "tcp", "sm": "smtls"}


def _tcp_chain(root: str, kind: str, blocks):
    """4 Nodes of a package on its own P2PGateways in a full mesh (SM-TLS
    on the SM chain: a seeded CA, one dual-cert credential a node), each
    batch of frames into every pool, then its height on every node.
    -> (each node's state, each node's header hashes, the session types)."""
    N = pb.mod(root, "init.node")
    L = pb.mod(root, "ledger.ledger")
    T = pb.mod(root, "protocol")
    P = pb.mod(root, "net.p2p")
    jkeys, pkeys = pb.node_keys(kind)
    keys = jkeys if root == "fisco_bcos_tpu" else pkeys
    ctxs = [None] * 4
    if CHAINS[kind] == "smtls":
        tls = pb.mod(root, "net.smtls")
        ca = tls.CertificateAuthority(seed=b"chain-ca" * 4)
        ctxs = [tls.SMTLSContext(ca.pub, ca.issue(f"node{i}", seed=b"node%d" % i * 4))
                for i in range(4)]
    gws = [P.P2PGateway(k.pub_bytes, server_ssl=c, client_ssl=c) for k, c in zip(keys, ctxs)]
    for i, gw in enumerate(gws):
        for j, other in enumerate(gws):
            if i != j:
                gw.add_peer(other.host, other.port)
    kw = dict(consensus="pbft", sm_crypto=kind == "sm", min_seal_time=0.0, view_timeout=5.0,
              profile_hz=0)
    kw.update(dict(crypto_backend="auto", device="cpu") if root == PORT else
              dict(crypto_backend="host", scheduler_workers=0))
    nodes = []
    try:
        for k, gw in zip(keys, gws):
            node = N.Node(N.NodeConfig(**kw), keypair=k, gateway=gw)
            node.build_genesis([L.ConsensusNode(x.pub_bytes) for x in keys])
            nodes.append(node)
        for node in nodes:
            node.start()
        assert wait_until(lambda: all(len(gw._sessions) == 3 for gw in gws)), \
            [len(gw._sessions) for gw in gws]
        ok = {0, int(T.TransactionStatus.ALREADY_IN_TXPOOL)}
        for h, wires in enumerate(blocks, 1):
            for node in nodes:
                res = node.txpool.submit_batch([T.Transaction.decode(w) for w in wires])
                assert {int(r.status) for r in res} <= ok
            assert wait_until(lambda: all(n.ledger.current_number() >= h for n in nodes), 60), \
                [n.ledger.current_number() for n in nodes]
        kinds = {type(s.sock).__name__ for gw in gws for s in gw._sessions.values()}
        return ([pb.chain_state(root, n) for n in nodes],
                [[n.ledger.header_by_number(h).hash(n.suite) for h in range(1, len(blocks) + 1)]
                 for n in nodes], kinds)
    finally:
        for node in nodes:
            node.stop()
        for gw in gws:
            gw.stop()


@pytest.mark.parametrize("kind", frames.CHAINS)
def test_four_node_chain_over_tcp_commits_the_jax_chain(kind):
    blocks = seam.batches(kind)
    want = _tcp_chain("fisco_bcos_tpu", kind, blocks)
    got = _tcp_chain(PORT, kind, blocks)
    assert got[0] == want[0]
    assert all(s == got[0][0] for s in got[0]) and all(h == got[1][0] for h in got[1])
    heads, rows = got[0][0]
    assert len(heads) == 2
    assert rows == {b"alice": (998).to_bytes(16, "big"), b"bob": (12).to_bytes(16, "big")}
    assert got[2] == want[2] == ({"SMSocket"} if CHAINS[kind] == "smtls" else {"socket"})
