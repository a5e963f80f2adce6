"""The port's light node (lightnode/lightnode.py) against the JAX package's:
each case of tests/test_lightnode.py runs on a solo Node and a
LightNodeClient of each package over the package's FakeGateway (the JAX
Node on its host suite, the port's on crypto_backend "host", device
"cpu"), from the same signed txs, and the port's verdicts, payloads and
suite call counts must equal the JAX package's: the roundtrip, a wrong
consensus set, the span call counts, a tampered proof root, typed pruned
history, distinct-sealer quorums, garbage responses, the one-lane cert
span and the aggregate span. Then a port client on a device suite
(device "cpu": the kernels' plain versions) judges a span as the host
suite's client does, one verify batch and one identity and one proof
hash batch a span, and a client of each package reads a server of the
other over loopback TCP.
"""

import time

import pytest
import torch

import test_torch_pbft as pb  # tests/ is on sys.path under pytest

JAX, PORT = pb.ROOTS


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _node(root: str, gw, **cfg):
    N = pb.mod(root, "init.node")
    extra = dict(scheduler_workers=0) if root == JAX else dict(device="cpu")
    node = N.Node(N.NodeConfig(crypto_backend="host", min_seal_time=0.0, profile_hz=0,
                               **extra, **cfg), gateway=gw)
    node.start()
    return node


def _setup(root: str, **cfg):
    gw = pb.mod(root, "net.gateway").FakeGateway()
    node = _node(root, gw, **cfg)
    lfront = pb.mod(root, "net.front").FrontService(b"L" * 32, gw)
    client = pb.mod(root, "lightnode").LightNodeClient(lfront, node.suite, _sealers(node))
    return gw, node, client


def _sealers(node):
    return [n.node_id for n in node.ledger.ledger_config().consensus_nodes]


def _stop(gw, node):
    node.stop()
    gw.stop()


def _register(root: str, node, kp, tag: bytes, nonce: str, amount: int = 1):
    T, pc = pb.mod(root, "protocol"), pb.mod(root, "executor.precompiled")
    return T.Transaction(to=pc.BALANCE_ADDRESS,
                         input=pc.encode_call("register",
                                              lambda w: w.blob(tag).u64(amount)),
                         nonce=nonce, block_limit=node.ledger.current_number() + 100
                         ).sign(node.suite, kp)


def _commit_block(root: str, node, kp, tag: bytes, n: int = 4):
    """One batch-submitted cohort -> at least one multi-tx block."""
    txs = [_register(root, node, kp, b"%s%d" % (tag, i), f"{tag.decode()}-{i}")
           for i in range(n)]
    for res in node.txpool.submit_batch(txs):
        assert int(res.status) == 0, res
    hashes = [tx.hash(node.suite) for tx in txs]
    for h in hashes:
        assert node.txpool.wait_for_receipt(h, 20) is not None
    return hashes


def _commit_one(root: str, node, kp, tag: bytes, nonce: str):
    tx = _register(root, node, kp, tag, nonce)
    node.send_transaction(tx)
    assert node.txpool.wait_for_receipt(tx.hash(node.suite), 20) is not None
    return tx.hash(node.suite)


def _enc(x):
    """A comparable form of a client result: encodings, typed floors."""
    if x is None:
        return None
    if isinstance(x, list):
        return [_enc(e) for e in x]
    if type(x).__name__ == "Pruned":
        return ("pruned", x.below)
    return x.encode()


class _CountingSuite:
    """Delegating wrapper counting the batch crypto entry points."""

    def __init__(self, suite):
        self._suite = suite
        self.verify_calls = 0
        self.hash_calls = 0
        self.verify_sizes = []

    def __getattr__(self, name):
        return getattr(self._suite, name)

    def verify_batch(self, digests, sigs, pubs):
        self.verify_calls += 1
        self.verify_sizes.append(len(digests))
        return self._suite.verify_batch(digests, sigs, pubs)

    def hash_batch(self, msgs):
        self.hash_calls += 1
        return self._suite.hash_batch(msgs)

    def counts(self):
        out = (self.verify_calls, self.hash_calls, list(self.verify_sizes))
        self.verify_calls = self.hash_calls = 0
        self.verify_sizes = []
        return out


def _both(case):
    got, want = case(PORT), case(JAX)
    assert got == want
    return got


# -- tests/test_lightnode.py's cases, the port held to the JAX package --------

def _roundtrip(root: str):
    gw, node, client = _setup(root)
    try:
        kp = node.suite.generate_keypair(b"light-user")
        status, tx_hash = client.send_transaction(_register(root, node, kp, b"la", "ln1", 9))
        deadline = time.time() + 10
        while (client.status() or 0) < 1 and time.time() < deadline:
            time.sleep(0.02)
        header = client.header(1)
        got_tx, rc = client.transaction(tx_hash), client.receipt(tx_hash)
        T, pc = pb.mod(root, "protocol"), pb.mod(root, "executor.precompiled")
        st, out = client.call(T.Transaction(
            to=pc.BALANCE_ADDRESS, input=pc.encode_call("balanceOf", lambda w: w.blob(b"la"))))
        return (status, tx_hash, client.status() >= 1, header.number, got_tx.nonce,
                got_tx.encode(), rc.status, rc.encode(), st,
                pb.mod(root, "codec.wire").Reader(out).u64())
    finally:
        _stop(gw, node)


def test_lightnode_roundtrip():
    got = _both(_roundtrip)
    assert got[0] == 0 and got[2:5] == (True, 1, "ln1") and got[6] == 0
    assert got[8:] == (0, 9)


def _bad_quorum(root: str):
    gw, node, client = _setup(root)
    try:
        kp = node.suite.generate_keypair(b"light-user2")
        client.send_transaction(_register(root, node, kp, b"lb", "ln2"))
        deadline = time.time() + 10
        while (client.status() or 0) < 1 and time.time() < deadline:
            time.sleep(0.02)
        rogue = type(client)(client.front, node.suite, [b"\x99" * 64])
        return rogue.header(1) is None, client.header(1) is not None
    finally:
        _stop(gw, node)


def test_lightnode_rejects_bad_quorum():
    assert _both(_bad_quorum) == (True, True)


def _span_counts(root: str):
    gw, node, _ = _setup(root)
    try:
        kp = node.suite.generate_keypair(b"light-span")
        hashes = _commit_block(root, node, kp, b"sp", n=4)
        for i in range(2):
            _commit_one(root, node, kp, b"sr%d" % i, f"sr-{i}")
        head = node.ledger.current_number()
        counting = _CountingSuite(node.suite)
        lfront = pb.mod(root, "net.front").FrontService(b"C" * 32, gw)
        client = pb.mod(root, "lightnode").LightNodeClient(lfront, counting, _sealers(node))
        headers = client.header_range(1, head)
        c1 = counting.counts()
        got = client.transactions(hashes)
        c2 = counting.counts()
        rcs = client.receipts(hashes)
        c3 = counting.counts()
        return (head, [h.number for h in headers], c1, [t.nonce for t in got], _enc(got), c2,
                _enc(rcs), c3)
    finally:
        _stop(gw, node)


def test_lightnode_span_verification_call_counts():
    head, numbers, c1, nonces, _txs, c2, rcs, c3 = _both(_span_counts)
    assert numbers == list(range(1, head + 1))
    assert c1[0] == 1 and c1[2][0] >= head   # one verify batch: every seal of the span
    assert nonces == [f"sp-{i}" for i in range(4)]
    assert c2[:2] == (1, 3)
    assert all(rc is not None for rc in rcs) and c3[:2] == (1, 4)


def _tampered_root(root: str):
    gw, node, client = _setup(root)
    try:
        kp = node.suite.generate_keypair(b"light-tamper")
        hashes = _commit_block(root, node, kp, b"tp", n=3)
        before = _enc(client.transactions(hashes))
        orig = node.lightnode_server._block_levels

        def lying(memo, number, want_tx):
            ctx = orig(memo, number, want_tx)
            return None if ctx is None else (ctx[0], ctx[1], b"\x13" * 32)

        node.lightnode_server._block_levels = lying
        return before, _enc(client.transactions(hashes))
    finally:
        _stop(gw, node)


def test_lightnode_rejects_tampered_proof_root():
    before, after = _both(_tampered_root)
    assert all(tx is not None for tx in before) and after == [None] * 3


def _pruned(root: str):
    T_NUM2TXS = pb.mod(root, "ledger.ledger").T_NUM2TXS
    gw, node, client = _setup(root)
    try:
        kp = node.suite.generate_keypair(b"light-prune")
        old = _commit_block(root, node, kp, b"pr", n=2)
        new = _commit_block(root, node, kp, b"pn", n=2)
        cut = node.ledger.receipt(new[0]).block_number
        node.ledger.prune_block_data(cut, keep_nonces=0)
        out = [cut, node.ledger.pruned_below(), _enc(client.transactions(old)),
               _enc(client.receipts(old)), client.header(1) is not None,
               _enc(client.transaction(new[0]))]
        num = node.ledger.receipt(new[0]).block_number
        node.storage.remove_batch(T_NUM2TXS, [num.to_bytes(8, "big")])
        out.append(_enc(client.receipts([new[0]])))
        return out
    finally:
        _stop(gw, node)


def test_lightnode_pruned_history_is_typed():
    cut, floor, txs, rcs, header_ok, recent, torn = _both(_pruned)
    assert floor == cut
    assert txs == rcs == [("pruned", cut)] * 2
    assert header_ok and recent is not None and torn == [("pruned", cut)]


def _distinct_sealers(root: str):
    suite = pb.mod(root, "crypto.suite").make_suite(backend="host")
    LightNodeClient = pb.mod(root, "lightnode").LightNodeClient
    kps = [suite.generate_keypair(b"q%d" % i) for i in range(4)]
    client = LightNodeClient(front=None, suite=suite, consensus_nodes=[k.pub_bytes for k in kps])
    header = pb.mod(root, "protocol").BlockHeader(number=7, extra_data=b"forged")
    hh = header.hash(suite)
    idx0 = client.sealers.index(kps[0].pub_bytes)
    header.signature_list = [(idx0, suite.sign(kps[0], hh))] * 3
    replayed = client.verify_header(header)
    header.signature_list = [(client.sealers.index(kp.pub_bytes), suite.sign(kp, hh))
                             for kp in kps[:3]]
    return client.quorum, replayed, client.verify_header(header), header.encode()


def test_lightnode_quorum_counts_distinct_sealers():
    assert _both(_distinct_sealers)[:3] == (3, False, True)


def _garbage(root: str):
    gw, node, client = _setup(root)
    try:
        kp = node.suite.generate_keypair(b"light-garb")
        hashes = _commit_block(root, node, kp, b"gb", n=2)
        out = [_enc(client.transaction(hashes[0]))]
        orig = client.front.request
        client.front.request = lambda module, peer, payload, timeout=5.0: \
            b"\xff\xff\xff\xff\x00\x01garbage"
        try:
            out += [client.transactions(hashes), client.receipts(hashes),
                    client.header_range(1, 2), client.header(1)]
        finally:
            client.front.request = orig
        out.append(_enc(client.transaction(hashes[0])))
        return out
    finally:
        _stop(gw, node)


def test_lightnode_rejects_garbage_responses():
    first, txs, rcs, hdrs, hdr, last = _both(_garbage)
    assert first is not None and last == first
    assert txs == rcs == hdrs == [None, None] and hdr is None


def _cert_span(root: str):
    qc = pb.mod(root, "consensus.qc")
    gw, node, _ = _setup(root, seal_mode="cert")
    try:
        kp = node.suite.generate_keypair(b"light-cert")
        _commit_block(root, node, kp, b"lc", n=2)
        for i in range(2):
            _commit_one(root, node, kp, b"lc%d" % i, f"lcr-{i}")
        head = node.ledger.current_number()
        counting = _CountingSuite(node.suite)
        lfront = pb.mod(root, "net.front").FrontService(b"C" * 32, gw)
        sealers = _sealers(node)
        client = pb.mod(root, "lightnode").LightNodeClient(lfront, counting, sealers)
        headers = client.header_range(1, head)
        certs = [qc.extract(h) is not None for h in headers]
        c1 = counting.counts()
        legacy = node.ledger.header_by_number(1)
        cert = qc.extract(legacy)
        idxs = qc.idxs_from_bitmap(cert.bitmap, len(sealers))
        ssz = node.suite.signature_size
        legacy.signature_list = [(j, cert.payload[k * ssz:(k + 1) * ssz])
                                 for k, j in enumerate(idxs)]
        ok = client.verify_headers([legacy] + [node.ledger.header_by_number(b)
                                               for b in range(2, head + 1)])
        return head, [h.number for h in headers], certs, c1, [bool(x) for x in ok], \
            counting.counts()
    finally:
        _stop(gw, node)


def test_lightnode_cert_span_is_one_lane_call():
    head, numbers, certs, c1, ok, c2 = _both(_cert_span)
    assert numbers == list(range(1, head + 1)) and all(certs)
    assert c1[0] == 1 and all(ok) and c2[0] == 1


def _aggregate_span(root: str):
    agg = pb.mod(root, "crypto.agg")
    gw, node, _ = _setup(root, seal_mode="aggregate")
    try:
        registry = agg.AggKeyRegistry.from_seeds(
            [(node.keypair.pub_bytes, node.keypair.secret.to_bytes(32, "big"))])
        kp = node.suite.generate_keypair(b"light-agg")
        _commit_one(root, node, kp, b"ag", "ag-1")
        counting = _CountingSuite(node.suite)
        F, L = pb.mod(root, "net.front").FrontService, pb.mod(root, "lightnode").LightNodeClient
        sealers = _sealers(node)
        with_reg = L(F(b"C" * 32, gw), counting, sealers, agg_registry=registry)
        h = with_reg.header(1)
        without = L(F(b"D" * 32, gw), node.suite, sealers)
        return h is not None and h.number == 1, counting.counts()[0], without.header(1) is None
    finally:
        _stop(gw, node)


def test_lightnode_aggregate_span_skips_the_lane():
    assert _both(_aggregate_span) == (True, 0, True)


# -- the port's client on a device suite ---------------------------------------

def test_a_client_on_a_device_suite_judges_spans_as_the_host_suite_does():
    """One port server; a port client on make_suite(device="cpu") (the
    tensor path: the kernels' plain versions) and one on the host suite.
    The header span is one verify batch, the tx span one identity and one
    proof hash batch (plus the header-hash prefill), and every verdict and
    payload equals the host client's. (Two EC calls: each costs 10-40 s
    on the plain path on this CPU; chip_smoke.py phase 16 runs the rogue
    set and the tampered root on the card.)"""
    from fisco_bcos_tpu_torch.crypto.suite import make_suite
    from fisco_bcos_tpu_torch.lightnode import LightNodeClient
    from fisco_bcos_tpu_torch.net.front import FrontService

    gw, node, host_client = _setup(PORT)
    try:
        kp = node.suite.generate_keypair(b"light-dev")
        hashes = _commit_block(PORT, node, kp, b"dv", n=6)
        head = node.ledger.current_number()
        counting = _CountingSuite(make_suite(device="cpu"))
        assert counting.backend == "device" and counting.device.type == "cpu"
        client = LightNodeClient(FrontService(b"V" * 32, gw), counting, _sealers(node))
        headers = client.header_range(1, head)
        assert counting.counts()[:2] == (1, 1)   # the seals; the header hashes
        txs = client.transactions(hashes)
        assert counting.counts()[:2] == (1, 3)   # + the identities, the proof levels
        want_h = host_client.header_range(1, head)
        assert [h.encode() for h in headers] == [h.encode() for h in want_h]
        assert _enc(txs) == _enc(host_client.transactions(hashes))
        assert all(t is not None for t in txs)
    finally:
        _stop(gw, node)


# -- the two packages over loopback TCP ----------------------------------------

@pytest.mark.parametrize("server", pb.ROOTS)
def test_a_client_reads_the_other_package_s_server_over_tcp(server):
    """A solo Node of one package on its P2PGateway, a light client of the
    other on its own gateway dialing it: status, a verified header, a
    verified tx and receipt, and an admitted send_transaction."""
    client_root = PORT if server == JAX else JAX
    P_srv, P_cli = pb.mod(server, "net.p2p"), pb.mod(client_root, "net.p2p")
    srv_suite = pb.mod(server, "crypto.suite").make_suite(backend="host")
    cli_suite = pb.mod(client_root, "crypto.suite").make_suite(backend="host")
    node_kp = srv_suite.generate_keypair(b"tcp-light-node")
    sgw = P_srv.P2PGateway(node_kp.pub_bytes)
    cgw = P_cli.P2PGateway(b"\x01" * 64)
    cgw.add_peer(sgw.host, sgw.port)   # the smaller id of the two dials
    sgw.add_peer(cgw.host, cgw.port)
    N = pb.mod(server, "init.node")
    extra = dict(scheduler_workers=0) if server == JAX else dict(device="cpu")
    node = N.Node(N.NodeConfig(crypto_backend="host", min_seal_time=0.0, profile_hz=0,
                               **extra), keypair=node_kp, gateway=sgw)
    try:
        node.start()
        front = pb.mod(client_root, "net.front").FrontService(b"\x01" * 64, cgw)
        client = pb.mod(client_root, "lightnode").LightNodeClient(
            front, cli_suite, [node_kp.pub_bytes])
        assert pb.wait_until(lambda: len(cgw.peers()) == 1, 20)
        user = cli_suite.generate_keypair(b"tcp-light-user")
        T, pc = pb.mod(client_root, "protocol"), pb.mod(client_root, "executor.precompiled")
        tx = T.Transaction(to=pc.BALANCE_ADDRESS, nonce="tl-1", block_limit=100,
                           input=pc.encode_call("register", lambda w: w.blob(b"tl").u64(5))
                           ).sign(cli_suite, user)
        status, tx_hash = client.send_transaction(tx)
        assert status == 0 and tx_hash == tx.hash(cli_suite)
        assert pb.wait_until(lambda: (client.status() or 0) >= 1, 20)
        assert client.header(1).number == 1
        assert client.transaction(tx_hash).encode() == tx.encode()
        assert client.receipt(tx_hash).status == 0
    finally:
        node.stop()
        sgw.stop()
        cgw.stop()
