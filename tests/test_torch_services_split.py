"""The port's Pro service split against the JAX package's: the txpool,
ledger, front and scheduler services (services/{txpool,ledger,gateway,
scheduler}_service.py) and the stateless Pro RPC service
(services/rpc_service.py: ProNodeConfig, ProNodeFacade, make_pro_rpc).
Each package's servers over its own planes, driven by the same signed
txs (frames signed on the JAX host suite); the proxies' answers compared
across the packages, one proxy of each package against the other's
server; and a Pro stack of each package (a solo core Node, its four
services, the JSON-RPC service over their proxies) answering the SDK's
requests alike."""

import importlib
import time

import pytest

import test_torch_pbft as pb  # tests/ is on sys.path under pytest
import test_torch_rpc as rpc

ROOTS = ("fisco_bcos_tpu", "fisco_bcos_tpu_torch")
JAX, PORT = ROOTS


def mod(root: str, name: str):
    return importlib.import_module(f"{root}.{name}")


def wait_until(pred, bound: float = 30.0) -> bool:
    t0 = time.monotonic()
    while time.monotonic() - t0 < bound:
        if pred():
            return True
        time.sleep(0.02)
    return False


def signed(n: int, tag: str) -> list:
    from fisco_bcos_tpu.crypto.suite import make_suite
    from fisco_bcos_tpu.executor import precompiled as pc
    from fisco_bcos_tpu.protocol import Transaction

    suite = make_suite(backend="host")
    kp = pb.node_keys("ecdsa", 6)[0][5]
    return [Transaction(to=pc.BALANCE_ADDRESS, nonce=f"{tag}{i}", block_limit=100,
                        input=pc.encode_call("register", lambda w, i=i: w.blob(b"%s%d" % (
                            tag.encode(), i)).u64(1 + i))).sign(suite, kp).encode()
            for i in range(n)]


def pool_env(root: str):
    """A package's ledger (genesis over the shared sealer key) and txpool
    on its host suite."""
    L = mod(root, "ledger.ledger")
    suite = mod(root, "crypto.suite").make_suite(backend="host")
    storage = mod(root, "storage.memory").MemoryStorage()
    ledger = L.Ledger(storage, suite)
    ledger.build_genesis([L.ConsensusNode(pb.node_keys("ecdsa", 1)[0][0].pub_bytes)])
    pool = mod(root, "txpool.txpool").TxPool(suite, ledger, "chain0", "group0", 1000, 600)
    return suite, ledger, pool, storage


def txpool_answers(server: str, client: str) -> list:
    suite, ledger, pool, _ = pool_env(server)
    srv = mod(server, "services.txpool_service").TxPoolServer(pool)
    srv.start()
    remote = mod(client, "services.txpool_service").RemoteTxPool("127.0.0.1", srv.port)
    T = mod(client, "protocol")
    chost = mod(client, "crypto.suite").make_suite(backend="host")
    try:
        txs = [T.Transaction.decode(w) for w in signed(5, "svc")]
        hashes = [t.hash(chost) for t in txs]
        out = [[(r.tx_hash, int(r.status)) for r in remote.submit_batch(txs)],
               int(remote.submit(txs[0]).status), remote.pending_count()]
        sealed, sealed_hashes = remote.seal(3)
        out.append(([t.encode() for t in sealed], sealed_hashes))
        remote.unseal(sealed_hashes)
        filled = remote.fill_block(hashes[:2])
        out += [[t.encode() for t in filled], remote.fill_block([b"\x00" * 32]),
                remote.verify_proposal(T.Block(tx_hashes=hashes)),
                remote.missing_hashes([hashes[0], b"\x01" * 32])]
        remote.on_block_committed(1, hashes, [t.nonce for t in txs])
        out += [remote.pending_count(), remote.wait_for_receipt(b"\x02" * 32, 1.0)]
        return out
    finally:
        remote.close()
        srv.stop()


@pytest.mark.parametrize("server,client", [(PORT, PORT), (PORT, JAX), (JAX, PORT)])
def test_txpool_service_answers_as_the_jax_service(server, client):
    got = txpool_answers(server, client)
    assert got == txpool_answers(JAX, JAX)
    assert got[2] == 5 and len(got[3][0]) == 3 and got[5] is None and got[8] == 0 and got[9] is None


def ledger_answers(server: str, client: str) -> list:
    suite, ledger, _, _ = pool_env(server)
    srv = mod(server, "services.ledger_service").LedgerServer(ledger)
    srv.start()
    remote = mod(client, "services.ledger_service").RemoteLedger("127.0.0.1", srv.port)
    try:
        h0 = remote.header_by_number(0)
        cfg = remote.ledger_config()
        return [remote.current_number(), remote.total_tx_count(), remote.total_failed_count(),
                h0.encode(), remote.header_by_number(99), remote.transaction(b"\x00" * 32),
                remote.receipt(b"\x00" * 32), remote.system_config("tx_count_limit"),
                remote.system_config("no_such_key"),
                [(n.node_id, n.weight, n.node_type, n.enable_number)
                 for n in remote.consensus_nodes()],
                remote.block_by_number(0, False).encode(), remote.number_by_hash(b"\x03" * 32),
                remote.tx_hashes_by_number(0), remote.nonces_by_number(0),
                remote.tx_proof(b"\x00" * 32),
                (len(cfg.consensus_nodes), cfg.block_number, cfg.block_tx_count_limit,
                 cfg.leader_switch_period)]
    finally:
        remote.close()
        srv.stop()


@pytest.mark.parametrize("server,client", [(PORT, PORT), (PORT, JAX), (JAX, PORT)])
def test_ledger_service_answers_as_the_jax_service(server, client):
    got = ledger_answers(server, client)
    want = ledger_answers(JAX, JAX)
    # the genesis header carries its build time: compare it decoded, time aside
    T = mod(PORT, "protocol")
    hj, hp = T.BlockHeader.decode(want[3]), T.BlockHeader.decode(got[3])
    hj.timestamp = hp.timestamp
    assert hp.encode() == hj.encode()
    assert [x for i, x in enumerate(got) if i not in (3, 10)] == \
        [x for i, x in enumerate(want) if i not in (3, 10)]
    assert got[0] == 0 and got[8] is None and got[7][0] == "1000"


@pytest.mark.parametrize("root", ROOTS)
def test_front_service_split_dispatch_send_and_request(root):
    """A module served by a split-out service (RemoteFront) receives
    network traffic, sends through the node's gateway, broadcasts, and
    answers requests through the poll channel, on both packages."""
    suite = mod(root, "crypto.suite").make_suite(backend="host")
    gateway = mod(root, "net.gateway").FakeGateway()
    F = mod(root, "net.front")
    G = mod(root, "services.gateway_service")
    kp_a, kp_b = suite.generate_keypair(b"fsvc-a"), suite.generate_keypair(b"fsvc-b")
    front_a, front_b = F.FrontService(kp_a.pub_bytes, gateway), F.FrontService(kp_b.pub_bytes, gateway)
    server = G.FrontServer(front_a)
    server.start()
    remote = G.RemoteFront("127.0.0.1", server.port, kp_a.pub_bytes)
    got_remote, got_b = [], []
    try:
        remote.register_module(4242, lambda s, p, r: got_remote.append((s, p)))
        front_b.register_module(4242, lambda s, p, r: got_b.append((s, p)))
        remote.register_module(777, lambda s, p, respond: respond(b"echo:" + p))
        front_b.send(4242, kp_a.pub_bytes, b"to-split-service")
        assert wait_until(lambda: got_remote)
        assert got_remote[0] == (kp_b.pub_bytes, b"to-split-service")
        assert remote.send(4242, kp_b.pub_bytes, b"from-split-service")
        assert wait_until(lambda: got_b)
        assert got_b[0] == (kp_a.pub_bytes, b"from-split-service")
        remote.broadcast(4242, b"fanout")
        assert wait_until(lambda: len(got_b) >= 2) and got_b[1][1] == b"fanout"
        assert kp_b.pub_bytes in remote.peers()
        assert front_b.request(777, kp_a.pub_bytes, b"ping", timeout=10) == b"echo:ping"
    finally:
        remote.stop()
        server.stop()
        front_a.stop()
        front_b.stop()
        gateway.stop()


def scheduler_answers(server: str, client: str) -> list:
    """A package's Scheduler behind its SchedulerServer, driven by a
    RemoteScheduler of `client`: execute and commit a block of 3
    registers, a balanceOf call, and an out-of-order block."""
    from fisco_bcos_tpu.codec.wire import Reader

    suite, ledger, _, storage = pool_env(server)
    sched = mod(server, "scheduler.scheduler").Scheduler(
        storage, ledger,
        mod(server, "executor.executor").TransactionExecutor(suite), suite, txpool=None)
    srv = mod(server, "services.scheduler_service").SchedulerServer(sched)
    srv.start()
    remote = mod(client, "services.scheduler_service").RemoteScheduler("127.0.0.1", srv.port)
    T = mod(client, "protocol")
    pc = mod(client, "executor.precompiled")
    sealer = pb.node_keys("ecdsa", 1)[0][0].pub_bytes
    try:
        block = T.Block(transactions=[T.Transaction.decode(w) for w in signed(3, "ss")])
        block.header.number, block.header.timestamp = 1, 1234
        res = remote.execute_block(block, [sealer])
        committed = remote.commit_block(res.header)
        rc = remote.call(T.Transaction(to=pc.BALANCE_ADDRESS, input=pc.encode_call(
            "balanceOf", lambda w: w.blob(b"ss2"))))
        bad = T.Block(transactions=[T.Transaction.decode(signed(4, "ss")[3])])
        bad.header.number = 5
        return [res.header.encode(), [r.encode() for r in res.receipts], committed,
                ledger.current_number(), ledger.total_tx_count(), rc.status,
                Reader(rc.output).u64(), remote.execute_block(bad)]
    finally:
        remote.close()
        srv.stop()
        sched.shutdown()


@pytest.mark.parametrize("server,client", [(PORT, PORT), (PORT, JAX), (JAX, PORT)])
def test_scheduler_service_executes_and_commits_as_the_jax_service(server, client):
    got = scheduler_answers(server, client)
    assert got == scheduler_answers(JAX, JAX)
    assert got[2:] == [True, 1, 3, 0, 3, None]


def pro_stack(root: str):
    """A Pro deployment of one package in one process: a solo core Node on
    its host suite, its txpool, ledger, scheduler and storage services,
    and make_pro_rpc's JSON-RPC service over their proxies, driven by the
    package's SdkClient. -> the answers, volatile fields aside."""
    N = mod(root, "init.node")
    node = N.Node(rpc.node_config(root), keypair=pb.node_keys("ecdsa", 1)[root == PORT][0])
    node.start()
    S = {k: mod(root, f"services.{k}_service") for k in ("txpool", "ledger", "scheduler",
                                                         "storage", "rpc")}
    servers = [S["txpool"].TxPoolServer(node.txpool), S["ledger"].LedgerServer(node.ledger),
               S["scheduler"].SchedulerServer(node.scheduler),
               S["storage"].StorageServer(node.storage)]
    for s in servers:
        s.start()
    addr = [("127.0.0.1", s.port) for s in servers]
    rpc_server, facade = S["rpc"].make_pro_rpc(
        node.suite, node.suite.generate_keypair(b"pro-rpc-identity"), S["rpc"].ProNodeConfig(),
        txpool_addr=addr[0], ledger_addr=addr[1], scheduler_addr=addr[2], storage_addr=addr[3])
    rpc_server.start()
    assert facade.consensus is None and facade.eventsub is None
    cli = mod(root, "sdk.client").SdkClient(f"http://127.0.0.1:{rpc_server.port}")
    T = mod(root, "protocol")
    pc = mod(root, "executor.precompiled")
    try:
        wires = signed(3, "pro")
        first = cli.send_transaction(T.Transaction.decode(wires[0]))   # waits for its receipt
        hashes = rpc.send_wave(root, node, cli, wires[1:])
        got = cli.get_transaction("0x" + T.Transaction.decode(wires[0]).hash(node.suite).hex(),
                                  require_proof=True)
        proof = [([bytes.fromhex(s[2:]) for s in lvl["siblings"]], lvl["index"])
                 for lvl in got["txProof"]]
        ok = mod(root, "ops.merkle").verify_merkle_proof(
            T.Transaction.decode(wires[0]).hash(node.suite), proof,
            bytes.fromhex(got["txsRoot"][2:]))
        number = cli.get_block_number()
        out = [first["status"], first["output"], hashes, ok, number,
               [rpc.steady(cli.get_block_by_number(n)) for n in range(1, number + 1)],
               {k: v for k, v in got.items() if k != "importTime"},
               cli.get_sealer_list(), cli.get_system_config("tx_count_limit"),
               cli.call(pc.BALANCE_ADDRESS, pc.encode_call("balanceOf", lambda w: w.blob(b"pro2"))),
               cli.request("getTotalTransactionCount", ["group0", ""])]
        return out
    finally:
        cli.close()
        for s in servers:
            s.stop()
        rpc_server.stop()
        facade.close()
        node.stop()


def test_pro_rpc_stack_answers_as_the_jax_stack():
    got, want = pro_stack(PORT), pro_stack(JAX)
    assert got == want
    assert int(got[0]) == 0 and got[3] is True and got[4] >= 1
    assert int(got[9]["status"]) == 0
