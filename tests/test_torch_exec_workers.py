"""The port's out-of-process execution workers (scheduler/workers.py)
against in-process execution and the JAX package's pool: the same signed
blocks (frames signed on the JAX host suite, decoded by each package)
through the port's ExecPool (two workers, sharded by union-find) and the
JAX package's, receipts and changesets compared byte for byte; the sender
backfill over the pipe on the port's tensor path (device="cpu"); a worker
SIGKILLed mid-stream (degrade, fall back, heal) with generous bounded
waits; a worker's answer to PING (no CUDA context); and a port Node with
scheduler_workers=1 reaching the state of a JAX Node with the same
setting. Pools are module-scoped: each spawn imports torch (or jax)."""

import importlib
import os
import signal
import time

import pytest

import test_torch_pbft as pb  # tests/ is on sys.path under pytest

ROOTS = ("fisco_bcos_tpu", "fisco_bcos_tpu_torch")
JAX, PORT = ROOTS
TS = 1000


def mod(root: str, name: str):
    return importlib.import_module(f"{root}.{name}")


def frames(n: int, tag: str, transfers: int = 0) -> list:
    """Registers of n accounts (disjoint keys: union-find splits them),
    then `transfers` chained transfers (one component), signed on the JAX
    host suite."""
    from fisco_bcos_tpu.crypto.suite import make_suite
    from fisco_bcos_tpu.executor import precompiled as pc
    from fisco_bcos_tpu.protocol import Transaction

    suite = make_suite(backend="host")
    kp = suite.generate_keypair(b"exec-" + tag.encode())
    calls = [("register", lambda w, i=i: w.blob(b"%s%d" % (tag.encode(), i)).u64(100 + i))
             for i in range(n)]
    calls += [("transfer", lambda w, i=i: w.blob(b"%s%d" % (tag.encode(), i % n))
               .blob(b"%s%d" % (tag.encode(), (i + 1) % n)).u64(7 + i)) for i in range(transfers)]
    return [Transaction(to=pc.BALANCE_ADDRESS, input=pc.encode_call(m, f), nonce=f"{tag}-{i}",
                        block_limit=100).sign(suite, kp).encode()
            for i, (m, f) in enumerate(calls)]


class Chain:
    """One package's genesis on memory storage, its host suite and executor."""

    def __init__(self, root: str, suite=None):
        self.root = root
        self.T = mod(root, "protocol")
        self.host = mod(root, "crypto.suite").make_suite(backend="host")
        self.suite = suite or self.host
        self.storage = mod(root, "storage.memory").MemoryStorage()
        L = mod(root, "ledger.ledger")
        L.Ledger(self.storage, self.host).build_genesis([L.ConsensusNode(b"\x01" * 64)])
        self.executor = mod(root, "executor.executor").TransactionExecutor(self.host)

    def txs(self, wires, senders: bool = True):
        out = [self.T.Transaction.decode(w) for w in wires]
        if senders:
            for t in out:
                t.sender(self.host)
        return out

    def in_process(self, wires):
        state = mod(self.root, "storage.state").StateStorage(self.storage)
        rcs = self.executor.execute_block_dag(self.txs(wires), state, 1, TS)
        return encoded((rcs, state.changeset()))


def encoded(out):
    receipts, changes = out
    return [r.encode() for r in receipts], {k: (e.value, e.deleted) for k, e in changes.items()}


@pytest.fixture(scope="module")
def port_pool():
    pool = mod(PORT, "scheduler.workers").ExecPool(sm_crypto=False, workers=2)
    pool.start()
    yield pool
    pool.stop()


@pytest.fixture(scope="module")
def jax_pool():
    pool = mod(JAX, "scheduler.workers").ExecPool(sm_crypto=False, workers=2)
    pool.start()
    yield pool
    pool.stop()


def test_workers_answer_ping_without_a_cuda_context(port_pool):
    assert port_pool.ping(timeout=120.0) == [False, False]
    assert len(port_pool.pids()) == 2


@pytest.mark.parametrize("transfers", [0, 8], ids=["sharded", "one-component"])
def test_pool_equals_in_process_and_the_jax_pool(port_pool, jax_pool, transfers):
    wires = frames(8, f"w{transfers}", transfers)
    got = {}
    for root, pool in ((PORT, port_pool), (JAX, jax_pool)):
        ch = Chain(root)
        before = [w["blocks"] for w in pool.stats()["per_worker"]]
        out = pool.execute(ch.txs(wires), ch.storage, 1, TS, ch.host, ch.executor)
        assert out is not None
        got[root] = encoded(out)
        assert got[root] == ch.in_process(wires)
        after = [w["blocks"] for w in pool.stats()["per_worker"]]
        used = [a - b for a, b in zip(after, before)]
        assert used == [1, 1] if transfers == 0 else sum(used) == 1
    assert got[PORT] == got[JAX]
    assert port_pool.stats()["fallbacks"] == 0 and port_pool.pipe_reads() > 0
    j, p = jax_pool.stats(), port_pool.stats()
    assert sorted(p) == sorted(j) and sorted(p["per_worker"][0]) == sorted(j["per_worker"][0])


def test_sender_backfill_over_the_pipe_on_the_port_tensor_path(port_pool):
    """Cold txs (no cached sender) go to the workers after one batch
    recovery on the parent's device suite; the result equals in-process."""
    suite = mod(PORT, "crypto.suite").make_suite(device="cpu")
    assert suite.backend == "device"
    wires = frames(6, "cold")
    ch = Chain(PORT, suite)
    cold = ch.txs(wires, senders=False)
    calls = []
    recover = suite.recover_addresses
    suite.recover_addresses = lambda d, s: (calls.append(len(d)), recover(d, s))[1]
    out = port_pool.execute(cold, ch.storage, 1, TS, suite, ch.executor)
    assert calls == [6] and all(t._sender is not None for t in cold)
    assert out is not None and encoded(out) == Chain(PORT).in_process(wires)


def wait_until(pred, bound: float) -> bool:
    t0 = time.monotonic()
    while time.monotonic() - t0 < bound:
        if pred():
            return True
        time.sleep(0.05)
    return False


def test_sigkill_degrades_falls_back_and_heals():
    """A SIGKILLed worker fails only its block (execute -> None, counted
    as a fallback), the health plane degrades with the respawn probe, the
    probe heals the pool, and the fresh worker executes the same block
    equal to in-process. Every wait has a generous bound and no sleep
    stands in for an event."""
    health = mod(PORT, "utils.health").Health()
    pool = mod(PORT, "scheduler.workers").ExecPool(sm_crypto=False, workers=1, health=health)
    pool.start()
    try:
        assert pool.ping(timeout=120.0) == [False]
        wires = frames(4, "kill")
        ch = Chain(PORT)
        victim = pool.pids()[0]
        os.kill(victim, signal.SIGKILL)
        assert wait_until(lambda: not pool._workers[0].proc.is_alive(), 60.0)
        assert pool.execute(ch.txs(wires), ch.storage, 1, TS, ch.host, ch.executor) is None
        assert pool.stats()["fallbacks"] == 1
        assert pool.stats()["per_worker"][0]["alive"] is False
        assert health.state() != "ok"
        assert wait_until(pool.probe_respawn, 120.0)
        assert pool.pids() and pool.pids()[0] != victim
        health.clear("scheduler.exec_worker")
        assert health.sealing_allowed()
        out = pool.execute(ch.txs(wires), ch.storage, 1, TS, ch.host, ch.executor)
        assert out is not None and encoded(out) == ch.in_process(wires)
    finally:
        pool.stop()
        health.stop()


def node_run(root: str):
    """A solo node of the package with scheduler_workers=1 commits eight
    registers. -> (state root, balances, blocks its pool executed,
    getSystemStatus' execWorkers keys)."""
    N = mod(root, "init.node")
    T = mod(root, "protocol")
    pc = mod(root, "executor.precompiled")
    kw = dict(consensus="solo", crypto_backend="host", min_seal_time=0.01, profile_hz=0,
              scheduler_workers=1)
    if root == PORT:
        kw["device"] = "cpu"
    node = N.Node(N.NodeConfig(**kw), keypair=pb.node_keys("ecdsa", 1)[root == PORT][0])
    node.start()
    try:
        res = node.txpool.submit_batch([T.Transaction.decode(w) for w in frames(8, "acct")])
        assert [int(r.status) for r in res] == [0] * 8
        assert pb.wait_until(lambda: node.ledger.current_number() >= 1, 120.0)
        st = mod(root, "storage.state").StateStorage(node.storage)
        balances = [int.from_bytes(st.get(pc.T_BALANCE, b"acct%d" % i) or b"", "big")
                    for i in range(8)]
        status = node.system_status()["execWorkers"]
        return (node.ledger.header_by_number(1).state_root, balances,
                sum(w["blocks"] for w in status["per_worker"]),
                (sorted(status), sorted(status["per_worker"][0]), status["workers"]))
    finally:
        node.stop()


def test_node_with_workers_reaches_the_jax_nodes_state():
    root_p, bal_p, blocks_p, shape_p = node_run(PORT)
    root_j, bal_j, blocks_j, shape_j = node_run(JAX)
    assert blocks_p >= 1 and blocks_j >= 1   # the worker path executed
    assert root_p == root_j and bal_p == bal_j == [100 + i for i in range(8)]
    assert shape_p == shape_j
