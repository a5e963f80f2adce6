"""The port's key locks (scheduler/keylocks.py) and wave-planned DMC
executor (scheduler/dmc.py) against the JAX package's: GraphKeyLocks'
grants, re-entrancy, deadlock cycles and timeouts on both packages, each
case with a bound of its own; DmcExecutor's wave plans, receipts and
changesets equal to the JAX executor's on the same seeded blocks (each
package on its host suite), on both chains, and to the serial schedule."""

import importlib
import threading
import time

import numpy as np
import pytest

ROOTS = ("fisco_bcos_tpu", "fisco_bcos_tpu_torch")
TS = 1_700_000_000_000
SENDER = b"\xaa" * 20


def mod(root: str, name: str):
    return importlib.import_module(f"{root}.{name}")


def wait_until(pred, bound: float) -> bool:
    t0 = time.monotonic()
    while time.monotonic() - t0 < bound:
        if pred():
            return True
        time.sleep(0.005)
    return False


# ---------------------------------------------------------------------------
# GraphKeyLocks, on both packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("root", ROOTS)
def test_keylock_grant_reentrancy_and_release(root):
    kl = mod(root, "scheduler.keylocks").GraphKeyLocks()
    t0 = time.monotonic()
    kl.acquire("t1", b"A", b"k", timeout=1.0)
    kl.acquire("t1", b"A", b"k", timeout=1.0)   # re-entrant: no wait
    kl.acquire("t1", b"A", b"k2", timeout=1.0)
    assert time.monotonic() - t0 < 1.0
    assert kl.holder_of(b"A", b"k") == "t1"
    assert kl.held_by("t1") == {(b"A", b"k"), (b"A", b"k2")}
    assert not kl.try_acquire("t2", b"A", b"k")
    assert kl.try_acquire("t2", b"B", b"k")
    kl.release_all("t1")
    assert kl.holder_of(b"A", b"k") is None and kl.held_by("t1") == set()
    assert kl.try_acquire("t2", b"A", b"k")


@pytest.mark.parametrize("root", ROOTS)
def test_keylock_waiter_is_granted_on_release(root):
    """A blocked acquire is granted when the holder releases, well inside
    its own bound."""
    kl = mod(root, "scheduler.keylocks").GraphKeyLocks()
    kl.acquire("t1", b"A", b"k")
    got = []
    th = threading.Thread(target=lambda: got.append(kl.acquire("t2", b"A", b"k", timeout=10.0)))
    th.start()
    assert wait_until(lambda: kl._waiting.get("t2") == (b"A", b"k"), 5.0)
    t0 = time.monotonic()
    kl.release_all("t1")
    th.join(5.0)
    assert not th.is_alive() and got == [None]
    assert time.monotonic() - t0 < 5.0
    assert kl.holder_of(b"A", b"k") == "t2"


@pytest.mark.parametrize("root", ROOTS)
@pytest.mark.parametrize("n", [2, 3])
def test_keylock_deadlock_cycle_reverts_the_requester(root, n):
    """t_i holds lock i and waits on lock i+1; the last requester closes
    the cycle and is the victim (DeadlockError names the cycle); its
    release lets the others finish in order, within the case's bound."""
    K = mod(root, "scheduler.keylocks")
    kl = K.GraphKeyLocks()
    bound = 5.0
    for i in range(n):
        kl.acquire(f"t{i}", b"L%d" % i, b"k")
    done = []

    def waiter(i):
        kl.acquire(f"t{i}", b"L%d" % (i + 1), b"k", timeout=bound)
        done.append(i)
        kl.release_all(f"t{i}")

    threads = []
    for i in range(n - 1):
        threads.append(threading.Thread(target=waiter, args=(i,)))
        threads[-1].start()
        assert wait_until(lambda i=i: f"t{i}" in kl._waiting, bound)
    with pytest.raises(K.DeadlockError) as err:
        kl.acquire(f"t{n - 1}", b"L0", b"k", timeout=bound)
    assert err.value.tx == f"t{n - 1}" and len(err.value.cycle) == n
    kl.release_all(f"t{n - 1}")
    for th in threads:
        th.join(bound)
    assert not any(th.is_alive() for th in threads)
    assert done == list(range(n - 2, -1, -1))


@pytest.mark.parametrize("root", ROOTS)
def test_keylock_timeout(root):
    kl = mod(root, "scheduler.keylocks").GraphKeyLocks()
    kl.acquire("t1", b"A", b"k")
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        kl.acquire("t2", b"A", b"k", timeout=0.05)
    assert time.monotonic() - t0 < 2.0
    assert "t2" not in kl._waiting   # a timed-out waiter leaves no edge


# ---------------------------------------------------------------------------
# DmcExecutor against the JAX package's
# ---------------------------------------------------------------------------

def block_specs(pc, seed: int, n: int = 8):
    """(to, input, nonce) of a mixed block: registers, seeded transfers
    (some of more than the source holds), a KV table and its sets, and two
    opaque EVM calls (global barriers)."""
    from fisco_bcos_tpu.codec.wire import Writer

    rng = np.random.default_rng(seed)
    specs = [(pc.BALANCE_ADDRESS,
              pc.encode_call("register", lambda w, i=i: w.blob(b"a%d" % i).u64(100 + i)),
              f"r{i}") for i in range(n)]
    w = Writer()
    w.text("createTable").text("kv")
    specs.append((pc.KV_TABLE_ADDRESS, w.bytes(), "kv"))
    for k in range(3 * n):
        a, b = rng.choice(n, 2, replace=False)
        amt = 10 ** 6 if k % 7 == 0 else int(rng.integers(1, 30))
        specs.append((pc.BALANCE_ADDRESS,
                      pc.encode_call("transfer", lambda w, a=a, b=b, m=amt:
                                     w.blob(b"a%d" % a).blob(b"a%d" % b).u64(m)), f"t{k}"))
        if k % 5 == 0:
            w = Writer()
            w.text("set").text("kv").blob(b"key%d" % (k % 3)).blob(b"v%d" % k)
            specs.append((pc.KV_TABLE_ADDRESS, w.bytes(), f"s{k}"))
        if k == n:
            specs.append((b"\x77" * 20, b"", "evm0"))
    specs.append((b"\x78" * 20, b"", "evm1"))
    return specs


class Side:
    """One package's DmcExecutor on its host suite over fresh memory state."""

    def __init__(self, root: str, sm: bool, max_workers: int = 8):
        self.T = mod(root, "protocol")
        self.pc = mod(root, "executor.precompiled")
        self.suite = mod(root, "crypto.suite").make_suite(sm, backend="host")
        self.ex = mod(root, "executor.executor").TransactionExecutor(self.suite)
        self.dmc = mod(root, "scheduler.dmc").DmcExecutor(self.ex, self.suite, max_workers)
        self.state = mod(root, "storage.state").StateStorage(
            mod(root, "storage.memory").MemoryStorage())

    def txs(self, specs):
        out = []
        for to, data, nonce in specs:
            tx = self.T.Transaction(to=to, input=data, nonce=nonce, block_limit=500)
            tx._sender = SENDER
            out.append(tx)
        return out

    def run(self, specs, number: int = 1):
        rcs = self.dmc.execute_block(self.txs(specs), self.state, number, TS + number)
        changes = self.state.changeset()
        return ([r.encode() for r in rcs], [r.message for r in rcs],
                {k: (e.value, e.deleted) for k, e in changes.items()})


@pytest.mark.parametrize("sm", [False, True], ids=["ecdsa", "sm"])
def test_wave_plans_equal_the_jax_planner(sm):
    plans = []
    for root in ROOTS:
        side = Side(root, sm)
        plans.append(side.dmc.plan(side.txs(block_specs(side.pc, 3))))
    assert plans[1] == plans[0]
    flat = sorted(i for wave in plans[1] for i in wave)
    assert flat == list(range(len(flat)))
    assert sum(len(w) == 1 for w in plans[1]) >= 2   # the barriers stand alone


@pytest.mark.parametrize("sm", [False, True], ids=["ecdsa", "sm"])
def test_dmc_blocks_equal_the_jax_executor_and_the_serial_schedule(sm):
    outs = []
    for root in ROOTS:
        side = Side(root, sm)
        outs.append([side.run(block_specs(side.pc, seed), number)
                     for number, seed in ((1, 5), (2, 6))])
    assert outs[1] == outs[0]
    # the serial schedule on the port gives the same receipts and state
    side = Side(ROOTS[1], sm)
    serial = []
    for number, seed in ((1, 5), (2, 6)):
        rcs = [side.ex.execute_transaction(t, side.state, number, TS + number)
               for t in side.txs(block_specs(side.pc, seed))]
        serial.append(([r.encode() for r in rcs], [r.message for r in rcs],
                       {k: (e.value, e.deleted) for k, e in side.state.changeset().items()}))
    assert serial == outs[1]
    statuses = [side.T.Receipt.decode(r).status for r in outs[1][0][0]]
    assert statuses.count(0) and len(set(statuses)) > 1   # failures too


@pytest.mark.parametrize("workers", [1, 4])
def test_dmc_is_deterministic_across_runs_and_pool_sizes(workers):
    runs = [Side(ROOTS[1], False, max_workers=workers).run(
        block_specs(mod(ROOTS[1], "executor.precompiled"), 9, n=12)) for _ in range(2)]
    jax = Side(ROOTS[0], False).run(block_specs(mod(ROOTS[0], "executor.precompiled"), 9, n=12))
    assert runs[0] == runs[1] == jax
