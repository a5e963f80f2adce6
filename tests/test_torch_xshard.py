"""The port's cross-group transfers (init/xshard.py CrossShardCoordinator
over the XShard precompile) against the JAX package's: the cases of
tests/test_xshard.py run on each package with the same signed txs, whose
c_balance, outbox, inbox and pending rows must be equal (the coordinator's
legs are signed by each node's own key, so rows, not roots, are compared);
the saga's failpoint sweep of tests/test_faults.py (a crash before the
credit, a crash before the settle, duplicate sweeps) on the port; and,
marked slow as the JAX package's is, a SIGKILL between the escrow and the
credit recovered by WAL replay in a port process.

The nodes run crypto_backend "host" (the port's on device "cpu")."""

import importlib
import json
import os
import signal
import subprocess
import sys
import threading
import time

import pytest

from fisco_bcos_tpu.crypto.suite import make_suite as jmake_suite
from fisco_bcos_tpu.executor import precompiled as jpc
from fisco_bcos_tpu.protocol import Transaction as JTransaction
from fisco_bcos_tpu_torch.executor import precompiled as pc
from fisco_bcos_tpu_torch.ops.audit import audit_cross_group
from fisco_bcos_tpu_torch.utils import failpoints as fp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TABLES = (pc.T_BALANCE, pc.T_XSHARD_OUT, pc.T_XSHARD_IN, pc.T_XSHARD_PEND)
_JSUITE = jmake_suite(backend="host")
_USER = _JSUITE.generate_keypair(b"xshard-user")


def mods(pkg):
    root = "fisco_bcos_tpu" if pkg == "jax" else "fisco_bcos_tpu_torch"
    return {k: importlib.import_module(f"{root}.{v}") for k, v in
            {"group": "init.group", "node": "init.node", "proto": "protocol",
             "memory": "storage.memory", "ns": "storage.namespace",
             "iface": "storage.interface"}.items()}


def frame(gid: str, to: bytes, method: str, build, nonce: str) -> bytes:
    """One tx signed on the JAX host suite by the test user, as wire bytes."""
    return JTransaction(to=to, input=jpc.encode_call(method, build), nonce=nonce,
                        group_id=gid, block_limit=100).sign(_JSUITE, _USER).encode()


class Groups:
    """Two groups of one package over one MemoryStorage, the coordinator
    on, alice with 100 on group0 and bob with 5 on group1."""

    def __init__(self, pkg):
        m = mods(pkg)
        self.pkg, self.m = pkg, m
        kw = {} if pkg == "jax" else {"device": "cpu"}
        self.mgr = m["group"].GroupManager(storage=m["memory"].MemoryStorage())
        self.a, self.b = (self.mgr.add_group(m["node"].NodeConfig(
            group_id=g, crypto_backend="host", min_seal_time=0.0, profile_hz=0, **kw))
            for g in ("group0", "group1"))
        self.mgr.start()
        assert self.send(self.a, pc.BALANCE_ADDRESS, "register",
                         lambda w: w.blob(b"alice").u64(100), "reg-a").status == 0
        assert self.send(self.b, pc.BALANCE_ADDRESS, "register",
                         lambda w: w.blob(b"bob").u64(5), "reg-b").status == 0

    def send(self, node, to, method, build, nonce):
        tx = self.m["proto"].Transaction.decode(
            frame(node.config.group_id, to, method, build, nonce))
        res = node.send_transaction(tx)
        rc = node.txpool.wait_for_receipt(res.tx_hash, 30)
        assert rc is not None, f"{nonce}: no receipt"
        return rc

    def transfer(self, xid, dst_group, amount, nonce, src=b"alice", dst=b"bob"):
        return self.send(self.a, pc.XSHARD_ADDRESS, "transferOut",
                         lambda w: w.blob(xid).text(dst_group).blob(src).blob(dst).u64(amount),
                         nonce)

    def rows(self) -> dict:
        return {(n.config.group_id, t): {k: n.storage.get(t, k) for k in n.storage.keys(t)}
                for n in (self.a, self.b) for t in TABLES}

    def bal(self, node, account):
        raw = node.storage.get(pc.T_BALANCE, account)
        return None if raw is None else int.from_bytes(raw, "big")

    def stop(self):
        self.mgr.stop()


def wait(cond, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return False


def on_both(scenario):
    """Run scenario(groups) on each package; the rows must be equal. ->
    the port's (groups, scenario result)."""
    out = {}
    for pkg in ("jax", "port"):
        g = Groups(pkg)
        try:
            res = scenario(g)
            out[pkg] = (g.rows(), res)
        finally:
            g.stop()
    assert out["port"] == out["jax"]
    return out["port"]


@pytest.fixture(autouse=True)
def _clean_failpoints():
    fp.disarm_all()
    yield
    fp.disarm_all()


def test_happy_path_moves_balance_exactly_once():
    def scenario(g):
        assert g.transfer(b"x1", "group1", 30, "x1").status == 0
        assert wait(lambda: g.bal(g.b, b"bob") == 35)
        assert wait(lambda: not list(g.a.storage.keys(pc.T_XSHARD_PEND)))
        assert wait(lambda: g.mgr.coordinator.stats()["completed_total"] == 1)
        return g.bal(g.a, b"alice"), g.mgr.coordinator.stats()

    rows, (alice, stats) = on_both(scenario)
    assert alice == 70 and stats == {"completed_total": 1, "aborted_total": 0, "inflight": 0}
    assert pc.decode_intent(rows[("group0", pc.T_XSHARD_OUT)][b"x1"])["status"] == pc.XS_DONE
    assert b"x1" in rows[("group1", pc.T_XSHARD_IN)]


def test_abort_unknown_group_leaves_both_balances_untouched():
    def scenario(g):
        before = g.rows()
        assert g.transfer(b"x2", "groupZ", 40, "x2").status == 0
        assert wait(lambda: g.mgr.coordinator.stats()["aborted_total"] >= 1)
        assert wait(lambda: not list(g.a.storage.keys(pc.T_XSHARD_PEND)))
        after = g.rows()
        return [after[k] == before[k] for k in sorted(after) if k[1] == pc.T_BALANCE]

    rows, same = on_both(scenario)
    assert same == [True, True]
    assert pc.decode_intent(rows[("group0", pc.T_XSHARD_OUT)][b"x2"])["status"] == \
        pc.XS_ABORTED


def test_insufficient_balance_reverts_escrow():
    def scenario(g):
        return g.transfer(b"x3", "group1", 10_000, "x3").status

    rows, status = on_both(scenario)
    assert status != 0
    assert rows[("group0", pc.T_BALANCE)][b"alice"] == (100).to_bytes(16, "big")
    assert rows[("group0", pc.T_XSHARD_OUT)] == {} == rows[("group0", pc.T_XSHARD_PEND)]


def test_duplicate_transfer_id_and_idempotent_credit():
    def scenario(g):
        out = [g.transfer(b"x4", "group1", 10, "x4").status]
        assert wait(lambda: g.bal(g.b, b"bob") == 15)
        out.append(g.transfer(b"x4", "group1", 10, "x4b").status)   # same id: rejected
        for amount, nonce in ((10, "x4-replay"), (999, "x4-evil")):
            out.append(g.send(g.b, pc.XSHARD_ADDRESS, "credit",
                              lambda w, m=amount: w.blob(b"x4").text("group0").blob(b"bob")
                              .u64(m), nonce).status)
        assert wait(lambda: not list(g.a.storage.keys(pc.T_XSHARD_PEND)))
        return out

    rows, statuses = on_both(scenario)
    assert statuses[0] == 0 and statuses[1] != 0   # no second escrow
    assert statuses[2] == 0 and statuses[3] != 0   # a replay is a no-op, other terms revert
    assert rows[("group0", pc.T_BALANCE)][b"alice"] == (90).to_bytes(16, "big")
    assert rows[("group1", pc.T_BALANCE)][b"bob"] == (15).to_bytes(16, "big")


def test_namespaced_storage_isolates_groups_and_2pc():
    def run(pkg):
        m = mods(pkg)
        base = m["memory"].MemoryStorage()
        g0, g1 = m["ns"].NamespacedStorage(base, "group0"), m["ns"].NamespacedStorage(base,
                                                                                     "group1")
        g0.set("t", b"k", b"v0")
        g1.set("t", b"k", b"v1")
        out = [g0.get("t", b"k"), g1.get("t", b"k"), g0.tables(), g1.tables()]
        g0.prepare(5, {("t", b"a"): m["iface"].Entry(b"A0")})   # the same height in both
        g1.prepare(5, {("t", b"a"): m["iface"].Entry(b"A1")})
        g0.commit(5)
        out += [g0.get("t", b"a"), g1.get("t", b"a")]
        g1.rollback(5)
        out += [g1.get("t", b"a"), sorted(base.tables())]
        return out

    got = run("port")
    assert got == run("jax")
    assert got[:7] == [b"v0", b"v1", ["t"], ["t"], b"A0", None, None]


# -- the saga's failpoint sweep (the tier-1 guard; the SIGKILL test is slow) --

@pytest.fixture()
def port_groups():
    g = Groups("port")
    yield g
    g.stop()


@pytest.mark.parametrize("site", ["xshard.credit.before_submit",
                                  "xshard.finish.before_submit"])
def test_xshard_saga_leg_crash_settles_exactly_once(port_groups, site):
    """A crash before the credit (or before the settle): the sweep retries
    off the durable pending marker and the transfer lands exactly once."""
    g = port_groups
    fp.arm(site, "raise*1")
    assert g.transfer(b"fx-" + site.encode()[:8], "group1", 30, f"fx-{site}").status == 0
    assert wait(lambda: not list(g.a.storage.keys(pc.T_XSHARD_PEND)), timeout=60)
    assert fp.hits(site) >= 1, "the leg's failpoint never fired"
    assert g.bal(g.b, b"bob") == 35 and g.bal(g.a, b"alice") == 70
    xg = audit_cross_group(g.mgr)
    assert xg["ok"] and (xg["outbox"], xg["inbox"], xg["pending"]) == (1, 1, 0), xg


def test_xshard_duplicate_sweep_wakeup_never_double_drives(port_groups):
    """Concurrent sweeps (the worker and two hammering threads) must not
    double-submit legs: the in-flight claims serialize them."""
    g = port_groups
    fp.arm("xshard.sweep", "sleep(25)")   # widen the race window
    stop = threading.Event()

    def hammer():
        while not stop.is_set():
            try:
                g.mgr.coordinator.sweep()
            except Exception:   # noqa: BLE001 — a failed sweep retries, as the worker's does
                pass

    threads = [threading.Thread(target=hammer, daemon=True) for _ in range(2)]
    for t in threads:
        t.start()
    try:
        assert g.transfer(b"dup-1", "group1", 12, "dup-1").status == 0
        assert wait(lambda: not list(g.a.storage.keys(pc.T_XSHARD_PEND)), timeout=60)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=5)
    assert not any(t.is_alive() for t in threads)
    fp.disarm("xshard.sweep")
    assert g.bal(g.b, b"bob") == 17 and g.bal(g.a, b"alice") == 88
    assert audit_cross_group(g.mgr)["ok"]


_PHASE_SCRIPT = r"""
import json, os, signal, sys, time
sys.path.insert(0, %(repo)r)
from fisco_bcos_tpu_torch.crypto.suite import make_suite
from fisco_bcos_tpu_torch.executor import precompiled as pc
from fisco_bcos_tpu_torch.init.group import GroupManager
from fisco_bcos_tpu_torch.init.node import NodeConfig
from fisco_bcos_tpu_torch.protocol import Transaction
from fisco_bcos_tpu_torch.storage.wal import WalStorage

phase, path = sys.argv[1], sys.argv[2]
store = WalStorage(path)
# the escrow phase runs WITHOUT the coordinator: the transfer stops exactly
# between the escrow commit ("prepare") and the credit ("commit")
mgr = GroupManager(storage=store, xshard=(phase == "recover"))
a, b = (mgr.add_group(NodeConfig(group_id=g, crypto_backend="host", device="cpu",
                                 min_seal_time=0.0, profile_hz=0))
        for g in ("group0", "group1"))
mgr.start()
kp = make_suite(backend="host").keypair_from_secret(7777)

def submit(node, to, data, nonce):
    tx = Transaction(to=to, input=data, nonce=nonce, group_id=node.config.group_id,
                     block_limit=node.ledger.current_number() + 100).sign(node.suite, kp)
    rc = node.txpool.wait_for_receipt(node.send_transaction(tx).tx_hash, 30)
    assert rc is not None and rc.status == 0, (nonce, rc)

if phase == "escrow":
    submit(a, pc.BALANCE_ADDRESS, pc.encode_call(
        "register", lambda w: w.blob(b"alice").u64(100)), "reg-a")
    submit(b, pc.BALANCE_ADDRESS, pc.encode_call(
        "register", lambda w: w.blob(b"bob").u64(5)), "reg-b")
    submit(a, pc.XSHARD_ADDRESS, pc.encode_call(
        "transferOut", lambda w: w.blob(b"k9").text("group1")
        .blob(b"alice").blob(b"bob").u64(30)), "x-k9")
    os.kill(os.getpid(), signal.SIGKILL)   # escrow committed, no credit: die here

# recover: WAL replay restored both groups; the coordinator's boot sweep
# must drive the pending transfer to its end
deadline = time.monotonic() + 60
while time.monotonic() < deadline and list(a.storage.keys(pc.T_XSHARD_PEND)):
    time.sleep(0.05)
out = {
    "alice": int.from_bytes(a.storage.get("c_balance", b"alice"), "big"),
    "bob": int.from_bytes(b.storage.get("c_balance", b"bob"), "big"),
    "pending": len(list(a.storage.keys(pc.T_XSHARD_PEND))),
    "outbox_status": pc.decode_intent(a.storage.get(pc.T_XSHARD_OUT, b"k9"))["status"],
    "inbox": (b.storage.get(pc.T_XSHARD_IN, b"k9") or b"").hex(),
}
mgr.stop()
store.close()
print("RESULT " + json.dumps(out))
"""


@pytest.mark.slow
def test_kill9_between_prepare_and_commit_recovers_all_or_nothing(tmp_path):
    """The port's counterpart of the JAX package's slow SIGKILL test: a
    process escrows on group0 (committed, in the WAL) and is SIGKILLed
    before the credit; a second process reopens the WAL and its
    coordinator lands the credit and settles the escrow: all, once."""
    script = _PHASE_SCRIPT % {"repo": REPO}
    env = dict(os.environ, OMP_NUM_THREADS="1")
    wal = str(tmp_path / "shared-wal")
    r = subprocess.run([sys.executable, "-c", script, "escrow", wal], env=env,
                       capture_output=True, text=True, timeout=180)
    assert r.returncode == -signal.SIGKILL, (r.returncode, r.stderr[-2000:])
    r = subprocess.run([sys.executable, "-c", script, "recover", wal], env=env,
                       capture_output=True, text=True, timeout=180)
    assert r.returncode == 0, r.stderr[-2000:]
    out = json.loads(next(ln for ln in r.stdout.splitlines()
                          if ln.startswith("RESULT "))[len("RESULT "):])
    assert out == {"alice": 70, "bob": 35, "pending": 0, "outbox_status": pc.XS_DONE,
                   "inbox": out["inbox"]}
    assert out["inbox"]
