"""The port's crypto lane (crypto/lane.py): several groups' concurrent
verify, recover, hash and Poseidon requests merge into one call of the
port suite on its CPU tensor path, and each group gets exactly what a
direct call gives, on the port's host path and on the JAX package's host
suite. Then the lane's contract on the port's host path: a failed
dispatch rejects its cohort and the lane survives, stop rejects what is
queued, LaneSuite delegates and lets one-item calls bypass the lane, and
a large host batch fans out with results in order.
"""

import threading
import time

import numpy as np
import pytest
import torch

import test_torch_columnar as frames  # tests/ is on sys.path under pytest
from fisco_bcos_tpu_torch.crypto import suite as psuite
from fisco_bcos_tpu_torch.crypto.lane import CryptoLane, LaneSuite

NGROUPS, LANES = 3, 8


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class CountingSuite:
    """Delegates to a suite, counting batch calls a kind; the first call
    after `gate` is set parks on it, and `fail_next` raises once."""

    def __init__(self, suite):
        self._suite = suite
        self.calls = {"verify": [], "recover": [], "hash": [], "poseidon": []}
        self.gate = None
        self.entered = threading.Event()
        self.fail_next = None

    def __getattr__(self, name):
        return getattr(self._suite, name)

    def _enter(self, op, n):
        self.calls[op].append(n)
        if self.fail_next is not None:
            exc, self.fail_next = self.fail_next, None
            raise exc
        if self.gate is not None:
            gate, self.gate = self.gate, None
            self.entered.set()
            assert gate.wait(60)

    def verify_batch(self, digests, sigs, pubs):
        self._enter("verify", len(digests))
        return self._suite.verify_batch(digests, sigs, pubs)

    def recover_batch(self, digests, sigs):
        self._enter("recover", len(digests))
        return self._suite.recover_batch(digests, sigs)

    def hash_batch(self, msgs):
        self._enter("hash", len(msgs))
        return self._suite.hash_batch(msgs)

    def poseidon_batch(self, lefts, rights):
        self._enter("poseidon", len(lefts))
        return self._suite.poseidon_batch(lefts, rights)


def merged(counting, lane, thunks):
    """Run thunks (one a group) concurrently while the dispatcher parks in
    a gated probe call, so that the next drain takes every group's request
    at once. -> their results."""
    counting.gate = threading.Event()
    gate = counting.gate
    counting.entered.clear()
    probe = lane.submit("hash", ([b"probe0", b"probe1"],), 2, "probe")
    assert counting.entered.wait(30), "the dispatcher never reached the suite"
    results = [None] * len(thunks)

    def run(i, fn):
        results[i] = fn()

    threads = [threading.Thread(target=run, args=(i, fn), daemon=True)
               for i, fn in enumerate(thunks)]
    for th in threads:
        th.start()
    t0 = time.monotonic()
    while sum(len(q) for q in lane._q.values()) < len(thunks):
        assert time.monotonic() - t0 < 30, "requests never queued"
        time.sleep(0.002)
    gate.set()
    for th in threads:
        th.join(120)
    assert not any(th.is_alive() for th in threads)
    probe.result(30)
    return results


def group_inputs(kind: str):
    """Per group: LANES digests signed on the JAX host suite by the
    sender keys, lane g of group g corrupted (r = 0)."""
    _, jax = frames.suites(kind)
    jkeys, _ = frames.sender_keys(kind)
    rng = np.random.default_rng(31)
    out = []
    for g in range(NGROUPS):
        ds = [rng.bytes(32) for _ in range(LANES)]
        sg = [jax.sign(jkeys[i % 4], d) for i, d in enumerate(ds)]
        sg[g] = bytes(32) + sg[g][32:]
        out.append((ds, sg, [jkeys[i % 4].pub_bytes for i in range(LANES)]))
    return out


@pytest.mark.parametrize("kind", frames.CHAINS)
def test_groups_merge_into_one_suite_call_and_match_direct_calls(kind):
    port, jax = frames.suites(kind)
    host = psuite.make_suite(kind == "sm", backend="host")
    counting = CountingSuite(port)
    lane = CryptoLane(counting)
    groups = [LaneSuite(lane, tag=f"group{g}") for g in range(NGROUPS)]
    inputs = group_inputs(kind)
    try:
        got = merged(counting, lane, [lambda s=s, a=a: s.verify_batch(*a)
                                      for s, a in zip(groups, inputs)])
        assert counting.calls["verify"] == [NGROUPS * LANES]
        for (ds, sg, pb), ok in zip(inputs, got):
            assert list(ok) == list(host.verify_batch(ds, sg, pb))
            assert list(ok) == list(jax.verify_batch(ds, sg, pb))
        assert [int(np.asarray(ok).sum()) for ok in got] == [LANES - 1] * NGROUPS

        msgs = [[b"group%d-msg%d" % (g, i) * (i + 1) for i in range(5)]
                for g in range(NGROUPS)]
        got = merged(counting, lane, [lambda s=s, m=m: s.hash_batch(m)
                                      for s, m in zip(groups, msgs)])
        assert counting.calls["hash"][-1] == NGROUPS * 5
        assert got == [jax.hash_batch(m) for m in msgs] == [host.hash_batch(m) for m in msgs]

        if kind == "ecdsa":   # SM recovery is a verify, as above
            got = merged(counting, lane, [lambda s=s, a=a: s.recover_addresses(*a[:2])
                                          for s, a in zip(groups, inputs)])
            assert counting.calls["recover"] == [NGROUPS * LANES]
            for (ds, sg, _), (addrs, ok) in zip(inputs, got):
                want, wok = jax.recover_addresses(ds, sg)
                assert addrs == want == host.recover_addresses(ds, sg)[0]
                assert list(ok) == list(wok)
            pairs = [([bytes([g, i]) * 16 for i in range(4)],
                      [bytes([i, g]) * 16 for i in range(4)]) for g in range(NGROUPS)]
            got = merged(counting, lane, [lambda s=s, p=p: s.poseidon_batch(*p)
                                          for s, p in zip(groups, pairs)])
            assert counting.calls["poseidon"] == [NGROUPS * 4]
            assert got == [jax.poseidon_batch(*p) for p in pairs]
        stats = lane.stats()
        assert stats["merged_calls"] >= 2
        sizes = [LANES, 5] + ([LANES, 4] if kind == "ecdsa" else [])
        assert stats["per_tag_mean_batch"]["group0"] == sum(sizes) / len(sizes)
    finally:
        lane.stop()
    assert lane._thread is None


@pytest.mark.parametrize("kind", frames.CHAINS)
def test_lane_suite_addresses_hash_the_keys_in_one_device_call(kind, monkeypatch):
    """On the port's device path LaneSuite.recover_addresses hashes the
    valid keys by one call of the suite's varlen hash (its plain version
    on these CPU tensors, the kernel on the card), not key by key on the
    host, and gives the JAX suite's addresses."""
    from fisco_bcos_tpu_torch.ops import keccak, sm3

    port, jax = frames.suites(kind)
    mod, name = (keccak, "keccak256_varlen") if kind == "ecdsa" else (sm3, "sm3_varlen")
    real, calls = getattr(mod, name), []

    def counted(blocks, nvalid):
        calls.append(blocks.shape[0])
        return real(blocks, nvalid)

    monkeypatch.setattr(mod, name, counted)
    ds, sg, _ = group_inputs(kind)[1]   # lane 1 corrupted
    lane = CryptoLane(port)
    try:
        addrs, ok = LaneSuite(lane, tag="group0").recover_addresses(ds, sg)
    finally:
        lane.stop()
    want, wok = jax.recover_addresses(ds, sg)
    assert addrs == want and list(ok) == list(wok)
    assert addrs[1] is None and sum(a is not None for a in addrs) == LANES - 1
    assert calls == [LANES - 1]


@pytest.fixture()
def host_lane():
    counting = CountingSuite(psuite.make_suite(backend="host"))
    lane = CryptoLane(counting, host_workers=1)
    yield counting, lane, LaneSuite(lane, tag="group0"), LaneSuite(lane, tag="group1")
    lane.stop()


def _signed(suite, kp, n, valid=True):
    ds = [suite.hash(b"lane-msg-%d" % i) for i in range(n)]
    sg = [suite.sign(kp, d) for d in ds]
    if not valid:
        sg = [b"\xff" * 32 + g[32:] for g in sg]
    return ds, sg


def test_failed_dispatch_rejects_its_cohort_and_the_lane_survives(host_lane):
    counting, lane, a, b = host_lane
    kp = counting.generate_keypair(b"lane-err")
    d, s = _signed(counting, kp, 3)
    counting.fail_next = RuntimeError("device fell over")
    with pytest.raises(RuntimeError, match="device fell over"):
        a.recover_batch(d, s)
    pubs, ok = b.recover_batch(d, s)
    assert bool(np.all(ok)) and pubs == counting._suite.recover_batch(d, s)[0]
    bad_d, bad_s = _signed(counting, kp, 2, valid=False)
    (pa, oka), (pb, okb) = merged(counting, lane, [lambda: a.recover_batch(bad_d, bad_s),
                                                   lambda: b.recover_batch(d, s)])
    assert not np.any(oka) and all(p is None for p in pa)
    assert np.all(okb) and pb == pubs


def test_lane_suite_delegates_and_bypasses_one_item_calls(host_lane):
    counting, lane, a, _ = host_lane
    kp = a.generate_keypair(b"lane-del")
    d = a.hash(b"single")
    sig = a.sign(kp, d)
    before = lane.stats()["requests_total"]
    assert a.verify(kp.pub_bytes, d, sig)
    assert a.recover(d, sig) == kp.pub_bytes
    assert lane.stats()["requests_total"] == before
    ds, ss = _signed(counting, kp, 3)
    addrs, ok = a.recover_addresses(ds, ss)
    assert bool(np.all(ok)) and addrs == [kp.address] * 3
    assert lane.stats()["requests_total"] == before + 1
    assert "LaneSuite(group0" in repr(a)


def test_host_fan_out_keeps_results_in_order():
    counting = CountingSuite(psuite.make_suite(backend="host"))
    lane = CryptoLane(counting, host_workers=2)
    suite = LaneSuite(lane, tag="g")
    try:
        kp = counting.generate_keypair(b"fan-out")
        d, s = _signed(counting, kp, 8)
        db, sb = _signed(counting, kp, 4, valid=False)
        pubs, ok = suite.recover_batch(d[:4] + db + d[4:], s[:4] + sb + s[4:])
        assert counting.calls["recover"] == [6, 6]
        assert list(ok) == [True] * 4 + [False] * 4 + [True] * 4
        assert pubs == counting._suite.recover_batch(d[:4] + db + d[4:],
                                                     s[:4] + sb + s[4:])[0]
    finally:
        lane.stop()


def test_stop_rejects_queued_and_refuses_new():
    counting = CountingSuite(psuite.make_suite(backend="host"))
    lane = CryptoLane(counting)
    counting.gate = threading.Event()
    gate = counting.gate
    parked = lane.submit("hash", ([b"a", b"b"],), 2, "t")
    assert counting.entered.wait(10)
    queued = lane.submit("hash", ([b"c", b"d"],), 2, "t")
    stopper = threading.Thread(target=lane.stop, daemon=True)
    stopper.start()
    gate.set()
    stopper.join(15)
    assert not stopper.is_alive()
    assert parked.result(5) == counting._suite.hash_batch([b"a", b"b"])
    try:
        assert queued.result(5) == counting._suite.hash_batch([b"c", b"d"])
    except RuntimeError:
        pass   # rejected by stop rather than drained: either, never a hang
    with pytest.raises(RuntimeError):
        lane.submit("hash", ([b"e", b"f"],), 2, "t")
