"""The port's node network planes (net/, tool/timesync.py, utils/health.py,
utils/overload.py, utils/worker.py) against the JAX package's, exactly:
FrontService envelopes (with and without a sampled span context), requests
and responses through a FakeGateway, txsync gossip packets on both chains,
the FakeGateway's partition and per-link filter verdicts, the group and
mux gateways' tagging, the peer-median clock, the health state machine
and the overload controller on a pinned clock.
"""

import importlib
import threading
import time

import numpy as np
import pytest

import test_torch_columnar as frames  # tests/ is on sys.path under pytest

ROOTS = ("fisco_bcos_tpu", "fisco_bcos_tpu_torch")


def mod(root: str, name: str):
    return importlib.import_module(f"{root}.{name}")


def both(name: str):
    return [mod(r, name) for r in ROOTS]


def wait_until(pred, timeout=120.0):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if pred():
            return True
        time.sleep(0.005)
    return False


def test_module_ids_match():
    j, p = both("net.moduleid")
    assert {m.name: int(m) for m in j.ModuleID} == {m.name: int(m) for m in p.ModuleID}


ENVELOPES = [(1000, 0, 0, b""), (2001, 0, 0, b"gossip" * 40), (2000, 1, 7, b"\x00" * 16),
             (2000, 2, 2 ** 63 + 5, b"resp"), (3000, 1, 1, bytes(range(256)) * 3)]


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("case", range(len(ENVELOPES)))
def test_front_envelopes_are_byte_equal(case, traced):
    """FrontService._pack: the same module, kind, seq and payload give the
    same frame, a sampled span context riding it as a trailing blob."""
    module, kind, seq, payload = ENVELOPES[case]
    out = []
    for root in ROOTS:
        otrace = mod(root, "utils.otrace")
        front = mod(root, "net.front")
        ctx = otrace.SpanContext(b"\x11" * 16, b"\x22" * 8, True) if traced else None
        with otrace.ctx_scope(ctx):
            out.append(front.FrontService._pack(module, kind, seq, payload))
    assert out[0] == out[1]
    assert (len(out[1]) > 2 + 1 + 8 + 4 + len(payload)) == traced


class _Sink:
    """A front stand-in that records what a gateway delivers to it."""

    def __init__(self):
        self.got = []
        self.lock = threading.Lock()

    def on_network_message(self, src, data):
        with self.lock:
            self.got.append((src, data))


def _front_session(root: str):
    """Two fronts over one FakeGateway: a push, a request answered by the
    handler, a request to a module nobody serves (times out), a malformed
    frame, and a traced push whose handler reads the delivered context.
    -> (handler log, responses, malformed count, delivered trace ids)."""
    net = mod(root, "net")
    otrace = mod(root, "utils.otrace")
    gw = net.FakeGateway()
    a, b = b"\x0a" * 64, b"\x0b" * 64
    fa, fb = net.FrontService(a, gw), net.FrontService(b, gw)
    log, seen_ctx = [], []
    done = threading.Event()

    def handler(src, payload, respond):
        log.append((src, payload, respond is not None))
        ctx = otrace.current()
        seen_ctx.append(ctx.trace_id if ctx is not None else None)
        if respond is not None:
            respond(b"echo:" + payload)
        if payload == b"last":
            done.set()

    fb.register_module(net.ModuleID.BlockSync, handler)
    try:
        fa.send(net.ModuleID.BlockSync, b, b"push-1")
        resp = fa.request(net.ModuleID.BlockSync, b, b"req-1", timeout=60)
        missing = fa.request(net.ModuleID.AMOP, b, b"nobody", timeout=0.2)
        gw.send(a, b, b"\x07")  # shorter than any envelope
        with otrace.ctx_scope(otrace.SpanContext(b"\x33" * 16, b"\x44" * 8, True)):
            fa.send(net.ModuleID.BlockSync, b, b"traced")
        fa.send(net.ModuleID.BlockSync, b, b"last")
        assert done.wait(60)
        return log, (resp, missing), fb._malformed, seen_ctx, fa.peers(), fb.peers()
    finally:
        fa.stop()
        fb.stop()
        gw.stop()


def test_front_requests_and_pushes_through_a_fake_gateway_match():
    j, p = (_front_session(r) for r in ROOTS)
    assert j == p
    log, (resp, missing), malformed, seen, _, _ = p
    assert resp == b"echo:req-1" and missing is None and malformed == 1
    assert seen == [None, None, b"\x33" * 16, None]


@pytest.mark.parametrize("kind", frames.CHAINS)
def test_txsync_packets_are_byte_equal(kind):
    """_pack_txs on the same decoded frames: (hash, encoding) pairs, the
    same bytes in both packages; _unpack_txs and a fetch request read
    them back alike."""
    port, jax = frames.suites(kind)
    wires = [w for i, w in enumerate(frames.wire_frames(kind)[0]) if i not in frames.SPECIAL][:12]
    packets, unpacked = [], []
    for root, suite in zip(ROOTS, (jax, port)):
        T = mod(root, "protocol")
        txsync = mod(root, "net.txsync")
        txs = [T.Transaction.decode(w) for w in wires]
        pkt = txsync._pack_txs(txs, suite)
        packets.append(pkt)
        unpacked.append(txsync._unpack_txs(pkt))
    assert packets[0] == packets[1]
    assert unpacked[0] == unpacked[1]
    assert [raw for _, raw in unpacked[1]] == wires


def _gateway_session(root: str):
    """One FakeGateway, three sinks: plain sends, a partitioned node (both
    directions and its peer lists), a filter that drops one link, delays
    one frame, duplicates another, and a broadcast. -> per-destination
    deliveries in order, send verdicts, peer lists, drops."""
    gwmod = mod(root, "net.gateway")
    gw = gwmod.FakeGateway()
    ids = [bytes([k]) * 8 for k in range(3)]
    sinks = [_Sink() for _ in ids]
    for i, s in zip(ids, sinks):
        gw.register_front(i, s)
    a, b, c = ids
    verdicts = [gw.send(a, b, b"\x07\xd1one"), gw.send(b, c, b"two")]
    gw.partition(c)
    verdicts += [gw.send(a, c, b"to-isolated"), gw.send(c, a, b"from-isolated")]
    peers = [gw.peers(a), gw.peers(c)]
    gw.partition(c, isolated=False)
    verdicts.append(gw.send(a, c, b"healed"))

    def flt(src, dst, data):
        if data == b"drop":
            return False
        if data == b"late":
            return 0.05
        if data == b"twice":
            return 2
        return True

    gw.set_filter(flt)
    verdicts += [gw.send(a, b, b"drop"), gw.send(a, b, b"late"), gw.send(a, b, b"twice")]
    gw.set_filter(None)
    gw.broadcast(a, b"all")
    verdicts.append(gw.send(a, b"\xff" * 8, b"nobody"))
    want = [0, 5, 3]  # frames each sink ends up with
    assert wait_until(lambda: [len(s.got) for s in sinks] == want)
    gw.stop()
    module = gwmod.FakeGateway.module_of(b"\x07\xd1one")
    return [sorted(s.got) for s in sinks], verdicts, peers, gw.dropped, module


def test_fake_gateway_partition_and_filters_behave_the_same():
    j, p = (_gateway_session(r) for r in ROOTS)
    assert j == p
    got, verdicts, peers, dropped, module = p
    assert verdicts == [True, True, False, False, True, False, True, True, False]
    assert module == 2001 and dropped == 0
    assert (b"\x00" * 8, b"twice") in got[1] and got[1].count((b"\x00" * 8, b"twice")) == 2


def test_group_and_mux_gateways_tag_frames_the_same():
    """GroupGateway namespaces node ids on a shared transport; MuxGateway
    tags frames with their group and demultiplexes them."""
    out = []
    for root in ROOTS:
        gwmod = mod(root, "net.gateway")
        shared = gwmod.FakeGateway()
        g1, g2 = gwmod.GroupGateway(shared, "g1"), gwmod.GroupGateway(shared, "g2")
        s1, s2, s3 = _Sink(), _Sink(), _Sink()
        g1.register_front(b"n1", s1)
        g1.register_front(b"n2", s2)
        g2.register_front(b"n1", s3)
        g1.broadcast(b"n1", b"hello")
        peers = (g1.peers(b"n1"), g2.peers(b"n1"))
        assert wait_until(lambda: len(s2.got) == 1)
        shared.stop()
        mux = gwmod.MuxGateway(_Recorder())
        views = {g: mux.view(g) for g in ("ga", "gb")}
        sa, sb = _Sink(), _Sink()
        views["ga"].register_front(b"me", sa)
        views["gb"].register_front(b"me", sb)
        views["ga"].send(b"me", b"you", b"payload")
        tagged = mux.shared.sent[-1][2]
        mux.on_network_message(b"you", tagged)
        mux.on_network_message(b"you", b"untagged")
        out.append((s1.got, s2.got, s3.got, peers, tagged, sa.got, sb.got,
                    mux.shared.fronts))
    assert out[0] == out[1]
    assert out[1][4] == b"\xf5\x02gapayload" and out[1][5] == [(b"you", b"payload")]


class _Recorder:
    """A transport stand-in: records registrations and sends."""

    def __init__(self):
        self.sent, self.fronts = [], []

    def register_front(self, node_id, front):
        self.fronts.append(node_id)

    def unregister_front(self, node_id):
        self.fronts.remove(node_id)

    def send(self, src, dst, data):
        self.sent.append((src, dst, data))
        return True

    def peers(self, src):
        return [b"you"]


def test_timesync_median_matches():
    """Peer clocks on a pinned local time: offsets below the jitter floor
    are kept, the median and aligned time agree, forgetting a peer
    recomputes it."""
    rng = np.random.default_rng(11)
    offsets = [int(x) for x in rng.integers(-40 * 60_000, 40 * 60_000, 9)]
    out = []
    for root in ROOTS:
        ts = mod(root, "tool.timesync")
        m = ts.NodeTimeMaintenance()
        trail = []
        for k, off in enumerate(offsets):
            m.update_peer_time(bytes([k % 5]) * 4, 1_700_000_000_000 + off,
                               local_time_ms=1_700_000_000_000)
            trail.append(m.median_offset_ms())
        m.forget_peer(b"\x02" * 4)
        trail.append(m.median_offset_ms())
        out.append((trail, ts.MIN_TIME_OFFSET_MS, ts.MAX_TIME_OFFSET_MS))
    assert out[0] == out[1]


def test_health_state_machine_matches():
    """Reports and clears move ok -> busy -> degraded -> failed and back in
    the same steps, with the same write-shed and sealing verdicts."""
    steps = [("busy", "overload"), ("degraded", "storage"), ("failed", "exec"),
             ("clear", "exec"), ("clear", "storage"), ("degraded", "storage"),
             ("busy", "storage"), ("clear", "overload"), ("clear", "storage")]
    out = []
    for root in ROOTS:
        h = mod(root, "utils.health").Health()
        changes = []
        h.on_change.append(lambda old, new: changes.append((old, new)))
        trail = []
        for verb, comp in steps:
            getattr(h, verb)(comp) if verb == "clear" else getattr(h, verb)(comp, "why")
            trail.append((h.state(), h.writes_shed(), h.sealing_allowed(),
                          sorted(h.snapshot()["faults"])))
        h.stop()
        out.append((trail, changes))
    assert out[0] == out[1]


def test_overload_controller_matches():
    """The EWMA score, the hysteresis hold and the busy/ok edges on a
    pinned clock and a scripted signal, with the health plane's busy
    step and the gossip gate following."""
    levels = [0.2] + [1.0] * 10 + [0.7, 0.4] + [0.0] * 12
    out = []
    for root in ROOTS:
        now = [0.0]
        level = [0.0]
        health = mod(root, "utils.health").Health()
        ctl = mod(root, "utils.overload").OverloadController(
            health=health, hold_s=0.25, clock=lambda: now[0])
        ctl.add_signal("txpool", lambda: level[0])
        trail = []
        for v in levels:
            level[0] = v
            now[0] += 0.1
            score = ctl.sample_once()
            trail.append((round(score, 9), ctl.busy(), ctl.accepting_remote_txs(),
                          ctl.write_rate_factor(), health.state()))
        health.stop()
        out.append((trail, ctl.stats()))
    assert out[0] == out[1]
    assert any(busy for _, busy, *_ in out[1][0]) and not out[1][0][-1][1]


def test_workers_loop_until_stopped_and_take_the_returned_wait():
    """A Worker with no idle wait runs on wakeups only and honours the
    wait its iteration returns."""
    out = []
    for root in ROOTS:
        W = mod(root, "utils.worker").Worker
        runs = []

        class Counting(W):
            def execute_worker(self):
                runs.append(time.monotonic())
                return 0.01 if len(runs) < 5 else None

        w = Counting("count", idle_wait=None)
        w.start()
        w.wakeup()
        assert wait_until(lambda: len(runs) >= 5)
        time.sleep(0.1)
        n = len(runs)
        w.stop()
        out.append((n, w.stopping(), w._thread))
    assert out[0] == out[1] == [(5, True, None)][0]
