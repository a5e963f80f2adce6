"""The pieces of the port's node planes that hold no crypto, each against
the JAX package's copy where the two must agree byte for byte: the
metrics registry's export, the stage histogram and trace spans, the
profiler's thread roles and stage markers, the task futures, the
failpoints the crypto lane fires, the lock-order checker armed, and the
structural contracts the ledger, storage and txpool satisfy.
"""

import threading

import pytest

from fisco_bcos_tpu.analysis import profiler as jprofiler
from fisco_bcos_tpu.utils import metrics as jmetrics
from fisco_bcos_tpu.utils import otrace as jotrace
from fisco_bcos_tpu.utils import trace as jtrace
from fisco_bcos_tpu_torch.analysis import lockcheck as lc
from fisco_bcos_tpu_torch.analysis import profiler as pprofiler
from fisco_bcos_tpu_torch.crypto import suite as psuite
from fisco_bcos_tpu_torch.crypto.lane import CryptoLane, LaneSuite
from fisco_bcos_tpu_torch.protocol import concepts
from fisco_bcos_tpu_torch.utils import failpoints as fp
from fisco_bcos_tpu_torch.utils import metrics as pmetrics
from fisco_bcos_tpu_torch.utils import otrace as potrace
from fisco_bcos_tpu_torch.utils import trace as ptrace
from fisco_bcos_tpu_torch.utils.log import badge, kv
from fisco_bcos_tpu_torch.utils.task import Task, TaskTimeout


def _feed(m, registry):
    registry.inc("bcos_a_total")
    registry.inc("bcos_a_total", 2, labels={"op": "verify"})
    registry.set_gauge("bcos_depth", 7, labels={"group": 'g"1'})
    for v in (0.001, 0.02, 0.3, 4.0):
        registry.observe("bcos_lat_seconds", v, labels={"op": "hash"})
    registry.observe("bcos_batch", 300, buckets=(1, 8, 64, 512))
    view = m.for_group("group0", registry)
    view.inc("bcos_b_total", 3)
    view.observe("bcos_lat_seconds", 0.5)


def test_metrics_registry_exports_what_the_jax_one_does():
    p, j = pmetrics.MetricsRegistry(), jmetrics.MetricsRegistry()
    _feed(pmetrics, p)
    _feed(jmetrics, j)
    assert p.prometheus_text() == j.prometheus_text()
    assert p.snapshot() == j.snapshot()
    assert hasattr(pmetrics, "MetricsServer")   # the scrape endpoint rides the RPC edge


def test_stage_histogram_and_trace_spans_match_jax():
    preg, jreg = pmetrics.MetricsRegistry(), jmetrics.MetricsRegistry()
    for stage, seconds in (("crypto", 0.25), ("ingest", 0.003)):
        ptrace.observe_stage(stage, seconds, registry=preg)
        jtrace.observe_stage(stage, seconds, registry=jreg)
    assert "bcos_tx_stage_seconds" in preg.prometheus_text()
    assert preg.prometheus_text() == jreg.prometheus_text()
    tid, sid = bytes(range(1, 17)), bytes(range(1, 9))
    spans = []
    for mod, tracer in ((potrace, potrace.Tracer()), (jotrace, jotrace.Tracer())):
        for sampled in (True, False):   # an unsampled context records nothing
            ctx = mod.SpanContext(tid, sid, sampled)
            with mod.ctx_scope(ctx):
                assert mod.current() is ctx
                tracer.record("txpool.admit", mod.current(), 1.0, 1.25, {"n": 3})
            assert mod.current() is None
        spans.append([(s["traceId"], s["parentSpanId"], s["name"], s["duration_ms"],
                       s["attrs"]) for s in tracer.get_trace(tid.hex())])
    assert spans[0] == spans[1] == [(tid.hex(), sid.hex(), "txpool.admit", 250.0, {"n": 3})]


def test_traced_wire_frame_records_its_ingest_span():
    """A frame submitted under a sampled context gets its queue-to-admission
    span on the process tracer, under that context."""
    from fisco_bcos_tpu_torch.protocol import types as T
    from fisco_bcos_tpu_torch.txpool import IngestLane

    class Pool:   # the one call the lane makes for wire frames
        def submit_columns(self, cols, broadcast=True):
            return ["admitted"] * len(cols)

    frame = T.Transaction(nonce="1", block_limit=5, input=b"x", signature=bytes(65)).encode()
    tid, sid = bytes(range(2, 18)), bytes(range(2, 10))
    potrace.TRACER.reset()
    lane = IngestLane(Pool(), trace_label="node0")
    try:
        with potrace.ctx_scope(potrace.SpanContext(tid, sid, True)):
            traced = lane.submit_wire_async(frame)
        plain = lane.submit_wire_async(frame)
        lane.start()
        assert traced.result(30) == plain.result(30) == "admitted"
    finally:
        lane.stop()
    spans = potrace.TRACER.get_trace(tid.hex())
    potrace.TRACER.reset()
    assert [(s["name"], s["parentSpanId"], s["attrs"]) for s in spans] == [
        ("ingest.admit", sid.hex(), {"batch": 2, "node": "node0"})]


def test_profiler_roles_and_stage_markers_match_jax():
    for name in ("tx-ingest", "crypto-lane-w_0", "sched-commit", "pbft-exec", "MainThread",
                 "worker-7"):
        assert pprofiler.classify(name) == jprofiler.classify(name)
    me = threading.get_ident()
    with pprofiler.stage("ingest.admit"):
        with pprofiler.stage("inner"):
            assert pprofiler.current_stage(me) == "inner"
        assert pprofiler.current_stage(me) == "ingest.admit"
    assert pprofiler.current_stage(me) is None
    assert badge("INGEST", "drop", n=3) == "[INGEST][drop]: n=3"
    assert kv(a=1, b="x") == "a=1,b=x"


def test_task_futures():
    t = Task()
    seen = []
    t.then(lambda done: seen.append(done.result()))
    t.resolve(5)
    assert t.done() and t.result() == 5 and seen == [5]
    bad = Task()
    bad.reject(ValueError("no"))
    with pytest.raises(ValueError):
        bad.result(1)
    assert isinstance(bad.exception(1), ValueError)
    with pytest.raises(TaskTimeout):
        Task().result(0.01)
    assert Task.gather([Task.resolved(1), Task.resolved(2)], 1) == [1, 2]


def test_crypto_lane_failpoint_rejects_one_batch_and_the_lane_survives():
    assert {"crypto.lane.dispatch", "crypto.lane.dispatcher"} <= set(fp.list_sites())
    base = psuite.make_suite(backend="host")
    lane = CryptoLane(base)
    suite = LaneSuite(lane, tag="g")
    before = fp.hits("crypto.lane.dispatch")
    try:
        with fp.armed("crypto.lane.dispatch", "raise*1"):
            with pytest.raises(fp.FailpointError):
                suite.hash_batch([b"a", b"b"])
            assert fp.list_armed() == {}   # its budget of one is spent
            assert suite.hash_batch([b"a", b"b"]) == base.hash_batch([b"a", b"b"])
        assert fp.hits("crypto.lane.dispatch") == before + 1
    finally:
        lane.stop()


@pytest.fixture()
def armed_lockcheck():
    was = lc.armed()
    lc.arm()
    lc.reset()
    try:
        yield
    finally:
        lc.reset()
        if not was:
            lc.disarm()


def test_lockcheck_armed_finds_an_order_cycle(armed_lockcheck):
    a, b = lc.make_lock("t.A"), lc.make_lock("t.B")
    with a:
        with b:
            pass
    with b:
        with a:
            pass
    rep = lc.report()
    assert len(rep["cycles"]) == 1 and set(rep["cycles"][0]["path"]) == {"t.A", "t.B"}
    with pytest.raises(AssertionError):
        lc.assert_clean()


def test_lockcheck_disarmed_hands_out_plain_primitives():
    was = lc.armed()
    lc.disarm()
    try:
        assert type(lc.make_lock("x")) is type(threading.Lock())
        assert isinstance(lc.make_condition("y"), threading.Condition)
    finally:
        if was:
            lc.arm()


def test_node_planes_satisfy_the_structural_contracts():
    from test_torch_ledger import pair   # tests/ is on sys.path under pytest

    p, _ = pair("ecdsa", pool_limit=16)
    assert isinstance(p.ledger, concepts.LedgerReader)
    assert isinstance(p.storage, concepts.KVWritable)
    assert isinstance(p.pool, concepts.TxPoolLike)
    assert isinstance(p.genesis, concepts.Serializable)
    assert isinstance(p.genesis, concepts.Hashable)
    assert p.ledger.current_number() == 0
