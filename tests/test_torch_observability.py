"""The port's observability planes (utils/otrace.py, utils/metrics.py's
MetricsServer, rpc/ops.py, analysis/profiler.py) against the JAX
package's on the same inputs: W3C `traceparent` parsing and formatting,
Tracer spans, sampling and the slow ring, the Prometheus endpoint's text
and a live node's `bcos_rpc_*` / `bcos_rpc_cache_*` / `bcos_zk_*` series,
the ops routes' replies, the sampling profiler's folded-stack shape, its
bounded ring and flamegraph, and the trace-to-burst joins
(`attach_burst`, `flag_profiled`). Span and trace ids come from a seeded
counter in both packages, so spans compare whole except their times.
"""

import http.client
import itertools
import json
import threading
import time

import pytest

import test_torch_pbft as pb  # tests/ is on sys.path under pytest
import test_torch_rpc as rpc

JAX, PORT = rpc.JAX, "fisco_bcos_tpu_torch"
ROOTS = (JAX, PORT)


def otrace(root: str):
    return pb.mod(root, "utils.otrace")


def profiler(root: str):
    return pb.mod(root, "analysis.profiler")


TRACEPARENTS = [
    "00-000102030405060708090a0b0c0d0e0f-0001020304050607-01",
    "00-000102030405060708090a0b0c0d0e0f-0001020304050607-00",
    "ff-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-03-extra",
    "  00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01  ",
    "00-" + "0" * 32 + "-0001020304050607-01",
    "00-000102030405060708090a0b0c0d0e0f-" + "0" * 16 + "-01",
    "00-zz0102030405060708090a0b0c0d0e0f-0001020304050607-01",
    "00-abc-def-01", "garbage", "", None, 42,
]


@pytest.mark.parametrize("i", range(len(TRACEPARENTS)))
def test_traceparent_parse_and_format_match_jax(i):
    value = TRACEPARENTS[i]
    got = []
    for root in ROOTS:
        ctx = otrace(root).parse_traceparent(value)
        got.append(None if ctx is None else
                   (ctx.trace_id, ctx.span_id, ctx.sampled, ctx.traceparent(), ctx.pack(),
                    otrace(root).unpack_ctx(ctx.pack()).traceparent()))
    assert got[0] == got[1]
    assert (got[1] is None) == (i >= 4)


@pytest.fixture()
def seeded_ids(monkeypatch):
    """Span and trace ids from one counter per package, restarted per use."""
    def reset():
        for root in ROOTS:
            c = itertools.count(1)
            monkeypatch.setattr(otrace(root), "_rand_id",
                                lambda n, c=c: next(c).to_bytes(n, "big"))
    return reset


def _steady_spans(spans):
    return [{k: v for k, v in s.items() if k not in ("start_ms", "duration_ms")}
            for s in spans]


def _tracer_run(root: str):
    ot = otrace(root)
    tr = ot.Tracer(sample_rate=1.0, ring_size=16, slow_ms=30.0, slow_ring=16)
    roots = []
    for i in range(3):
        r = tr.new_root()
        roots.append(r)
        with tr.span("outer", parent=r, attrs={"i": i}) as sp:
            with tr.span("inner"):
                assert ot.current() is not None
            sp.set_attr("extra", True)
    with tr.span("slow.one", parent=roots[0]):
        time.sleep(0.05)
    tr.record("recorded", roots[1], time.monotonic() - 0.001, attrs={"n": 2})
    tr.observe_slow("stage.commit", 0.5, attrs={"number": 9})
    first = _steady_spans(tr.get_trace(roots[0].trace_id.hex()))
    second = _steady_spans(tr.get_trace(roots[1].trace_id.hex()))
    for _ in range(20):   # past the ring: the oldest spans drop
        tr.record("x", tr.new_root(), time.monotonic())
    quiet = ot.Tracer(sample_rate=0.0, ring_size=16, slow_ms=10.0)
    r = quiet.new_root()
    with quiet.span("fast", parent=r):
        pass
    with quiet.span("slow", parent=r):
        time.sleep(0.03)
    idle = ot.Tracer(sample_rate=0.0, slow_ms=0.0)
    return dict(
        first=first, second=second,
        first_after=[s["name"] for s in tr.get_trace(roots[0].trace_id.hex())],
        listed=[(t["traceId"], t["spans"], t["names"]) for t in tr.list_traces(limit=5)],
        slow=[(t["traceId"], t["names"]) for t in tr.list_traces(slow_only=True)],
        stats=tr.stats(),
        quiet=(_steady_spans(quiet.get_trace(r.trace_id.hex())), quiet.stats()),
        idle=(idle.idle(), idle.span("anything") is ot._NULL_SPAN),
    )


def test_tracer_spans_sampling_and_slow_ring_match_jax(seeded_ids):
    got = []
    for root in ROOTS:
        seeded_ids()
        got.append(_tracer_run(root))
    assert got[1] == got[0]
    out = got[1]
    assert [s["name"] for s in out["first"]] == ["outer", "inner", "slow.one"]
    assert out["first"][1]["parentSpanId"] == out["first"][0]["spanId"]
    assert out["first"][2]["slow"] is True
    assert out["stats"]["ring_spans"] == 16 and out["stats"]["dropped_total"] > 0
    assert out["stats"]["slow_spans"] == 2 and out["first_after"] == ["slow.one"]
    assert [s["name"] for s in out["quiet"][0]] == ["slow"] and out["idle"] == (True, True)


# -- the Prometheus endpoint and the ops routes ---------------------------------

def _get(port: int, path: str, method: str = "GET"):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request(method, path, body=b"{}" if method == "POST" else None)
        r = conn.getresponse()
        return r.status, r.getheader("Content-Type"), r.read()
    finally:
        conn.close()


def _ops_replies(root: str):
    metrics = pb.mod(root, "utils.metrics")
    reg = metrics.MetricsRegistry()
    reg.inc("up")
    reg.inc("bcos_rpc_requests_total", 3, labels={"method": "getBlockNumber"})
    reg.observe("bcos_zk_verify_batch_size", 12, buckets=(1, 8, 64))
    tr = otrace(root).Tracer(sample_rate=1.0, ring_size=64)
    r = tr.new_root()
    tr.record("hello", r, time.monotonic() - 0.01, attrs={"k": 1})
    srv = metrics.MetricsServer(reg, port=0, tracer=tr,
                                status_fn=lambda: {"blockNumber": 7},
                                health_fn=lambda: {"state": "degraded", "faults": {"x": 1}})
    srv.start()
    try:
        out = {}
        for path in ("/metrics", "/", "/status", "/healthz", "/nope",
                     f"/trace?id={r.trace_id.hex()}", "/traces?limit=10",
                     "/profile?id=" + "ab" * 16):
            code, ctype, body = _get(srv.port, path)
            if path.startswith("/trace"):
                doc = json.loads(body)
                for s in doc.get("spans", []):
                    s.pop("start_ms"), s.pop("duration_ms")
                for t in doc.get("traces", []):
                    t.pop("start_ms"), t.pop("duration_ms")
                body = doc
            out[path] = (code, ctype, body)
        out["post"] = _get(srv.port, "/metrics", "POST")[0]
        return out
    finally:
        srv.stop()


def test_metrics_server_and_ops_routes_match_jax(seeded_ids):
    got = []
    for root in ROOTS:
        seeded_ids()
        got.append(_ops_replies(root))
    assert got[1] == got[0]
    out = got[1]
    assert out["/metrics"][0] == 200 and "version=0.0.4" in out["/metrics"][1]
    assert b'bcos_rpc_requests_total{method="getBlockNumber"} 3.0' in out["/metrics"][2]
    assert out["/metrics"] == out["/"]
    assert out["/healthz"][0] == 503 and out["/nope"][0] == 404 and out["post"] == 405
    assert [s["name"] for s in out[next(k for k in out if k.startswith("/trace?"))][2][
        "spans"]] == ["hello"]


# -- the profiler ----------------------------------------------------------------

def _known_shape_leaf(stop):
    x = 1
    while not stop.is_set():
        for _ in range(20000):
            x = (x * 31 + 7) & 0xFFFFFFFF


def _known_shape_mid(stop):
    _known_shape_leaf(stop)


def _known_shape_root(stop):
    _known_shape_mid(stop)


def _leaf_line(root: str) -> str:
    prof = profiler(root)
    p = prof.SamplingProfiler()
    stop = threading.Event()
    t = threading.Thread(target=_known_shape_root, args=(stop,), name="tx-ingest-probe",
                         daemon=True)
    t.start()
    try:
        with prof.stage("unit.stage"):
            p.configure(hz=150, ring=1024)
            time.sleep(0.6)
            p.configure(hz=0)
    finally:
        stop.set()
        t.join(5)
    lines = [ln.rsplit(" ", 1) for ln in p.folded().splitlines() if "_known_shape_leaf" in ln]
    assert lines, p.folded()[:800]
    return max(lines, key=lambda kv: int(kv[1]))[0]


def test_profiler_folded_stack_shape_matches_jax():
    want, got = _leaf_line(JAX), _leaf_line(PORT)
    assert got == want
    frames = got.split(";")
    assert frames[0] == "ingest"
    names = [f.rsplit(":", 1)[-1] for f in frames]
    assert names.index("_known_shape_root") < names.index("_known_shape_mid") < \
        names.index("_known_shape_leaf")


def _ring_and_flame(root: str):
    prof = profiler(root)
    fold = prof._Folded(cap=64)
    for i in range(300):
        fold.add(f"main;mod.py:f{i % 100}", 1 + i % 3)
    text = prof._folded_text(fold.counts, fold.overflow)
    return (fold.samples, fold.overflow, len(fold.counts), text,
            prof.flame_html(text, title="unit"),
            [prof.classify(n) for n in ("tx-ingest", "rpc-worker-3", "ops-http", "ws-accept",
                                        "profile-sampler", "sched-commit", "MainThread")])


def test_profiler_ring_flamegraph_and_roles_match_jax():
    want, got = _ring_and_flame(JAX), _ring_and_flame(PORT)
    assert got == want
    assert got[1] > 0 and "(overflow)" in got[3] and len(got[3].splitlines()) <= 65


def _bursts(root: str):
    prof = profiler(root)
    p = prof.PROFILER
    tid = "12" * 16
    rec = {"traceId": tid, "reason": "slow.unit", "samples": 3, "folded": "main;a.py:f 3\n"}
    with p._lock:
        p._bursts[tid] = rec
    try:
        docs = [prof.attach_burst({"traceId": tid, "spans": []}, tid),
                prof.attach_burst({"traceId": "34" * 16, "spans": []}, "34" * 16)]
        flagged = prof.flag_profiled([{"traceId": tid}, {"traceId": "34" * 16}])
        ot = otrace(root)
        tracer = ot.Tracer(sample_rate=1.0)
        for t in (tid, "34" * 16):
            tracer.record("unit", ot.SpanContext(bytes.fromhex(t), b"\x01" * 8, True),
                          time.monotonic() - 0.001)
        ops = pb.mod(root, "rpc.ops").OpsRoutes(registry=pb.mod(
            root, "utils.metrics").MetricsRegistry(), tracer=tracer)
        traces = json.loads(ops("/traces?limit=5")[2])["traces"]
        trace = json.loads(ops(f"/trace?id={tid}")[2])
        return (docs, flagged, ops(f"/profile?id={tid}"),
                [(x["traceId"], x["names"], x["profiled"]) for x in traces],
                trace["profile"], [s["name"] for s in trace["spans"]])
    finally:
        with p._lock:
            p._bursts.pop(tid, None)


def test_attach_burst_and_flag_profiled_match_jax():
    want, got = _bursts(JAX), _bursts(PORT)
    assert got == want
    docs, flagged, folded, traces, profile, spans = got
    assert docs[0]["profile"]["reason"] == "slow.unit" and "profile" not in docs[1]
    assert [t["profiled"] for t in flagged] == [True, False]
    assert folded == (200, "text/plain; charset=utf-8", b"main;a.py:f 3\n")
    assert sorted(traces) == [("12" * 16, ["unit"], True), ("34" * 16, ["unit"], False)]
    assert profile == docs[0]["profile"] and spans == ["unit"]


# -- a live node: traceparent, series names, /status and /profile ------------------

SERIES = ("bcos_rpc_", "bcos_zk_")
# the serving series a tx, a getProof and a scrape must leave (the
# registries are process-wide: other tests may have left more)
SERVED = {"bcos_rpc_cache_hits_total", "bcos_rpc_cache_misses_total", "bcos_rpc_cache_entries",
          "bcos_rpc_cache_bytes", "bcos_zk_proofs_rendered_total",
          "bcos_zk_proof_cache_hits_total"}


def _live(root: str):
    """A node armed as the JAX defaults would arm a traced, profiled one:
    a tx over RPC under a sampled traceparent header, its trace by id, the
    edge's /metrics series of the serving planes, /status and /profile."""
    tid = "5a" * 16
    tp = f"00-{tid}-{'6b' * 8}-01"
    with rpc.serving(root, rpc_port=0, metrics_port=0, trace_sample_rate=0.0,
                     profile_hz=47.0) as node:
        sdk = rpc.client(root, node)
        try:
            w = rpc.frames("ecdsa", rpc.REGISTERS[:1], "live")[0]
            conn = http.client.HTTPConnection(node.rpc.host, node.rpc.port, timeout=30)
            conn.request("POST", "/", body=json.dumps(rpc._req(
                1, "sendTransaction", ("group0", "", "0x" + w.hex(), False, True))).encode(),
                headers={"traceparent": tp})
            resp = conn.getresponse()
            echoed, body = resp.getheader("traceparent"), json.loads(resp.read())
            conn.close()
            trace = sdk.request("getTrace", ["group0", "", tid])
            listed = sdk.request("listTraces", ["group0", "", 5])
            sdk.request("getProof", ["group0", "", body["result"]["transactionHash"]])
            text = _get(node.rpc.port, "/metrics")[2].decode()
            names = SERVED & {ln.split("{")[0].split(" ")[0] for ln in text.splitlines()
                              if ln.startswith(SERIES)}
            scrape = _get(node.metrics.port, "/metrics")[2].decode()
            status = json.loads(_get(node.rpc.port, "/status")[2])
            folded = _get(node.rpc.port, "/profile")[2].decode()
            return dict(echoed=echoed, status=body["result"]["status"],
                        spans=sorted({s["name"] for s in trace["spans"]}),
                        listed=tid in [t["traceId"] for t in listed["traces"]],
                        names=names, same_scrape=all(n in scrape for n in names),
                        status_keys=sorted(status), profile=status["profile"]["armed"],
                        roles={ln.split(";", 1)[0] for ln in folded.splitlines()})
        finally:
            sdk.close()
            profiler(root).configure(hz=0)


def test_live_node_traces_series_and_profile_match_jax():
    want, got = _live(JAX), _live(PORT)
    roles = got.pop("roles"), want.pop("roles")
    assert got == want
    assert got["echoed"] == f"00-{'5a' * 16}-{'6b' * 8}-01" and got["status"] == 0
    assert "rpc.sendTransaction" in got["spans"] and "ingest.admit" in got["spans"]
    assert got["listed"] and got["same_scrape"] and got["profile"]
    assert got["names"] == SERVED
    assert "edge" in roles[0] and "edge" in roles[1]
