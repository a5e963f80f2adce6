"""Operator GET routes shared by every HTTP edge in the process.

The reference ships its observability as a sidecar bundle (Prometheus
scraping a METRIC log channel + Grafana dashboards under
tools/BcosBuilder/.../monitor/). Here the node itself serves the operator
surface, from the SAME event-loop edge that serves JSON-RPC (rpc/edge.py
routes GET requests to an `OpsRoutes` instance; `utils.metrics.
MetricsServer` wraps one standalone for deployments that want a separate
scrape port):

  GET /metrics              Prometheus exposition text (0.0.4)
  GET /status               one JSON document per node: the same aggregate
                            the `getSystemStatus` RPC returns
  GET /healthz              health state machine (utils/health.py): 200
                            while `ok`/`busy`, 503 while degraded/failed —
                            the LB/orchestrator liveness contract
  GET /failpoints           the fault-injection surface (utils/failpoints):
                            registered sites + what is armed; `?arm=site=
                            action` / `?disarm=site|all` mutate it, TEST
                            BUILDS ONLY (BCOS_FAILPOINTS_OPS=1)
  GET /trace?id=<trace_id>  every retained span of one trace (otrace ring)
                            plus the burst profile captured for it, if a
                            slow-span firing triggered one
  GET /trace | /traces      newest-first trace summaries
                            (?limit=N, ?slow=1 for the slow ring only);
                            entries carry `profiled: true` when a burst
                            profile is retrievable for them
  GET /profile              the continuous profiler's folded stacks
                            (analysis/profiler.py); `?seconds=N` takes a
                            fresh high-hz capture of N seconds instead;
                            `?fmt=flame` renders the self-contained
                            flamegraph HTML; `?id=<trace_id>` serves the
                            burst profile linked to that trace
"""

from __future__ import annotations

import json
from typing import Callable, Optional
from urllib.parse import parse_qs, urlsplit

PROM_CTYPE = "text/plain; version=0.0.4; charset=utf-8"
JSON_CTYPE = "application/json"


class OpsRoutes:
    """Callable route table: path -> (status, content_type, body_bytes).
    Runs on a bounded worker (never the event loop); every handler is a
    read-only snapshot render."""

    def __init__(self, registry=None, tracer=None,
                 status_fn: Optional[Callable[[], dict]] = None,
                 health_fn: Optional[Callable[[], dict]] = None):
        if registry is None:
            from ..utils.metrics import REGISTRY
            registry = REGISTRY
        if tracer is None:
            from ..utils.otrace import TRACER
            tracer = TRACER
        self.registry = registry
        self.tracer = tracer
        self.status_fn = status_fn
        # health snapshot provider (utils/health.py Health.snapshot);
        # None = this edge serves no node (bare scrape port) -> always ok
        self.health_fn = health_fn

    def __call__(self, target: str) -> tuple[int, str, bytes]:
        parts = urlsplit(target)
        path = parts.path.rstrip("/") or "/metrics"  # GET / keeps scraping
        q = parse_qs(parts.query)
        try:
            if path == "/metrics":
                return 200, PROM_CTYPE, self.registry.prometheus_text(
                ).encode()
            if path == "/status":
                doc = self.status_fn() if self.status_fn is not None else {
                    "trace": self.tracer.stats()}
                return 200, JSON_CTYPE, json.dumps(doc).encode()
            if path == "/healthz":
                doc = self.health_fn() if self.health_fn is not None \
                    else {"state": "ok", "faults": {}}
                # busy = saturated but serving (overload brownout): the
                # liveness contract stays 200 — an LB that pulled every
                # busy node would dogpile the survivors
                code = 200 if doc.get("state") in ("ok", "busy") else 503
                return code, JSON_CTYPE, json.dumps(doc).encode()
            if path == "/failpoints":
                return self._failpoints(q)
            if path in ("/trace", "/traces"):
                from ..analysis import profiler
                tid = (q.get("id") or [None])[0]
                if tid:
                    doc = profiler.attach_burst(
                        {"traceId": tid.lower().removeprefix("0x"),
                         "spans": self.tracer.get_trace(tid)}, tid)
                    return 200, JSON_CTYPE, json.dumps(doc).encode()
                limit = int((q.get("limit") or ["50"])[0])
                slow = (q.get("slow") or ["0"])[0] not in ("0", "", "false")
                traces = profiler.flag_profiled(self.tracer.list_traces(
                    limit=limit, slow_only=slow))
                return 200, JSON_CTYPE, json.dumps(
                    {"traces": traces}).encode()
            if path == "/profile":
                return self._profile(q)
        except Exception as exc:  # noqa: BLE001 — ops surface, stay up
            return 500, JSON_CTYPE, json.dumps(
                {"error": str(exc)}).encode()
        return 404, JSON_CTYPE, b'{"error": "not found"}'

    def _profile(self, q: dict) -> tuple[int, str, bytes]:
        """GET /profile — folded stacks or flamegraph HTML from the
        process profiler. A `seconds=N` capture runs ON THIS bounded
        worker (clamped; the event loop never blocks on it)."""
        from ..analysis import profiler as prof

        fmt = (q.get("fmt") or ["folded"])[0]
        tid = (q.get("id") or [None])[0]
        if tid:
            burst = prof.PROFILER.burst_profile(tid)
            if burst is None:
                return 404, JSON_CTYPE, json.dumps(
                    {"error": f"no burst profile for trace {tid}"}).encode()
            folded, title = burst["folded"], f"burst {tid[:16]}"
        else:
            seconds = float((q.get("seconds") or ["0"])[0])
            if seconds > 0:
                try:
                    folded = prof.PROFILER.capture(seconds)
                except RuntimeError as exc:
                    # single-flight: a concurrent capture must not tie up
                    # the ops pool's second worker too
                    return 429, JSON_CTYPE, json.dumps(
                        {"error": str(exc)}).encode()
                title = f"capture {seconds:g}s"
            else:
                folded = prof.PROFILER.folded()
                title = "continuous profile"
        if fmt == "flame":
            return 200, "text/html; charset=utf-8", prof.flame_html(
                folded, title=title).encode()
        return 200, "text/plain; charset=utf-8", folded.encode()

    def _failpoints(self, q: dict) -> tuple[int, str, bytes]:
        from ..utils import failpoints as fpl

        arm = (q.get("arm") or [None])[0]
        disarm = (q.get("disarm") or [None])[0]
        if arm or disarm:
            if not fpl.ops_arming_enabled():
                return 403, JSON_CTYPE, json.dumps(
                    {"error": "failpoint arming over ops is disabled "
                              "(test builds set BCOS_FAILPOINTS_OPS=1)"}
                ).encode()
            if arm:
                name, eq, action = arm.partition("=")
                if not eq:
                    return 400, JSON_CTYPE, \
                        b'{"error": "arm=site=action"}'
                fpl.arm(name, action)
            elif disarm == "all":
                fpl.disarm_all()
            else:
                fpl.disarm(disarm)
        return 200, JSON_CTYPE, json.dumps(
            {"sites": fpl.list_sites(), "armed": fpl.list_armed(),
             "ops_arming": fpl.ops_arming_enabled()}).encode()
