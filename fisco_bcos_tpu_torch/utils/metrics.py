"""In-process metrics registry + Prometheus text exporter.

Counterpart of the reference's observability stack: the METRIC log channel
(bcos-utilities BoostLog.h + e.g. TxPool.cpp:206) scraped into the
Prometheus/Grafana bundle shipped under
FISCO-BCOS tools/BcosBuilder/docker/host/linux/monitor/ with
tools/template/Dashboard.json. Instead of log scraping, the framework keeps
counters/gauges/histograms in-process and exposes them in the Prometheus
text format, so the same Grafana dashboards can point straight at a node.
The HTTP scrape endpoint (`MetricsServer` in the JAX package) rides the
RPC edge and is not ported yet (ROADMAP.md). `utils.log.metric()` keeps
emitting the flat METRIC lines; this registry is the queryable aggregate
view (also served by the RPC `getMetrics` method).
"""

from __future__ import annotations

import threading
import time
from typing import Optional


class _Histogram:
    __slots__ = ("buckets", "counts", "total", "count")

    def __init__(self, buckets):
        self.buckets = list(buckets)
        self.counts = [0] * (len(self.buckets) + 1)
        self.total = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        self.total += v
        self.count += 1
        for i, b in enumerate(self.buckets):
            if v <= b:
                self.counts[i] += 1
                return
        self.counts[-1] += 1


class MetricsRegistry:
    """Process-wide by default (`REGISTRY`), like the reference's logger-
    backed METRIC channel. Deployments run ONE node per process (the Air
    binary's shape), so unlabeled series are per-node in practice; when
    several Nodes share a process (in-process test clusters), their gauges
    share the default registry and the last writer wins — scrape accuracy
    there requires per-node registries passed to MetricsServer."""

    DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 30.0)

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[tuple[str, tuple], float] = {}
        self._gauges: dict[tuple[str, tuple], float] = {}
        self._hists: dict[tuple[str, tuple], _Histogram] = {}

    @staticmethod
    def _key(name: str, labels: Optional[dict]) -> tuple[str, tuple]:
        return name, tuple(sorted((labels or {}).items()))

    def inc(self, name: str, value: float = 1.0,
            labels: Optional[dict] = None) -> None:
        k = self._key(name, labels)
        with self._lock:
            self._counters[k] = self._counters.get(k, 0.0) + value

    def set_gauge(self, name: str, value: float,
                  labels: Optional[dict] = None) -> None:
        with self._lock:
            self._gauges[self._key(name, labels)] = value

    def observe(self, name: str, value: float,
                labels: Optional[dict] = None,
                buckets: Optional[tuple] = None) -> None:
        """`buckets` applies on first observation of a series only (a
        histogram's buckets are immutable once created) — pass it for
        non-latency series (e.g. batch sizes) where the time-shaped
        DEFAULT_BUCKETS would collapse everything into +Inf."""
        k = self._key(name, labels)
        with self._lock:
            h = self._hists.get(k)
            if h is None:
                h = self._hists[k] = _Histogram(buckets or
                                                self.DEFAULT_BUCKETS)
            h.observe(value)

    def timer(self, name: str, labels: Optional[dict] = None):
        reg = self

        class _T:
            def __enter__(self):
                self.t0 = time.perf_counter()
                return self

            def __exit__(self, *exc):
                reg.observe(name, time.perf_counter() - self.t0, labels)
                return False

        return _T()

    # -- export ------------------------------------------------------------
    @staticmethod
    def _esc_label(value) -> str:
        """Prometheus exposition label-value escaping: backslash, double
        quote and newline must be escaped or the whole scrape is invalid
        text (a group id with a quote would silently break every panel)."""
        return (str(value).replace("\\", "\\\\").replace('"', '\\"')
                .replace("\n", "\\n"))

    @classmethod
    def _fmt_labels(cls, labels: tuple) -> str:
        if not labels:
            return ""
        inner = ",".join(f'{k}="{cls._esc_label(v)}"' for k, v in labels)
        return "{" + inner + "}"

    def prometheus_text(self) -> str:
        lines = []
        typed: set[str] = set()  # one TYPE line per metric NAME, not series

        def type_line(name: str, kind: str) -> None:
            if name not in typed:
                typed.add(name)
                lines.append(f"# TYPE {name} {kind}")

        with self._lock:
            for (name, labels), v in sorted(self._counters.items()):
                type_line(name, "counter")
                lines.append(f"{name}{self._fmt_labels(labels)} {v}")
            for (name, labels), v in sorted(self._gauges.items()):
                type_line(name, "gauge")
                lines.append(f"{name}{self._fmt_labels(labels)} {v}")
            for (name, labels), h in sorted(self._hists.items()):
                type_line(name, "histogram")
                cum = 0
                for b, c in zip(h.buckets, h.counts):
                    cum += c
                    lab = dict(labels)
                    lab["le"] = repr(b)
                    lines.append(
                        f"{name}_bucket{self._fmt_labels(tuple(sorted(lab.items())))} {cum}")
                cum += h.counts[-1]
                lab = dict(labels)
                lab["le"] = "+Inf"
                lines.append(
                    f"{name}_bucket{self._fmt_labels(tuple(sorted(lab.items())))} {cum}")
                lines.append(f"{name}_sum{self._fmt_labels(labels)} {h.total}")
                lines.append(f"{name}_count{self._fmt_labels(labels)} {h.count}")
        return "\n".join(lines) + "\n"

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "counters": {f"{n}{dict(l) or ''}": v
                             for (n, l), v in self._counters.items()},
                "gauges": {f"{n}{dict(l) or ''}": v
                           for (n, l), v in self._gauges.items()},
                "histograms": {
                    f"{n}{dict(l) or ''}": {"count": h.count, "sum": h.total}
                    for (n, l), h in self._hists.items()},
            }


class GroupMetricsView:
    """A registry facade stamping every series with a `group` label while
    ALSO writing the unlabeled series — multi-group processes get accurate
    per-group counters/gauges without breaking dashboards built on the
    unlabeled totals (unlabeled counters become cross-group sums; unlabeled
    gauges keep their documented last-writer-wins semantics)."""

    def __init__(self, registry: "MetricsRegistry", group: str):
        self._r = registry
        self._labels = {"group": group}

    def _merge(self, labels: Optional[dict]) -> dict:
        return {**(labels or {}), **self._labels}

    def inc(self, name: str, value: float = 1.0,
            labels: Optional[dict] = None) -> None:
        self._r.inc(name, value, labels)
        self._r.inc(name, value, self._merge(labels))

    def set_gauge(self, name: str, value: float,
                  labels: Optional[dict] = None) -> None:
        self._r.set_gauge(name, value, labels)
        self._r.set_gauge(name, value, self._merge(labels))

    def observe(self, name: str, value: float,
                labels: Optional[dict] = None,
                buckets: Optional[tuple] = None) -> None:
        self._r.observe(name, value, labels, buckets=buckets)
        self._r.observe(name, value, self._merge(labels), buckets=buckets)

    def timer(self, name: str, labels: Optional[dict] = None):
        view = self

        class _T:
            def __enter__(self):
                self.t0 = time.perf_counter()
                return self

            def __exit__(self, *exc):
                # observe() dual-writes (unlabeled + group) like every
                # other method here — the docstring's promise holds for
                # timers too
                view.observe(name, time.perf_counter() - self.t0, labels)
                return False

        return _T()


REGISTRY = MetricsRegistry()  # process-wide default


def for_group(group: str, registry: Optional[MetricsRegistry] = None
              ) -> GroupMetricsView:
    """Per-group dual-writing view over `registry` (default REGISTRY)."""
    return GroupMetricsView(registry or REGISTRY, group)
