"""otrace: sampled spans of one transaction's path, OpenTelemetry-shaped.

A traced submission carries a `SpanContext` (trace_id, span_id,
sampled): the thread that submits scopes it (`ctx_scope`, read back by
`current`), and cross-thread handoffs pin it onto the carried object
(an ingest lane entry, a tx's `_otrace`). The ingest lane and the txpool
then record their already-timed stages under it (`TRACER.record`) into a
bounded ring of finished spans, queryable by trace id (`get_trace`).

With no context attached the instrumented hot paths pay one branch.
The W3C `traceparent` parsing, the p2p envelope's packed context, live
spans and slow-span capture ride the RPC edge and the network and come
with them.
"""

from __future__ import annotations

import random
import threading
import time
from collections import deque
from typing import Optional


def _rand_id(nbytes: int) -> bytes:
    """Span ids need uniqueness, not cryptographic strength; all-zero ids
    are invalid per the W3C spec, hence the `max(..., 1)`."""
    return max(random.getrandbits(nbytes * 8), 1).to_bytes(nbytes, "big")


class SpanContext:
    """Immutable (trace_id, span_id, sampled) triple: the propagated part
    of a span, W3C Trace Context shaped."""

    __slots__ = ("trace_id", "span_id", "sampled")

    def __init__(self, trace_id: bytes, span_id: bytes, sampled: bool):
        self.trace_id = trace_id
        self.span_id = span_id
        self.sampled = bool(sampled)


# -- per-thread context stack ---------------------------------------------
_tls = threading.local()


def current() -> Optional[SpanContext]:
    """The thread's active span context (innermost ctx_scope), or None."""
    stack = getattr(_tls, "stack", None)
    return stack[-1] if stack else None


class ctx_scope:
    """`with ctx_scope(ctx): ...` pushes `ctx` as the thread's current
    context. A None ctx is a no-op scope, so callers never branch."""

    __slots__ = ("ctx",)

    def __init__(self, ctx: Optional[SpanContext]):
        self.ctx = ctx

    def __enter__(self):
        if self.ctx is not None:
            stack = getattr(_tls, "stack", None)
            if stack is None:
                stack = _tls.stack = []
            stack.append(self.ctx)
        return self.ctx

    def __exit__(self, *exc):
        if self.ctx is not None:
            _tls.stack.pop()
        return False


class Tracer:
    """Process-wide span sink (`TRACER`, like metrics.REGISTRY): a bounded
    ring of the finished spans of sampled traces."""

    def __init__(self, ring_size: int = 4096):
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=max(16, int(ring_size)))

    def reset(self) -> None:
        """Drop every recorded span."""
        with self._lock:
            self._ring.clear()

    def record(self, name: str, parent: Optional[SpanContext],
               t0: float, t1: Optional[float] = None,
               attrs: Optional[dict] = None) -> None:
        """Record an already-timed span (monotonic t0/t1) as a child of
        `parent`. No-op when parent is None or unsampled."""
        if parent is None or not parent.sampled:
            return
        t1 = t1 if t1 is not None else time.monotonic()
        # wall-clock anchor derived once at record time (spans carry
        # monotonic stamps until here so cross-stage math never sees a
        # clock step)
        start_wall = time.time() - (time.monotonic() - t0)
        span = {
            "traceId": parent.trace_id.hex(),
            "spanId": _rand_id(8).hex(),
            "parentSpanId": parent.span_id.hex(),
            "name": name,
            "start_ms": round(start_wall * 1000.0, 3),
            "duration_ms": round(max(0.0, t1 - t0) * 1000.0, 3),
            "attrs": dict(attrs) if attrs else {},
        }
        with self._lock:
            self._ring.append(span)

    def get_trace(self, trace_id: str) -> list[dict]:
        """Every retained span of `trace_id` (hex), start-ordered."""
        tid = trace_id.lower().removeprefix("0x")
        with self._lock:
            spans = [s for s in self._ring if s["traceId"] == tid]
        return sorted(spans, key=lambda s: s["start_ms"])


TRACER = Tracer(ring_size=4096)
