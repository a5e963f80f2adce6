"""otrace: sampled spans of one transaction's path, OpenTelemetry-shaped.

A traced submission carries a `SpanContext` (trace_id, span_id,
sampled): the thread that submits scopes it (`ctx_scope`, read back by
`current`), and cross-thread handoffs pin it onto the carried object
(an ingest lane entry, a tx's `_otrace`). The ingest lane and the txpool
then record their already-timed stages under it (`TRACER.record`) into a
bounded ring of finished spans, queryable by trace id (`get_trace`).

With no context attached the instrumented hot paths pay one branch.
The block pipeline's stage clock (utils/trace.BlockTrace) offers the
stages of unbound blocks to slow capture (`observe_slow`): a stage longer
than `slow_ms` is kept in a separate slow ring and logged; slow_ms = 0,
the default, keeps nothing. The node front's frames carry a sampled
context packed (`wire_bytes`, read back by `unpack_ctx`), so a block's
trace follows it to every replica. The W3C `traceparent` parsing and
live spans ride the RPC edge and come with it.
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


_WIRE_LEN = 16 + 8 + 1  # trace_id + span_id + flags


class SpanContext:
    """Immutable (trace_id, span_id, sampled) triple: the propagated part
    of a span, W3C Trace Context shaped."""

    __slots__ = ("trace_id", "span_id", "sampled")

    def __init__(self, trace_id: bytes, span_id: bytes, sampled: bool):
        self.trace_id = trace_id
        self.span_id = span_id
        self.sampled = bool(sampled)

    def pack(self) -> bytes:
        """25-byte wire form for the p2p frame envelope."""
        return self.trace_id + self.span_id + (b"\x01" if self.sampled
                                               else b"\x00")


def unpack_ctx(data: bytes) -> Optional[SpanContext]:
    """Inverse of SpanContext.pack (p2p envelope)."""
    if len(data) != _WIRE_LEN:
        return None
    trace_id, span_id = data[:16], data[16:24]
    if trace_id == bytes(16) or span_id == bytes(8):
        return None
    return SpanContext(trace_id, span_id, data[24] & 0x01 != 0)


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


def wire_bytes() -> bytes:
    """Current context packed for the p2p frame envelope: b"" when there
    is nothing worth propagating (no context, or unsampled)."""
    ctx = current()
    if ctx is None or not ctx.sampled:
        return b""
    return ctx.pack()


class Tracer:
    """Process-wide span sink (`TRACER`, like metrics.REGISTRY): a bounded
    ring of the finished spans of sampled traces."""

    def __init__(self, ring_size: int = 4096, slow_ms: float = 0.0,
                 slow_ring: int = 512):
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=max(16, int(ring_size)))
        self._slow: deque = deque(maxlen=max(16, int(slow_ring)))
        self.slow_s = max(0.0, float(slow_ms)) / 1000.0

    def configure(self, slow_ms: Optional[float] = None) -> None:
        """Apply the [trace] slow threshold (0 keeps no slow spans)."""
        if slow_ms is not None:
            self.slow_s = max(0.0, float(slow_ms)) / 1000.0

    def reset(self) -> None:
        """Drop every recorded span."""
        with self._lock:
            self._ring.clear()
            self._slow.clear()

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

    def observe_slow(self, name: str, duration_s: float,
                     attrs: Optional[dict] = None) -> None:
        """Slow-capture seam for paths with no context bound: retains a
        synthetic span in the slow ring iff it exceeds slow_ms (never in
        the main ring)."""
        if self.slow_s <= 0.0 or duration_s < self.slow_s:
            return
        start_wall = time.time() - duration_s
        span = {
            "traceId": _rand_id(16).hex(),
            "spanId": _rand_id(8).hex(),
            "parentSpanId": "",
            "name": name,
            "start_ms": round(start_wall * 1000.0, 3),
            "duration_ms": round(duration_s * 1000.0, 3),
            "attrs": dict(attrs) if attrs else {},
            "slow": True,
        }
        with self._lock:
            self._slow.append(span)
        from . import metrics as _m  # lazy: slow path only
        from .log import LOG, badge
        _m.REGISTRY.inc("bcos_trace_slow_spans_total")
        LOG.warning(badge("TRACE", "slow-span", name=name,
                          ms=span["duration_ms"], trace=span["traceId"][:16]))

    def get_trace(self, trace_id: str) -> list[dict]:
        """Every retained span of `trace_id` (hex), start-ordered, from
        both rings (a slow span is findable by the id logged with it)."""
        tid = trace_id.lower().removeprefix("0x")
        with self._lock:
            spans = [s for s in self._ring if s["traceId"] == tid]
            spans += [s for s in self._slow if s["traceId"] == tid]
        return sorted(spans, key=lambda s: s["start_ms"])


TRACER = Tracer(ring_size=4096)
