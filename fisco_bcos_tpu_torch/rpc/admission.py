"""Edge admission control — per-client token buckets + fair-share
concurrency for the JSON-RPC serving edge.

The event-loop edge (rpc/edge.py) bounds GLOBAL resources (pipeline depth,
outbuf bytes, the shared WorkerPool), but nothing stopped ONE pipelining
client from filling all of them: its requests are cheap to parse and the
pool is first-come-first-served, so a greedy client monopolizes the
workers and every polite client times out behind it. This module is the
front-end filter the Blockchain Machine architecture (PAPERS.md, arXiv
2104.06968) puts before the expensive pipeline:

  * **Per-client token buckets**, keyed by the `x-api-key` header when the
    client sends one, else the peer IP. READS and WRITES get separate
    budgets — a write storm must not brown out the read plane, and
    vice versa. A rate of 0 disables that class's bucket (unlimited).
  * **Overload coupling**: the WRITE rate is multiplied by the overload
    controller's `write_rate_factor()` (utils/overload.py), so a `busy`
    node shrinks write admission without touching reads.
  * **Fair-share concurrency**: each client's in-flight (parsed,
    worker-occupying) requests are counted; a client may hold at most
    `capacity / active_clients` slots (floor `min_share`). One client
    alone still gets the whole pool; ten clients split it.
  * **Typed rejection**: the edge answers `-32005 rate limited` with a
    `retryAfterMs` hint, INLINE on the event loop — a reject costs one
    dict lookup and a socket write, never a worker slot (that is what
    keeps reject latency in the microseconds while the node is melting).

The check runs on the single event-loop thread for HTTP; the lock exists
for the WS server and worker-thread releases.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Optional

JSONRPC_RATE_LIMITED = -32005
# cap on the retryAfterMs hint: while busy shrinks the effective rate
# (possibly to 0 with busy_write_factor=0), the honest hint would be
# "when the brownout ends", which the bucket cannot know — a bounded
# hint keeps honoring clients probing instead of backing off forever
MAX_RETRY_AFTER_MS = 30_000


def rate_limited_body(retry_after_ms: int) -> bytes:
    """The wire shape of an admission reject. id is null — the edge
    rejects BEFORE JSON-parsing the body (that is the point: a reject
    must not cost parse work), so the request id is unknown."""
    return (b'{"jsonrpc": "2.0", "id": null, "error": {"code": %d, '
            b'"message": "rate limited", "data": {"retryAfterMs": %d}}}'
            % (JSONRPC_RATE_LIMITED, max(1, int(retry_after_ms))))


def admit_payload(admission: "ClientAdmission", key: str,
                  payload: bytes):
    """The ONE owner of payload classification + billing, shared by the
    HTTP edge and the WS server (two copies would let the budgets
    diverge). Byte scan, no JSON parse — but JSON string escapes could
    smuggle a method name past it (`"sendTransactio\\u006e"` decodes to
    the write method while the scan sees a read), so any payload
    containing an escape sequence is billed CONSERVATIVELY: classified
    as a write batch of the maximum plausible entry count. Over-billing
    odd-but-honest payloads is fail-safe; under-billing an adversary is
    the bypass. -> None admitted (lease = `key`), else retryAfterMs."""
    n_meth = max(1, payload.count(b'"method"'))
    n_write = min(payload.count(b"sendTransaction"), n_meth)
    if b"\\u" in payload:
        n_meth = max(n_meth, payload.count(b"{"))
        n_write = n_meth
    if n_write:
        return admission.try_admit(key, True, n_write,
                                   read_cost=n_meth - n_write)
    return admission.try_admit(key, False, n_meth)


class _Client:
    __slots__ = ("w_tokens", "w_t", "r_tokens", "r_t", "inflight",
                 "last_seen")

    def __init__(self, now: float, w_burst: float, r_burst: float):
        self.w_tokens = w_burst
        self.w_t = now
        self.r_tokens = r_burst
        self.r_t = now
        self.inflight = 0
        self.last_seen = now


class ClientAdmission:
    """One per serving edge. Thread-safe; every operation is O(1)."""

    MAX_CLIENTS = 4096  # LRU bound on per-client state

    def __init__(self, write_rate: float = 0.0, write_burst: float = 0.0,
                 read_rate: float = 0.0, read_burst: float = 0.0,
                 fair_capacity: int = 64, min_share: int = 2,
                 overload=None, registry=None,
                 clock=None):
        # tokens/second per client; 0 = that class is unlimited
        self.write_rate = max(0.0, float(write_rate))
        self.read_rate = max(0.0, float(read_rate))
        # default burst = 2x rate (a client may catch up after a pause
        # without tripping the limiter, but not flood a whole window);
        # floored at 1 token for LIMITED classes — a sub-1 burst could
        # never cover the admission gate and would be a silent total ban
        # instead of a slow pace (e.g. rate 0.4/s -> burst 0.8)
        self.write_burst = float(write_burst) if write_burst > 0 \
            else 2.0 * self.write_rate
        if self.write_rate > 0.0:
            self.write_burst = max(1.0, self.write_burst)
        self.read_burst = float(read_burst) if read_burst > 0 \
            else 2.0 * self.read_rate
        if self.read_rate > 0.0:
            self.read_burst = max(1.0, self.read_burst)
        # fair-share concurrency: total worker-occupying slots divided
        # among the clients currently holding any
        self.fair_capacity = max(1, int(fair_capacity))
        self.min_share = max(1, int(min_share))
        self.overload = overload
        self._registry = registry
        self._clock = clock or time.monotonic
        self._lock = threading.Lock()
        self._clients: "OrderedDict[str, _Client]" = OrderedDict()
        self._active = 0  # clients with inflight > 0
        self._rejected_writes = 0
        self._rejected_reads = 0
        self._rejected_share = 0

    # -- internals ---------------------------------------------------------
    def _get_locked(self, key: str, now: float) -> _Client:
        c = self._clients.get(key)
        if c is None:
            c = self._clients[key] = _Client(now, self.write_burst,
                                             self.read_burst)
            while len(self._clients) > self.MAX_CLIENTS:
                # evict the least-recently-seen IDLE client; an inflight
                # holder must keep its state or release() underflows —
                # and never the entry just inserted (when every older
                # client is inflight, evicting `key` would orphan the
                # object the caller is about to account against, leaking
                # an _active increment forever)
                for k in self._clients:
                    if self._clients[k].inflight == 0 and k != key:
                        self._clients.pop(k)
                        break
                else:
                    break
        else:
            self._clients.move_to_end(key)
        c.last_seen = now
        return c

    @staticmethod
    def _take(tokens: float, t: float, now: float, rate: float,
              burst: float, cost: float) -> tuple[bool, float, float, float]:
        """-> (admitted, new_tokens, new_t, retry_after_s).

        Debt model for costs beyond the burst: the admission GATE is
        min(cost, burst) — so a max-size batch is not starved forever —
        but the CHARGE is the full cost, driving the balance negative.
        Refills pay the debt off first, so the long-run admitted rate is
        exactly `rate` regardless of batch size (a gate-only clamp would
        let 256-entry batches ride on `burst` tokens, a batch-size
        multiplier on the budget)."""
        cost = max(1.0, cost)
        gate = min(cost, max(1.0, burst))
        tokens = min(burst, tokens + (now - t) * rate)
        if tokens >= gate:
            return True, tokens - cost, now, 0.0
        return False, tokens, now, (gate - tokens) / max(rate, 1e-9)

    # -- the edge's calls --------------------------------------------------
    def try_admit(self, key: str, is_write: bool, cost: int = 1,
                  read_cost: int = 0) -> Optional[int]:
        """None = admitted (an inflight slot is HELD — pair with
        release(key)); else the retryAfterMs hint for the -32005 reject.

        `cost` is the token charge against the payload's class bucket —
        the CALLER's count of billable entries, so a 256-entry batch
        cannot ride on one token and multiply the budget 256x. For a
        write-classified payload, `read_cost` is its READ-entry count
        (a mixed batch): billed against the read bucket too, so read
        entries cannot ride a write batch for free. A write payload with
        the write bucket UNLIMITED bills everything as reads instead —
        unlimited-class smuggling (embedding 'sendTransaction' bytes in
        a read) buys nothing."""
        now = self._clock()
        with self._lock:
            c = self._get_locked(key, now)
            # fair share first (cheap, and a hog should hear "later", not
            # burn its token budget on requests it cannot run)
            share = max(self.min_share,
                        self.fair_capacity // max(1, self._active))
            if c.inflight >= share:
                self._rejected_share += 1
                retry = 20
            else:
                w_cost, r_cost = 0, cost
                if is_write:
                    if self.write_rate > 0.0:
                        w_cost, r_cost = cost, read_cost
                    else:  # write bucket unlimited: bill ALL as reads
                        w_cost, r_cost = 0, cost + read_cost
                retry = None
                w_charged = 0
                if w_cost and self.write_rate > 0.0:
                    rate = self.write_rate
                    if self.overload is not None:
                        # brownout: busy shrinks WRITE admission only
                        rate *= self.overload.write_rate_factor()
                    ok, c.w_tokens, c.w_t, after = self._take(
                        c.w_tokens, c.w_t, now, rate, self.write_burst,
                        w_cost)
                    if ok:
                        w_charged = w_cost
                    else:
                        self._rejected_writes += 1
                        retry = int(after * 1000)
                if retry is None and r_cost and self.read_rate > 0.0:
                    ok, c.r_tokens, c.r_t, after = self._take(
                        c.r_tokens, c.r_t, now, self.read_rate,
                        self.read_burst, r_cost)
                    if not ok:
                        c.w_tokens += w_charged  # refund the half-charge
                        self._rejected_reads += 1
                        retry = int(after * 1000)
                if retry is None:
                    if c.inflight == 0:
                        self._active += 1
                    c.inflight += 1
                    return None
        if self._registry is not None:
            self._registry.inc("bcos_rpc_rate_limited_total",
                               labels={"kind": "write" if is_write
                                       else "read"})
        return max(1, min(retry, MAX_RETRY_AFTER_MS))

    def release(self, key: str) -> None:
        """Request finished (response completed OR shed after admission):
        free the client's inflight slot."""
        with self._lock:
            c = self._clients.get(key)
            if c is None or c.inflight <= 0:
                return
            c.inflight -= 1
            if c.inflight == 0:
                self._active = max(0, self._active - 1)

    def stats(self) -> dict:
        with self._lock:
            return {
                "clients": len(self._clients),
                "active": self._active,
                "rejected_writes": self._rejected_writes,
                "rejected_reads": self._rejected_reads,
                "rejected_fair_share": self._rejected_share,
                "write_rate": self.write_rate,
                "read_rate": self.read_rate,
                "write_rate_factor": (
                    self.overload.write_rate_factor()
                    if self.overload is not None else 1.0),
            }
