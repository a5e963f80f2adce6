"""Event-loop serving edge — keep-alive HTTP with bounded worker offload.

Reference counterpart: the reference's access layer runs on boostssl's
ASIO stack (FISCO-BCOS bcos-boostssl/bcos-boostssl/httpserver/) — a
small set of event-loop threads multiplexing thousands of keep-alive
sessions, with the actual JSON-RPC work posted to a thread pool. The old
edge here was Python's `ThreadingHTTPServer`: one OS thread per
connection, a fresh TCP handshake per request (urllib clients don't
reuse), and under 8-way load on a 2-core host the accept backlog reset
connections mid-handshake (the `test_rpc_concurrent_clients_share_batches`
flake). This module is the ASIO analogue on stdlib `selectors`:

  * ONE event-loop thread owns every socket: accept, read, HTTP/1.1
    parse, write. Connections are keep-alive by default and requests may
    be PIPELINED — the loop parses as many complete requests as the
    buffer holds and guarantees responses are written in request order.
  * blocking work (ingest-lane futures, `call`, receipt waits) never
    runs on the loop: each parsed request is handed to a bounded
    `WorkerPool`; a full pool answers 503-shaped JSON-RPC errors instead
    of queueing without bound, and a connection with too many in-flight
    requests simply stops being read (TCP backpressure) until responses
    drain.
  * the pool is SHARED with the WS server (init/node.py wires one pool
    per node), so the node's total RPC concurrency is one knob
    (`rpc_workers`), not a thread-per-message free-for-all.
"""

from __future__ import annotations

import queue
import selectors
import socket
import threading
import time
from collections import deque
from typing import Callable, Optional

from ..utils.log import LOG, badge
from ..utils.metrics import REGISTRY

MAX_HEADER = 64 * 1024
MAX_BODY = 32 * 1024 * 1024
RECV_CHUNK = 256 * 1024
# per-connection pipelining depth: beyond this the loop stops reading the
# socket (TCP backpressure) until responses drain
MAX_PIPELINE = 32
# per-connection unsent-response bound: a client that pipelines requests
# but never drains its socket stops being read once this much rendered
# output is queued (inflight alone can't bound memory — each completion
# frees a pipeline slot while its bytes may still sit in outbuf)
MAX_OUTBUF = 8 * 1024 * 1024


class WorkerPool:
    """Bounded thread pool for blocking RPC work.

    `try_submit` never blocks: a full queue returns False and the caller
    degrades (HTTP answers a busy error; WS falls back to a one-off
    thread) — the event loop must never park behind the verify engine."""

    def __init__(self, workers: int = 8, queue_cap: Optional[int] = None,
                 name: str = "rpc-worker"):
        self.workers = max(1, int(workers))
        self._q: "queue.Queue[Optional[Callable]]" = queue.Queue(
            queue_cap if queue_cap is not None else self.workers * 64)
        self._name = name
        self._threads: list[threading.Thread] = []
        self._started = False

    def start(self) -> None:
        if self._started:
            return
        self._started = True
        for i in range(self.workers):
            t = threading.Thread(target=self._run, name=f"{self._name}-{i}",
                                 daemon=True)
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        if not self._started:
            return
        self._started = False  # try_submit rejects from here on
        # drop queued-but-unstarted jobs so the sentinels fit without
        # blocking (a saturated queue must not hang Node.stop), then give
        # ALL workers a shared 5 s deadline instead of 5 s each — workers
        # parked in long receipt waits are daemons, leaking them on
        # shutdown beats stalling it
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        for _ in self._threads:
            try:
                self._q.put_nowait(None)
            except queue.Full:
                break
        deadline = time.monotonic() + 5
        for t in self._threads:
            t.join(timeout=max(0.0, deadline - time.monotonic()))
        self._threads.clear()

    def try_submit(self, fn: Callable[[], None]) -> bool:
        if not self._started:
            return False
        try:
            self._q.put_nowait(fn)
            return True
        except queue.Full:
            REGISTRY.inc("bcos_rpc_pool_saturated_total")
            return False

    def _run(self) -> None:
        while True:
            fn = self._q.get()
            if fn is None:
                return
            try:
                fn()
            except Exception:  # noqa: BLE001 — a job must not kill a worker
                LOG.exception(badge("RPC", "worker-job-failed"))


class _Conn:
    __slots__ = ("sock", "peer", "peer_ip", "rbuf", "outbuf", "out_off",
                 "next_seq", "write_seq", "ready", "inflight",
                 "close_after", "peer_closed", "last_active", "interest")

    def __init__(self, sock: socket.socket, peer: str):
        self.sock = sock
        self.peer = peer
        # admission identity fallback when the client sends no x-api-key:
        # the peer ADDRESS (not the port — one client, many connections)
        self.peer_ip = peer.rsplit(":", 1)[0]
        # bytearrays, NOT bytes: the ONE loop thread owns every socket, so
        # buffer growth must be amortized append (bytes += re-copies the
        # whole buffer per recv — O(n^2) for a chunked 32MB body) and
        # drain must be an offset bump, compacted occasionally
        self.rbuf = bytearray()
        self.outbuf = bytearray()
        self.out_off = 0    # sent-but-not-compacted prefix of outbuf
        self.next_seq = 0   # seq assigned to the next parsed request
        self.write_seq = 0  # next seq whose response goes on the wire
        # seq -> (status, body, content_type, extra_headers)
        self.ready: dict[int, tuple] = {}
        self.inflight = 0
        self.close_after: Optional[int] = None  # Connection: close seq
        self.peer_closed = False
        self.last_active = time.monotonic()
        self.interest = 0

    def out_pending(self) -> int:
        return len(self.outbuf) - self.out_off


class EventLoopHttpServer:
    """selectors-based HTTP/1.1 server: keep-alive, pipelining, ordered
    responses, bounded-pool offload. `handler(body: bytes) -> bytes` runs
    on a worker thread and returns the JSON response body (b"" for a
    notification-only payload)."""

    def __init__(self, handler: Optional[Callable[[bytes], bytes]],
                 host: str = "127.0.0.1", port: int = 0,
                 pool: Optional[WorkerPool] = None,
                 keepalive_s: float = 60.0, name: str = "jsonrpc-http",
                 ops: Optional[Callable[[str],
                                        tuple[int, str, bytes]]] = None,
                 admission=None):
        self.handler = handler
        # operator GET routes (rpc/ops.OpsRoutes): /metrics, /status,
        # /trace served from THIS loop — no dedicated scrape thread/port
        self.ops = ops
        # per-client admission control (rpc/admission.ClientAdmission):
        # token buckets + fair-share inflight, checked INLINE on the loop
        # so a -32005 reject never costs a worker slot. None = open edge.
        self.admission = admission
        # a handler may take (body) or (body, headers); headers carry the
        # W3C traceparent for the tracing plane. Decided once, not per
        # request.
        self._handler_wants_headers = False
        if handler is not None:
            try:
                import inspect
                sig = inspect.signature(handler)
                self._handler_wants_headers = len(sig.parameters) >= 2
            except (TypeError, ValueError):
                pass
        self.pool = pool or WorkerPool()
        self._own_pool = pool is None
        self.keepalive_s = keepalive_s
        self._name = name
        self._listener = socket.create_server((host, port), backlog=256)
        self._listener.setblocking(False)
        self.host, self.port = self._listener.getsockname()[:2]
        self._sel = selectors.DefaultSelector()
        self._sel.register(self._listener, selectors.EVENT_READ, "accept")
        # self-pipe: workers wake the loop when a response completes
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._sel.register(self._wake_r, selectors.EVENT_READ, "wake")
        self._done_lock = threading.Lock()
        self._done: deque[tuple[_Conn, int, int, bytes]] = deque()
        self._conns: set[_Conn] = set()
        self._stopped = False
        self._cleaned = False
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        if self._own_pool:
            self.pool.start()
        self._thread = threading.Thread(target=self._loop, name=self._name,
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stopped = True
        self._wakeup()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        else:
            # start() never ran (e.g. Node.start() raised between binding
            # the listener and rpc.start()): the loop's cleanup never
            # executes, so release the port and selector/wake fds here
            self._cleanup()
        if self._own_pool:
            self.pool.stop()

    def _wakeup(self) -> None:
        try:
            self._wake_w.send(b"\x01")
        except OSError:
            pass

    # -- worker -> loop completion channel ---------------------------------
    def _complete(self, conn: _Conn, seq: int, status: int,
                  body: bytes, ctype: str = "application/json",
                  headers: Optional[dict] = None) -> None:
        with self._done_lock:
            self._done.append((conn, seq, status, body, ctype, headers))
        self._wakeup()

    # -- event loop --------------------------------------------------------
    def _loop(self) -> None:
        last_reap = time.monotonic()
        try:
            while not self._stopped:
                for key, _mask in self._sel.select(timeout=1.0):
                    if key.data == "accept":
                        self._accept()
                    elif key.data == "wake":
                        try:
                            while self._wake_r.recv(4096):
                                pass
                        except (BlockingIOError, OSError):
                            pass
                    else:
                        self._service(key.data, _mask)
                self._drain_done()
                now = time.monotonic()
                if now - last_reap >= 1.0:
                    last_reap = now
                    self._reap_idle(now)
        finally:
            self._cleanup()

    def _cleanup(self) -> None:
        if self._cleaned:
            return
        self._cleaned = True
        for conn in list(self._conns):
            self._close(conn)
        try:
            self._sel.unregister(self._listener)
        except (KeyError, ValueError):
            pass
        self._listener.close()
        self._sel.close()
        self._wake_r.close()
        self._wake_w.close()

    def _accept(self) -> None:
        while True:
            try:
                sock, addr = self._listener.accept()
            except (BlockingIOError, OSError):
                return
            sock.setblocking(False)
            try:
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except OSError:
                pass
            conn = _Conn(sock, f"{addr[0]}:{addr[1]}")
            self._conns.add(conn)
            self._set_interest(conn)

    def _set_interest(self, conn: _Conn) -> None:
        want = 0
        if (not conn.peer_closed and conn.close_after is None
                and conn.inflight < MAX_PIPELINE
                and conn.out_pending() < MAX_OUTBUF):
            want |= selectors.EVENT_READ
        if conn.out_pending():
            want |= selectors.EVENT_WRITE
        if want == conn.interest:
            return
        try:
            if conn.interest == 0 and want != 0:
                self._sel.register(conn.sock, want, conn)
            elif want == 0:
                self._sel.unregister(conn.sock)
            else:
                self._sel.modify(conn.sock, want, conn)
            conn.interest = want
        except (KeyError, ValueError, OSError):
            pass

    def _service(self, conn: _Conn, mask: int) -> None:
        if mask & selectors.EVENT_READ:
            self._on_readable(conn)
        if conn in self._conns and mask & selectors.EVENT_WRITE:
            self._on_writable(conn)
            if conn in self._conns and conn.rbuf:
                self._parse(conn)  # outbuf drained below cap: resume

    def _on_readable(self, conn: _Conn) -> None:
        try:
            data = conn.sock.recv(RECV_CHUNK)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            self._close(conn)
            return
        if not data:
            conn.peer_closed = True
            if conn.rbuf:
                self._parse(conn)  # answer requests fully received pre-FIN
            if conn not in self._conns:
                return
            if conn.inflight == 0 and not conn.out_pending():
                self._close(conn)
            else:
                self._set_interest(conn)
            return
        conn.last_active = time.monotonic()
        conn.rbuf += data
        self._parse(conn)

    def _parse(self, conn: _Conn) -> None:
        """Cut as many complete requests as the buffer holds (pipelining)
        and dispatch each to the pool; responses rejoin in seq order."""
        while (conn in self._conns and conn.close_after is None
               and conn.inflight < MAX_PIPELINE
               and conn.out_pending() < MAX_OUTBUF):
            # the caps must gate the PARSE loop, not just recv interest:
            # one 256KB recv of tiny pipelined requests would otherwise
            # dispatch thousands of jobs past MAX_PIPELINE in a single
            # burst (excess bytes stay in rbuf until responses drain)
            head_end = conn.rbuf.find(b"\r\n\r\n")
            if head_end < 0:
                if len(conn.rbuf) > MAX_HEADER:
                    self._fail(conn, 431, b"header too large")
                return
            head = conn.rbuf[:head_end].decode("latin-1")
            lines = head.split("\r\n")
            parts = lines[0].split()
            if len(parts) != 3 or not parts[2].startswith("HTTP/1."):
                self._fail(conn, 400, b"bad request line")
                return
            method, version = parts[0], parts[2]
            headers = {}
            for line in lines[1:]:
                if ":" in line:
                    k, v = line.split(":", 1)
                    headers[k.strip().lower()] = v.strip()
            if "chunked" in headers.get("transfer-encoding", "").lower():
                # this edge owns all HTTP framing and does not implement
                # chunked bodies: reject explicitly, or length defaults
                # to 0 and the chunk framing is misparsed as a bogus
                # pipelined request line
                self._fail(conn, 411, b"chunked body not supported; "
                                      b"send Content-Length")
                return
            try:
                length = int(headers.get("content-length", 0))
            except ValueError:
                length = -1
            if length < 0:  # negative would un-consume rbuf: parse loop
                self._fail(conn, 400, b"bad content-length")
                return
            if length > MAX_BODY:
                self._fail(conn, 413, b"body too large")
                return
            total = head_end + 4 + length
            if len(conn.rbuf) < total:
                return  # body still in flight
            body = bytes(conn.rbuf[head_end + 4:total])
            del conn.rbuf[:total]
            seq = conn.next_seq
            conn.next_seq += 1
            conn.inflight += 1
            conn_hdr = headers.get("connection", "").lower()
            if conn_hdr == "close" or (version == "HTTP/1.0"
                                       and conn_hdr != "keep-alive"):
                conn.close_after = seq  # last request on this connection
            if method == "GET" and self.ops is not None:
                job = self._make_ops_job(conn, seq, parts[1])
                if not self.pool.try_submit(job):
                    self._complete_inline(conn, seq, 503,
                                          b'{"error": "server busy"}')
            elif method != "POST" or self.handler is None:
                self._complete_inline(conn, seq, 405,
                                      b'{"error": "POST only"}')
            else:
                lease_key = None
                if self.admission is not None:
                    # per-client token bucket + fair share, on the loop:
                    # an admission reject costs a dict lookup and an
                    # inline write — that is what keeps reject p99 in the
                    # microseconds while the node is saturated. Writes are
                    # classified by a byte scan (no JSON parse pre-admit);
                    # a batch mixing reads and writes bills as a write.
                    # The charge is PER BILLABLE ENTRY, not per body — a
                    # 256-entry batch must not ride on one token and
                    # multiply the client's budget by max_batch.
                    from .admission import admit_payload
                    key = headers.get("x-api-key") or conn.peer_ip
                    retry = admit_payload(self.admission, key, body)
                    if retry is not None:
                        from .admission import rate_limited_body
                        self._complete_inline(conn, seq, 200,
                                              rate_limited_body(retry))
                        continue
                    lease_key = key
                job = self._make_job(conn, seq, body, headers, lease_key)
                if not self.pool.try_submit(job):
                    # saturated pool: shed THIS request, keep the session
                    if lease_key is not None:
                        self.admission.release(lease_key)
                    self._complete_inline(
                        conn, seq, 200,
                        b'{"jsonrpc": "2.0", "id": null, "error": '
                        b'{"code": -32000, "message": "server busy"}}')
        # MAX_PIPELINE reached or close pending: interest update pauses reads
        if conn in self._conns:
            self._set_interest(conn)

    def _make_job(self, conn: _Conn, seq: int, body: bytes,
                  headers: dict, lease_key: Optional[str] = None
                  ) -> Callable:
        handler = self.handler
        wants_headers = self._handler_wants_headers

        def job() -> None:
            hdrs = None
            try:
                try:
                    out = handler(body, headers) if wants_headers \
                        else handler(body)
                    if isinstance(out, tuple):  # (body, extra resp headers)
                        out, hdrs = out
                except Exception:  # noqa: BLE001 — handler bug, not edge's
                    LOG.exception(badge("RPC", "handler-failed"))
                    out = (b'{"jsonrpc": "2.0", "id": null, "error": '
                           b'{"code": -32603, "message": "internal error"}}')
                self._complete(conn, seq, 200, out, headers=hdrs)
            finally:
                if lease_key is not None:
                    # the fair-share slot covers WORKER occupancy: freed
                    # the moment the handler returns, not when the bytes
                    # drain (outbuf is bounded separately by MAX_OUTBUF)
                    self.admission.release(lease_key)

        return job

    def _make_ops_job(self, conn: _Conn, seq: int, target: str) -> Callable:
        ops = self.ops

        def job() -> None:
            try:
                status, ctype, body = ops(target)
            except Exception:  # noqa: BLE001 — ops bug, not the edge's
                LOG.exception(badge("RPC", "ops-handler-failed"))
                status, ctype, body = 500, "application/json", \
                    b'{"error": "internal error"}'
            self._complete(conn, seq, status, body, ctype=ctype)

        return job

    def _complete_inline(self, conn: _Conn, seq: int, status: int,
                         body: bytes, ctype: str = "application/json",
                         headers: Optional[dict] = None) -> None:
        conn.ready[seq] = (status, body, ctype, headers)
        self._flush_ready(conn)

    def _drain_done(self) -> None:
        while True:
            with self._done_lock:
                if not self._done:
                    return
                conn, seq, status, body, ctype, headers = \
                    self._done.popleft()
            if conn in self._conns:
                conn.ready[seq] = (status, body, ctype, headers)
                self._flush_ready(conn)
                if conn in self._conns and conn.rbuf:
                    # a completion freed pipeline/outbuf room: requests
                    # already received past the cap sit in rbuf and no
                    # READ event will re-deliver them — resume parsing
                    self._parse(conn)

    def _flush_ready(self, conn: _Conn) -> None:
        """Move completed responses to the wire IN REQUEST ORDER."""
        while conn.write_seq in conn.ready:
            status, body, ctype, headers = conn.ready.pop(conn.write_seq)
            closing = conn.close_after == conn.write_seq
            conn.outbuf += self._encode(status, body, closing, ctype,
                                        headers)
            conn.write_seq += 1
            conn.inflight -= 1
        self._on_writable(conn)

    @staticmethod
    def _encode(status: int, body: bytes, closing: bool,
                ctype: str = "application/json",
                headers: Optional[dict] = None) -> bytes:
        reason = {200: "OK", 400: "Bad Request", 404: "Not Found",
                  405: "Method Not Allowed", 411: "Length Required",
                  413: "Payload Too Large",
                  431: "Request Header Fields Too Large",
                  500: "Internal Server Error",
                  503: "Service Unavailable"}.get(status, "OK")
        extra = ""
        if headers:
            extra = "".join(f"{k}: {v}\r\n" for k, v in headers.items())
        head = (f"HTTP/1.1 {status} {reason}\r\n"
                f"Content-Type: {ctype}\r\n"
                f"Content-Length: {len(body)}\r\n"
                f"Connection: {'close' if closing else 'keep-alive'}\r\n"
                f"{extra}\r\n")
        return head.encode("latin-1") + body

    def _on_writable(self, conn: _Conn) -> None:
        if conn.out_pending():
            try:
                sent = conn.sock.send(
                    memoryview(conn.outbuf)[conn.out_off:])
                conn.out_off += sent
                conn.last_active = time.monotonic()
                if conn.out_off >= len(conn.outbuf):
                    conn.outbuf.clear()
                    conn.out_off = 0
                elif conn.out_off > 1 << 20:
                    # compact occasionally, not per send: amortized O(n)
                    del conn.outbuf[:conn.out_off]
                    conn.out_off = 0
            except (BlockingIOError, InterruptedError):
                pass
            except OSError:
                self._close(conn)
                return
        if not conn.out_pending() and conn.inflight == 0 and (
                conn.peer_closed or conn.close_after is not None):
            self._close(conn)
            return
        self._set_interest(conn)

    def _fail(self, conn: _Conn, status: int, msg: bytes) -> None:
        conn.rbuf.clear()
        seq = conn.next_seq
        conn.next_seq += 1
        conn.inflight += 1
        conn.close_after = seq
        self._complete_inline(conn, seq, status, msg)

    def _reap_idle(self, now: float) -> None:
        for conn in list(self._conns):
            stale = now - conn.last_active > self.keepalive_s
            if stale and conn.inflight == 0 and not conn.out_pending():
                self._close(conn)  # idle keep-alive session
            elif stale and conn.out_pending():
                # no WRITE progress for a whole keepalive window (peer
                # vanished without RST, or never drains): reap, or the
                # conn pins an fd + up to MAX_OUTBUF forever. last_active
                # advances on every successful send, so a slow-but-live
                # reader is safe.
                self._close(conn)
        REGISTRY.set_gauge("bcos_rpc_open_connections", len(self._conns))

    def _close(self, conn: _Conn) -> None:
        if conn not in self._conns:
            return
        self._conns.discard(conn)
        try:
            if conn.interest:
                self._sel.unregister(conn.sock)
        except (KeyError, ValueError, OSError):
            pass
        try:
            conn.sock.close()
        except OSError:
            pass
