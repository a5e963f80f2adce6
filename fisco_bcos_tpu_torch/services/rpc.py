"""Service RPC — the Pro/Max microservice transport.

Reference counterpart: Tars RPC between module services
(FISCO-BCOS bcos-tars-protocol/ — 26 .tars IDL files + generated
servant proxies in client/, wrapped per-module under
fisco-bcos-tars-service/*Service/). The framework equivalent is a small
length-prefixed request/response protocol over TCP using the deterministic
wire codec: frame = u32 length | u64 seq | u8 kind | text method | blob
payload. Servers register method handlers; clients get synchronous proxies
with timeouts. No IDL compiler — method payloads are wire-codec structs
owned by each service module (storage_service, executor_service).
"""

from __future__ import annotations

import itertools
import socket
import socketserver
import struct
import threading
from typing import Callable, Optional

from ..codec.wire import Reader, Writer
from ..net.p2p import MAX_FRAME, _recv_exact
from ..utils.log import LOG, badge

KIND_REQUEST = 0
KIND_RESPONSE = 1
KIND_ERROR = 2

Handler = Callable[[Reader, Writer], None]


def _send_frame(sock: socket.socket, seq: int, kind: int, method: str,
                payload: bytes) -> None:
    w = Writer()
    w.u64(seq).u8(kind).text(method).blob(payload)
    body = w.bytes()
    sock.sendall(struct.pack(">I", len(body)) + body)


def _recv_frame(sock: socket.socket):
    hdr = _recv_exact(sock, 4)
    if hdr is None:
        return None
    (n,) = struct.unpack(">I", hdr)
    if n > MAX_FRAME:  # same cap as the P2P transport: reject, don't OOM
        return None
    body = _recv_exact(sock, n)
    if body is None:
        return None
    r = Reader(body)
    return r.u64(), r.u8(), r.text(), r.blob()


class ServiceServer:
    """Threaded TCP server dispatching named methods.

    ``tls_ctx`` (anything with ``wrap_socket(sock, server_side=...)`` —
    ssl.SSLContext or net.smtls.SMTLSContext) secures the service plane:
    Max-mode shard/registry traffic crosses machines, and SM-TLS gives it
    the same mutual-auth channel as the P2P gateway."""

    def __init__(self, name: str, host: str = "127.0.0.1", port: int = 0,
                 tls_ctx=None):
        self.name = name
        self._methods: dict[str, Handler] = {}
        self._conns: set = set()
        self._conns_lock = threading.Lock()
        self._tls = tls_ctx
        outer = self

        class _H(socketserver.BaseRequestHandler):
            def handle(self):
                chan = self.request
                try:
                    if outer._tls is not None:
                        chan = outer._tls.wrap_socket(self.request,
                                                      server_side=True)
                        # track the WRAPPED channel: ssl.SSLContext
                        # detaches the raw fd, so severing the raw socket
                        # in stop() would be a no-op and leak the TLS fd
                        with outer._conns_lock:
                            outer._conns.discard(self.request)
                            outer._conns.add(chan)
                    self._serve(chan)
                except (ConnectionError, OSError):
                    pass  # abrupt client disconnects are routine (long-poll
                    # proxies close mid-park); not worth a traceback —
                    # failed TLS handshakes land here too (untrusted peer)
                finally:
                    with outer._conns_lock:
                        outer._conns.discard(chan)
                        outer._conns.discard(self.request)
                    if chan is not self.request:
                        try:
                            chan.close()
                        except OSError:
                            pass

            def _serve(self, chan):
                while True:
                    frame = _recv_frame(chan)
                    if frame is None:
                        return
                    seq, kind, method, payload = frame
                    if kind != KIND_REQUEST:
                        continue
                    fn = outer._methods.get(method)
                    w = Writer()
                    try:
                        if fn is None:
                            raise KeyError(f"unknown method {method!r}")
                        fn(Reader(payload), w)
                        _send_frame(chan, seq, KIND_RESPONSE, method,
                                    w.bytes())
                    except Exception as exc:  # noqa: BLE001 — RPC boundary
                        LOG.exception(badge("SVC", "handler-failed",
                                            service=outer.name, method=method))
                        ew = Writer()
                        ew.text(f"{type(exc).__name__}: {exc}")
                        _send_frame(chan, seq, KIND_ERROR, method,
                                    ew.bytes())

        class _Srv(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

            def process_request(self, request, client_address):
                # register synchronously in the accept loop (not in the
                # handler thread): stop()'s shutdown() waits for this loop
                # iteration, so no accepted connection can slip past the
                # severing pass below
                with outer._conns_lock:
                    outer._conns.add(request)
                super().process_request(request, client_address)

        self._server = _Srv((host, port), _H)
        self.host, self.port = self._server.server_address
        self._thread: Optional[threading.Thread] = None

    def register(self, method: str, fn: Handler) -> None:
        self._methods[method] = fn

    def start(self) -> None:
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True,
                                        name=f"svc-{self.name}")
        self._thread.start()
        LOG.info(badge("SVC", "started", service=self.name, port=self.port))

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        # sever established connections too: a stopped service must look
        # like a killed process to its clients, not keep answering over
        # persistent connections (HA failover depends on this)
        with self._conns_lock:
            conns = list(self._conns)
            self._conns.clear()
        for sock in conns:
            shut = getattr(sock, "shutdown", None)
            if shut is not None:  # SMSocket has close only
                try:
                    shut(2)  # SHUT_RDWR
                except OSError:
                    pass
            try:
                sock.close()
            except OSError:
                pass


class ServiceRemoteError(RuntimeError):
    pass


class ServiceClient:
    """Synchronous client with one pooled connection (thread-safe)."""

    def __init__(self, host: str, port: int, timeout: float = 30.0,
                 tls_ctx=None):
        self.addr = (host, port)
        self.timeout = timeout
        self.tls_ctx = tls_ctx  # see ServiceServer: SM-TLS/ssl context
        self._seq = itertools.count(1)
        self._lock = threading.Lock()
        self._sock = None

    def _connect(self):
        if self._sock is None:
            s = socket.create_connection(self.addr, timeout=self.timeout)
            s.settimeout(self.timeout)
            if self.tls_ctx is not None:
                s = self.tls_ctx.wrap_socket(s, server_side=False)
            self._sock = s
        return self._sock

    def call(self, method: str, build: Optional[Callable[[Writer], None]]
             = None, retry: bool = True) -> Reader:
        """retry=False: do NOT resend on a broken connection — required for
        non-idempotent server ops (a resend could execute them twice)."""
        w = Writer()
        if build:
            build(w)
        attempts = (0, 1) if retry else (1,)
        with self._lock:
            for attempt in attempts:  # one reconnect on broken connection
                try:
                    sock = self._connect()
                    seq = next(self._seq)
                    _send_frame(sock, seq, KIND_REQUEST, method, w.bytes())
                    while True:
                        frame = _recv_frame(sock)
                        if frame is None:
                            raise ConnectionError("service closed connection")
                        rseq, kind, _, payload = frame
                        if rseq != seq:
                            continue  # stale response from a prior timeout
                        if kind == KIND_ERROR:
                            raise ServiceRemoteError(Reader(payload).text())
                        return Reader(payload)
                except (ConnectionError, OSError):
                    self.close()
                    if attempt:
                        raise
        raise ConnectionError("unreachable")

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None
