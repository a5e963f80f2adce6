"""WebSocket transport (RFC 6455) — server + client over stdlib sockets.

Reference counterpart: FISCO-BCOS bcos-boostssl/bcos-boostssl/websocket/
(WsService.h / WsSession.cpp / WsConnector) — the transport under the
reference's WS JSON-RPC, event-subscription push and AMOP client bridge.
Same thread-per-session shape as the framework's P2P plane (net/p2p.py):
an accept thread plus one reader thread per connection, writes serialised
by a per-connection lock.

Scope: the parts the access layer needs — HTTP Upgrade handshake, text/
binary frames with 16/64-bit extended lengths, client-side masking,
fragmented messages, ping/pong, clean close. No extensions (permessage-
deflate etc. are negotiated off).
"""

from __future__ import annotations

import base64
import hashlib
import os
import socket
import struct
import threading
from typing import Callable, Optional

from ..analysis import lockcheck as _lc
from ..utils.log import LOG, badge

_GUID = b"258EAFA5-E914-47DA-95CA-C5AB0DC85B11"
MAX_FRAME = 16 * 1024 * 1024

OP_CONT, OP_TEXT, OP_BINARY = 0x0, 0x1, 0x2
OP_CLOSE, OP_PING, OP_PONG = 0x8, 0x9, 0xA


class WsError(ConnectionError):
    pass


def _accept_key(key: str) -> str:
    digest = hashlib.sha1(key.encode() + _GUID).digest()
    return base64.b64encode(digest).decode()


def _xor_mask(payload: bytes, mk: bytes) -> bytes:
    """XOR the payload with the repeating 4-byte mask — as one big-int op
    rather than a per-byte Python loop (frames can be 16 MB)."""
    n = len(payload)
    if n == 0:
        return payload
    rep = (mk * ((n >> 2) + 1))[:n]
    return (int.from_bytes(payload, "little")
            ^ int.from_bytes(rep, "little")).to_bytes(n, "little")


class WsConnection:
    """One established WebSocket session (either side)."""

    def __init__(self, sock: socket.socket, mask_outgoing: bool,
                 peer: str = "", initial: bytes = b""):
        self.sock = sock
        self.mask = mask_outgoing  # clients MUST mask (RFC 6455 §5.3)
        self.peer = peer
        self.headers: dict = {}  # server side: the upgrade request's
        #                          headers (x-api-key admission identity)
        self._rbuf = initial  # bytes that arrived with the handshake
        self._wlock = threading.Lock()
        self._closed = False

    def _read_exact(self, n: int) -> bytes:
        while len(self._rbuf) < n:
            chunk = self.sock.recv(max(4096, n - len(self._rbuf)))
            if not chunk:
                raise WsError("connection closed mid-frame")
            self._rbuf += chunk
        out, self._rbuf = self._rbuf[:n], self._rbuf[n:]
        return out

    # -- sending -----------------------------------------------------------
    def _frame(self, op: int, payload: bytes) -> bytes:
        hdr = bytes([0x80 | op])
        mbit = 0x80 if self.mask else 0
        ln = len(payload)
        if ln < 126:
            hdr += bytes([mbit | ln])
        elif ln < 1 << 16:
            hdr += bytes([mbit | 126]) + struct.pack(">H", ln)
        else:
            hdr += bytes([mbit | 127]) + struct.pack(">Q", ln)
        if self.mask:
            mk = os.urandom(4)
            return hdr + mk + _xor_mask(payload, mk)
        return hdr + payload

    def _send_frame(self, op: int, payload: bytes) -> None:
        _lc.note_blocking("socket_send", "ws._send_frame")
        with self._wlock:
            if self._closed:
                raise WsError("connection closed")
            try:
                self.sock.sendall(self._frame(op, payload))
            except OSError as exc:
                self._closed = True
                raise WsError(f"send failed: {exc}") from exc

    def send_text(self, text: str) -> None:
        self._send_frame(OP_TEXT, text.encode())

    def send_binary(self, data: bytes) -> None:
        self._send_frame(OP_BINARY, data)

    # -- receiving ---------------------------------------------------------
    def _recv_frame(self) -> tuple[int, int, bytes]:
        b0, b1 = self._read_exact(2)
        fin, op = b0 & 0x80, b0 & 0x0F
        masked, ln = b1 & 0x80, b1 & 0x7F
        if ln == 126:
            (ln,) = struct.unpack(">H", self._read_exact(2))
        elif ln == 127:
            (ln,) = struct.unpack(">Q", self._read_exact(8))
        if ln > MAX_FRAME:
            raise WsError(f"frame too large: {ln}")
        mk = self._read_exact(4) if masked else None
        payload = self._read_exact(ln)
        if mk:
            payload = _xor_mask(payload, mk)
        return fin, op, payload

    def recv(self) -> Optional[tuple[int, bytes]]:
        """Next data message as (opcode, payload); None on close. Handles
        control frames and fragment reassembly internally."""
        op_acc, buf = None, b""
        while True:
            try:
                fin, op, payload = self._recv_frame()
            except (WsError, OSError):
                self._closed = True
                return None
            if op == OP_PING:
                try:
                    self._send_frame(OP_PONG, payload)
                except WsError:
                    return None
                continue
            if op == OP_PONG:
                continue
            if op == OP_CLOSE:
                try:
                    self._send_frame(OP_CLOSE, payload[:2])
                except WsError:
                    pass
                self._closed = True
                return None
            if op in (OP_TEXT, OP_BINARY):
                op_acc, buf = op, payload
            elif op == OP_CONT and op_acc is not None:
                buf += payload
                if len(buf) > MAX_FRAME:
                    raise WsError("message too large")
            else:
                raise WsError(f"unexpected opcode {op:#x}")
            if fin:
                return op_acc, buf

    def close(self) -> None:
        if not self._closed:
            try:
                self._send_frame(OP_CLOSE, struct.pack(">H", 1000))
            except WsError:
                pass
            self._closed = True
        try:
            self.sock.close()
        except OSError:
            pass


# ---------------------------------------------------------------------------
# server
# ---------------------------------------------------------------------------

def _server_handshake(sock: socket.socket) -> bytes:
    """-> leftover bytes that arrived coalesced after the request (the
    client's first frame may share a TCP segment with the Upgrade)."""
    data = b""
    while b"\r\n\r\n" not in data:
        chunk = sock.recv(4096)
        if not chunk:
            raise WsError("peer closed during handshake")
        data += chunk
        if len(data) > 65536:
            raise WsError("handshake too large")
    head_raw, leftover = data.split(b"\r\n\r\n", 1)
    head = head_raw.decode(errors="replace")
    lines = head.split("\r\n")
    headers = {}
    for line in lines[1:]:
        if ":" in line:
            k, v = line.split(":", 1)
            headers[k.strip().lower()] = v.strip()
    if headers.get("upgrade", "").lower() != "websocket" or \
            "sec-websocket-key" not in headers:
        sock.sendall(b"HTTP/1.1 400 Bad Request\r\n\r\n")
        raise WsError("not a websocket upgrade")
    accept = _accept_key(headers["sec-websocket-key"])
    sock.sendall(
        b"HTTP/1.1 101 Switching Protocols\r\n"
        b"Upgrade: websocket\r\nConnection: Upgrade\r\n"
        b"Sec-WebSocket-Accept: " + accept.encode() + b"\r\n\r\n")
    return leftover, headers


class WsServer:
    """Accept loop + per-connection reader threads.

    on_message(conn, opcode, payload) is called for each data message;
    on_open/on_close(conn) bracket the session.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 on_message: Callable = None,
                 on_open: Callable = None, on_close: Callable = None):
        self.on_message = on_message or (lambda *a: None)
        self.on_open = on_open or (lambda c: None)
        self.on_close = on_close or (lambda c: None)
        self._listener = socket.create_server((host, port))
        self.host, self.port = self._listener.getsockname()[:2]
        self._conns: set[WsConnection] = set()
        self._lock = threading.Lock()
        self._stopped = False
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self._accept_loop,
                                        name="ws-accept", daemon=True)
        self._thread.start()
        LOG.info(badge("WS", "listening", host=self.host, port=self.port))

    def _accept_loop(self) -> None:
        while not self._stopped:
            try:
                sock, addr = self._listener.accept()
            except OSError:
                return
            threading.Thread(target=self._serve, args=(sock, addr),
                             name=f"ws-{addr[1]}", daemon=True).start()

    def _serve(self, sock: socket.socket, addr) -> None:
        conn = None
        try:
            leftover, hs_headers = _server_handshake(sock)
            conn = WsConnection(sock, mask_outgoing=False,
                                peer=f"{addr[0]}:{addr[1]}",
                                initial=leftover)
            # retained for the serving layer: the upgrade request's
            # x-api-key is the client's admission identity (rpc/ws_server)
            conn.headers = hs_headers
            with self._lock:
                self._conns.add(conn)
            self.on_open(conn)
            while True:
                msg = conn.recv()
                if msg is None:
                    break
                self.on_message(conn, *msg)
        except WsError as exc:
            LOG.warning(badge("WS", "session-error", err=str(exc)))
        except Exception:
            LOG.exception(badge("WS", "handler-error"))
        finally:
            if conn is not None:
                with self._lock:
                    self._conns.discard(conn)
                try:
                    self.on_close(conn)
                except Exception:
                    LOG.exception(badge("WS", "on-close-error"))
                conn.close()
            else:
                try:
                    sock.close()
                except OSError:
                    pass

    def stop(self) -> None:
        self._stopped = True
        try:
            self._listener.close()
        except OSError:
            pass
        with self._lock:
            conns = list(self._conns)
        for c in conns:
            c.close()


# ---------------------------------------------------------------------------
# client
# ---------------------------------------------------------------------------

def ws_connect(host: str, port: int, path: str = "/",
               timeout: float = 10.0) -> WsConnection:
    sock = socket.create_connection((host, port), timeout=timeout)
    key = base64.b64encode(os.urandom(16)).decode()
    sock.sendall(
        f"GET {path} HTTP/1.1\r\nHost: {host}:{port}\r\n"
        f"Upgrade: websocket\r\nConnection: Upgrade\r\n"
        f"Sec-WebSocket-Key: {key}\r\n"
        f"Sec-WebSocket-Version: 13\r\n\r\n".encode())
    data = b""
    while b"\r\n\r\n" not in data:
        chunk = sock.recv(4096)
        if not chunk:
            raise WsError("server closed during handshake")
        data += chunk
    head_raw, leftover = data.split(b"\r\n\r\n", 1)
    head = head_raw.decode(errors="replace")
    if "101" not in head.split("\r\n")[0]:
        raise WsError(f"handshake rejected: {head.splitlines()[0]}")
    expected = _accept_key(key)
    for line in head.split("\r\n")[1:]:
        if line.lower().startswith("sec-websocket-accept:"):
            if line.split(":", 1)[1].strip() != expected:
                raise WsError("bad Sec-WebSocket-Accept")
            break
    else:
        raise WsError("missing Sec-WebSocket-Accept")
    sock.settimeout(None)
    return WsConnection(sock, mask_outgoing=True, peer=f"{host}:{port}",
                        initial=leftover)
