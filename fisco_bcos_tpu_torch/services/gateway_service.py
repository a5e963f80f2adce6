"""Gateway/front as a service: remote module dispatch for split processes.

Reference counterpart: Pro mode's gateway split (fisco-bcos-tars-service/
GatewayService/ + FrontService proxies): consensus/txpool/sync services
run in their own processes and reach the P2P plane through the gateway
service. The server side owns the real FrontService (and its gateway
sessions); `RemoteFront` duck-types the FrontService surface
(register_module/send/broadcast/peers) for a service process.

Push direction (network -> remote module) uses long-polling over the same
framed RPC: the proxy's reader thread parks a `poll` call server-side
until traffic arrives for that client's registered modules (or a timeout
passes), then dispatches to local handlers — the service-RPC analogue of
the Tars callback channel.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Optional

from ..codec.wire import Reader, Writer
from ..utils.log import LOG, badge
from .rpc import ServiceClient, ServiceServer

Handler = Callable[[bytes, bytes, Callable[[bytes], None]], None]
_POLL_WAIT = 2.0


class FrontServer:
    """Exposes a node's FrontService to remote service processes."""

    RESPOND_TTL = 60.0

    def __init__(self, front, host: str = "127.0.0.1", port: int = 0):
        self.front = front
        self.server = ServiceServer("front", host, port)
        self._lock = threading.Lock()
        # client_id -> inbox of (src, module, payload, respond_id)
        self._inboxes: dict[int, "queue.Queue"] = {}
        self._client_modules: dict[int, set[int]] = {}
        # parked respond callbacks for request-style deliveries
        self._responders: dict[int, tuple[Callable, float]] = {}
        self._ids = iter(range(1, 1 << 31))
        self._rids = iter(range(1, 1 << 62))
        s = self.server
        s.register("attach", self._attach)
        s.register("detach", self._detach)
        s.register("registerModule", self._register_module)
        s.register("poll", self._poll)
        s.register("respond", self._respond)
        s.register("send", self._send)
        s.register("broadcast", self._broadcast)
        s.register("peers", self._peers)

    @property
    def port(self) -> int:
        return self.server.port

    def start(self) -> None:
        self.server.start()

    def stop(self) -> None:
        self.server.stop()

    def _attach(self, r: Reader, w: Writer) -> None:
        with self._lock:
            cid = next(self._ids)
            self._inboxes[cid] = queue.Queue()
            self._client_modules[cid] = set()
        w.u32(cid)

    def _detach(self, r: Reader, w: Writer) -> None:
        cid = r.u32()
        with self._lock:
            self._inboxes.pop(cid, None)
            self._client_modules.pop(cid, None)
        w.u8(1)

    def _register_module(self, r: Reader, w: Writer) -> None:
        cid, module = r.u32(), r.u32()
        with self._lock:
            if cid not in self._client_modules:
                raise ValueError("unknown client; attach first")
            self._client_modules[cid].add(module)

        def handler(src: bytes, payload: bytes, respond) -> None:
            with self._lock:
                inbox = self._inboxes.get(cid)
                if inbox is None:
                    return  # client detached/crashed: drop, don't leak
                rid = 0
                if respond is not None:  # request: park the respond channel
                    rid = next(self._rids)
                    now = time.monotonic()
                    self._responders = {
                        k: v for k, v in self._responders.items()
                        if v[1] > now}
                    self._responders[rid] = (respond,
                                             now + self.RESPOND_TTL)
            inbox.put((src, module, payload, rid))

        self.front.register_module(module, handler)
        w.u8(1)

    def _poll(self, r: Reader, w: Writer) -> None:
        cid = r.u32()
        with self._lock:
            inbox = self._inboxes.get(cid)
        items = []
        if inbox is not None:
            try:  # park until traffic or timeout, then drain
                items.append(inbox.get(timeout=_POLL_WAIT))
                while len(items) < 256:
                    items.append(inbox.get_nowait())
            except queue.Empty:
                pass
        w.seq(items, lambda ww, it: ww.blob(it[0]).u32(it[1]).blob(it[2])
              .u64(it[3]))

    def _respond(self, r: Reader, w: Writer) -> None:
        rid, resp = r.u64(), r.blob()
        with self._lock:
            entry = self._responders.pop(rid, None)
        if entry is not None:
            entry[0](resp)
        w.u8(1 if entry is not None else 0)

    def _send(self, r: Reader, w: Writer) -> None:
        module, dst, payload = r.u32(), r.blob(), r.blob()
        w.u8(1 if self.front.send(module, dst, payload) else 0)

    def _broadcast(self, r: Reader, w: Writer) -> None:
        module, payload = r.u32(), r.blob()
        self.front.broadcast(module, payload)
        w.u8(1)

    def _peers(self, r: Reader, w: Writer) -> None:
        w.seq(self.front.peers(), lambda ww, p: ww.blob(p))


class RemoteFront:
    """FrontService proxy for a split-out service process."""

    def __init__(self, host: str, port: int, node_id: bytes = b"",
                 timeout: float = 30.0):
        self.node_id = node_id
        self.client = ServiceClient(host, port, timeout)
        self._poll_client = ServiceClient(host, port, timeout)
        self._handlers: dict[int, Handler] = {}
        self.cid = self.client.call("attach").u32()
        self._stopped = False
        self._thread: Optional[threading.Thread] = None

    def register_module(self, module: int, handler: Handler) -> None:
        self._handlers[int(module)] = handler
        self.client.call("registerModule",
                         lambda w: w.u32(self.cid).u32(int(module)))
        if self._thread is None:
            self._thread = threading.Thread(target=self._poll_loop,
                                            name="remote-front-poll",
                                            daemon=True)
            self._thread.start()

    def _poll_loop(self) -> None:
        while not self._stopped:
            try:
                r = self._poll_client.call("poll",
                                           lambda w: w.u32(self.cid))
                items = r.seq(lambda rr: (rr.blob(), rr.u32(), rr.blob(),
                                          rr.u64()))
            except Exception:
                if self._stopped:
                    return
                time.sleep(0.2)  # backoff: don't spin on a dead server
                continue
            for src, module, payload, rid in items:
                handler = self._handlers.get(module)
                if handler is None:
                    continue
                respond = None
                if rid:  # request: bridge the response back to the server
                    def respond(resp: bytes, _rid=rid) -> None:
                        self.client.call(
                            "respond",
                            lambda w: w.u64(_rid).blob(resp))
                try:
                    handler(src, payload, respond)
                except Exception:
                    # a raising module handler must not die silently:
                    # the poll loop keeps running for the other modules,
                    # so the failure is logged where an operator sees it
                    LOG.exception(badge("REMOTEFRONT", "handler-failed",
                                        module=module))

    def send(self, module: int, dst: bytes, payload: bytes) -> bool:
        r = self.client.call("send", lambda w: w.u32(int(module))
                             .blob(dst).blob(payload))
        return bool(r.u8())

    def broadcast(self, module: int, payload: bytes) -> None:
        self.client.call("broadcast",
                         lambda w: w.u32(int(module)).blob(payload))

    def peers(self) -> list[bytes]:
        return self.client.call("peers").seq(lambda rr: rr.blob())

    def stop(self) -> None:
        self._stopped = True
        try:
            self.client.call("detach", lambda w: w.u32(self.cid))
        except Exception:
            pass  # server gone: nothing to detach from
        self.client.close()
        self._poll_client.close()
