"""SDK over WebSocket: JSON-RPC, event-subscription push, AMOP client.

Reference counterpart: FISCO-BCOS bcos-sdk/bcos-cpp-sdk/ — the C++ SDK
attaches to a node over the boostssl WS service for RPC
(jsonrpc/JsonRpcImpl.cpp), event subscription (event/EventSub.cpp) and AMOP
(amop/AMOP.cpp). `WsSdkClient` mirrors `SdkClient`'s method surface (it
reuses its `_grouped` helpers by overriding `request`) and adds the push
channels a stateless HTTP client cannot have.
"""

from __future__ import annotations

import json
import queue
import threading
import time
from typing import Callable, Optional

from ..net.websocket import OP_TEXT, WsError, ws_connect
from ..utils.log import LOG, badge
from .client import RpcCallError, SdkClient

# event callback: (push: dict) -> None        (eventPush object, see server)
# topic callback: (topic: str, data: bytes) -> bytes | None   (reply)


class WsSdkClient(SdkClient):
    def __init__(self, host: str, port: int, group: str = "group0",
                 timeout: float = 10.0):
        # note: no HTTP url — we bypass SdkClient's transport entirely
        super().__init__(url=f"ws://{host}:{port}", group=group)
        self.timeout = timeout
        self._host, self._port = host, port
        self.conn = ws_connect(host, port, timeout=timeout)
        self._lock = threading.Lock()
        self._waiting: dict[int, tuple[threading.Event, list]] = {}
        self._event_handlers: dict[str, Callable] = {}
        self._orphan_pushes: dict[str, list] = {}  # pushes preceding the id
        self._topic_handlers: dict[str, Callable] = {}
        # push-plane subscription state (SubHub): sub_id -> (kind, options)
        # so a socket reset can resubscribe; _sub_alias maps the id the
        # CALLER holds to the live id after a reconnect re-registered it
        self._subs: dict[str, tuple] = {}
        self._sub_alias: dict[str, str] = {}
        self._events: "queue.Queue[dict]" = queue.Queue(maxsize=4096)
        self._down = False  # socket lost, reconnect in progress
        self._closed = False
        self._reader = threading.Thread(target=self._read_loop,
                                        name="sdk-ws-reader", daemon=True)
        # reader starts as the ctor's FINAL statement (every field the
        # loop touches is assigned above): the SDK contract is that a
        # constructed client is already receiving pushes — a server event
        # arriving between construction and a separate start() would be
        # dropped on the floor
        self._reader.start()  # bcoslint: disable=thread-start-in-ctor

    # -- transport ---------------------------------------------------------
    def request(self, method: str, params: list):
        rid = next(self._seq)  # SdkClient's request-id counter
        ev = threading.Event()
        out: list = []
        with self._lock:
            if self._closed or self._down:
                raise RpcCallError(-32000, "ws connection closed")
            self._waiting[rid] = (ev, out)
        self.conn.send_text(json.dumps({
            "jsonrpc": "2.0", "id": rid, "method": method,
            "params": params}))
        if not ev.wait(self.timeout):
            with self._lock:
                self._waiting.pop(rid, None)
            raise RpcCallError(-32000, f"ws request timeout: {method}")
        resp = out[0]
        if "error" in resp:
            raise RpcCallError(resp["error"].get("code", -1),
                               resp["error"].get("message", ""))
        return resp.get("result")

    def _read_loop(self) -> None:
        while True:
            self._pump()
            # socket is gone: fail in-flight waiters NOW (they must not
            # burn their timeout), then — unless close() was deliberate —
            # reconnect and resubscribe the push-plane streams
            with self._lock:
                self._down = True
                waiting = list(self._waiting.values())
                self._waiting.clear()
            for ev, out in waiting:
                out.append({"error": {"code": -32000,
                                      "message": "ws connection closed"}})
                ev.set()
            if self._closed or not self._reconnect():
                with self._lock:
                    self._closed = True
                return

    def _pump(self) -> None:
        while not self._closed:
            try:
                msg = self.conn.recv()
            except (WsError, OSError):
                return
            if msg is None:
                return
            op, payload = msg
            if op != OP_TEXT:
                continue
            try:
                obj = json.loads(payload)
                self._route(obj)
            except Exception:
                # one bad message must not kill the client, but a
                # push-callback bug repeating on every frame must not
                # be invisible either (bcoslint
                # swallowed-worker-exception finding)
                LOG.exception(badge("SDKWS", "message-dropped"))
                continue

    def _reconnect(self) -> bool:
        for delay in (0.05, 0.2, 0.5, 1.0, 2.0):
            if self._closed:
                return False
            try:
                self.conn = ws_connect(self._host, self._port,
                                       timeout=self.timeout)
            except Exception:
                time.sleep(delay)
                continue
            with self._lock:
                self._down = False
                subs = list(self._subs.items())
            if subs:
                # NOT inline: resubscribing uses request(), whose
                # responses only the reader (this thread) can deliver —
                # it must be back in _pump before they arrive
                threading.Thread(target=self._resubscribe, args=(subs,),
                                 name="sdk-ws-resub", daemon=True).start()
            LOG.info(badge("SDKWS", "reconnected", resubs=len(subs)))
            return True
        return False

    def _resubscribe(self, subs: list) -> None:
        for old_id, (kind, options) in subs:
            try:
                new_id = self.request(
                    "subscribe", [kind, options] if options else [kind])
            except Exception:
                LOG.warning(badge("SDKWS", "resubscribe-failed",
                                  kind=kind, sub=old_id))
                continue
            with self._lock:
                self._subs.pop(old_id, None)
                self._subs[new_id] = (kind, options)
                # the caller still holds old_id: route unsubscribes
                for held, live in list(self._sub_alias.items()):
                    if live == old_id:
                        self._sub_alias[held] = new_id
                self._sub_alias[old_id] = new_id

    def _route(self, obj: dict) -> None:
        if "id" in obj and obj.get("type") is None:
            with self._lock:
                entry = self._waiting.pop(obj["id"], None)
            if entry:
                entry[1].append(obj)
                entry[0].set()
        elif obj.get("type") == "eventPush":
            tid = obj.get("taskId", "")
            with self._lock:
                cb = self._event_handlers.get(tid)
                if cb is None:  # push raced ahead of the subscribe response
                    buf = self._orphan_pushes.setdefault(tid, [])
                    if len(buf) < 1000:
                        buf.append(obj)
                    return
            try:
                cb(obj)
            except Exception:
                pass
        elif obj.get("method") == "subscription":
            # push-plane notification (SubHub fan-out): params =
            # {"subscription", "kind", "result"} — queue for next_event()
            try:
                self._events.put_nowait(obj.get("params") or {})
            except queue.Full:
                pass  # local consumer too slow: shed (live stream)
        elif obj.get("type") == "amopPush":
            # off the reader thread: a topic handler may itself issue
            # request()s, whose responses only this reader can deliver
            threading.Thread(target=self._on_amop_push, args=(obj,),
                             name="sdk-ws-amop", daemon=True).start()

    def _on_amop_push(self, obj: dict) -> None:
        cb = self._topic_handlers.get(obj.get("topic", ""))
        if cb is None:
            return
        try:
            data = bytes.fromhex(str(obj.get("data", "")).removeprefix("0x"))
        except ValueError:
            return  # corrupt push: let the publisher time out, don't
            # hand the handler a payload it never received
        try:
            reply = cb(obj["topic"], data)
        except Exception:
            reply = None
        try:
            self.conn.send_text(json.dumps({
                "type": "amopResp", "seq": obj.get("seq"),
                "data": "0x" + (reply or b"").hex()}))
        except Exception:
            pass  # connection raced shut; the publisher times out

    # -- push-plane subscriptions (SubHub) ---------------------------------
    def subscribe(self, kind: str, options: Optional[dict] = None) -> str:
        """Open a push stream: kind is one of newBlockHeaders / logs
        ({addresses, topics} filter) / pendingTransactions / receipt
        ({txHash} — one-shot). Events arrive via `next_event()`. The
        stream survives a socket reset: the client reconnects and
        resubscribes, and the returned id keeps working for
        `unsubscribe()` (a receipt stream may replay its completion
        after a reset — consumers should treat events as at-least-once)."""
        sub_id = self.request("subscribe",
                              [kind, options] if options else [kind])
        with self._lock:
            self._subs[sub_id] = (kind, options)
        return sub_id

    def unsubscribe(self, sub_id: str) -> bool:
        with self._lock:
            live = self._sub_alias.pop(sub_id, sub_id)
            self._subs.pop(live, None)
        try:
            return bool(self.request("unsubscribe", [live]))
        except RpcCallError:
            return False  # already completed (one-shot) or session reset

    def next_event(self, timeout: Optional[float] = None) -> Optional[dict]:
        """Next queued push notification ({"subscription", "kind",
        "result"}), or None after `timeout` seconds (None = block)."""
        try:
            return self._events.get(timeout=timeout)
        except queue.Empty:
            return None

    # -- push channels -----------------------------------------------------
    def subscribe_event(self, flt: dict, cb: Callable) -> str:
        """flt: {fromBlock, toBlock, addresses, topics} (hex strings)."""
        task_id = self.request("subscribeEvent", [self.group, flt])
        with self._lock:  # linearise vs the reader's orphan buffering
            self._event_handlers[task_id] = cb
            orphans = self._orphan_pushes.pop(task_id, [])
        for obj in orphans:
            try:
                cb(obj)
            except Exception:
                pass
        return task_id

    def unsubscribe_event(self, task_id: str) -> bool:
        self._event_handlers.pop(task_id, None)
        return bool(self.request("unsubscribeEvent", [self.group, task_id]))

    def subscribe_topic(self, topic: str, cb: Callable) -> None:
        self._topic_handlers[topic] = cb
        self.request("subscribeTopic", [topic])

    def unsubscribe_topic(self, topic: str) -> None:
        self._topic_handlers.pop(topic, None)
        self.request("unsubscribeTopic", [topic])

    def publish_topic(self, topic: str, data: bytes) -> Optional[bytes]:
        r = self.request("publishTopic", [topic, "0x" + data.hex()])
        return None if r is None else bytes.fromhex(r.removeprefix("0x"))

    def broadcast_topic(self, topic: str, data: bytes) -> int:
        return int(self.request("broadcastTopic",
                                [topic, "0x" + data.hex()]))

    def close(self) -> None:
        self._closed = True
        self.conn.close()
