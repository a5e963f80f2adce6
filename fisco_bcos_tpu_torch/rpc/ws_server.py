"""WebSocket access layer: JSON-RPC + event-subscription push + AMOP bridge.

Reference counterpart: the reference serves the same JSON-RPC surface over
WS as over HTTP (bcos-rpc/bcos-rpc/jsonrpc over boostssl WsService), pushes
event-subscription matches to WS sessions
(FISCO-BCOS bcos-rpc/bcos-rpc/event/EventSub.cpp), and bridges SDK
AMOP clients into the gateway's topic plane
(FISCO-BCOS bcos-rpc/bcos-rpc/amop/AirAMOPClient.h).

Message protocol (JSON text frames):
  * Anything with "method" is a JSON-RPC 2.0 request; the response carries
    the same id. The full HTTP surface (JsonRpcImpl) is available, plus WS-
    only methods:
      subscribeEvent   [group, {fromBlock,toBlock,addresses,topics}] -> task
      unsubscribeEvent [group, taskId]
      subscribe        [kind, options?] -> subId   (push plane: SubHub)
      unsubscribe      [subId]
      subscribeTopic   [topic, ...]        (AMOP; this session serves them)
      unsubscribeTopic [topic, ...]
      publishTopic     [topic, hexData]    -> responder's hex reply
      broadcastTopic   [topic, hexData]    -> peer count
  * Server pushes (no id):
      {"type": "eventPush", "taskId", "blockNumber", "txHash", "logIndex",
       "log": {address, topics, data}}
      {"jsonrpc": "2.0", "method": "subscription",
       "params": {"subscription": subId, "kind", "result": fragment}}
      {"type": "amopPush", "seq", "topic", "data": hex}
  * Client reply to an amopPush (the publish round trip):
      {"type": "amopResp", "seq", "data": hex}

Delivery substrate: every server push rides the bounded per-session
outbox (droppable/lossless classes, O(1) eviction, no blocking send
while a lock is held). At subscriber scale the per-session writer
threads are replaced by ONE selectors-based `FanoutWriter`: non-blocking
`MSG_DONTWAIT` sends, `EVENT_WRITE` parking on full TCP windows, so 10k
subscribers cost 0 extra threads on the push side and one stuck window
never delays another session's drain.
"""

from __future__ import annotations

import itertools
import json
import selectors
import socket
import threading
import time
from collections import deque
from typing import Optional

from ..net.websocket import OP_TEXT, WsConnection, WsServer
from ..rpc.eventsub import (EventFilter, JSONRPC_SUB_LIMIT, SUB_KINDS,
                            SubLimitError)
from ..utils.log import LOG, badge
from .server import (JsonRpcImpl, JsonRpcError, JSONRPC_INVALID_PARAMS,
                     encode_jsonrpc)

_AMOP_REPLY_TIMEOUT = 5.0


def _parse_event_filter(f: dict) -> EventFilter:
    """{fromBlock,toBlock,addresses,topics} wire dict -> EventFilter
    (shared by subscribeEvent and the push plane's logs options)."""
    addresses = ({bytes.fromhex(a.removeprefix("0x"))
                  for a in f["addresses"]}
                 if f.get("addresses") else None)
    topics = [None if t is None
              else {bytes.fromhex(x.removeprefix("0x")) for x in t}
              for t in f.get("topics", [])]
    return EventFilter(from_block=int(f.get("fromBlock", 0)),
                       to_block=int(f.get("toBlock", -1)),
                       addresses=addresses, topics=topics)


class FanoutWriter:
    """ONE selectors-based writer thread draining every session's push
    outbox: `sock.send(..., MSG_DONTWAIT)` under a non-blocking grab of
    the connection's `_wlock`; a full TCP window parks THAT socket on
    `EVENT_WRITE` (partial frame kept in `sess._wip`) while every other
    session keeps draining. Replaces the thread-per-session push writers
    so 10k subscribers cost zero extra threads on the push side.

    Lock order: conn._wlock -> sess._push_cv (same as _Session.send_now);
    `push()` takes only the cv, so enqueue never waits on a socket."""

    def __init__(self):
        self._sel = selectors.DefaultSelector()
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._wake_w.setblocking(False)
        self._sel.register(self._wake_r, selectors.EVENT_READ, None)
        self._lock = threading.Lock()
        self._pending: set = set()
        self._thread: Optional[threading.Thread] = None
        self._stopped = False
        # by-class drop accounting for getSystemStatus (the unlabeled
        # bcos_ws_push_dropped_total counter is kept by _Session.push)
        self.drops = {"droppable": 0, "lossless_kill": 0}

    def start(self) -> None:
        if self._thread is None:
            self._stopped = False
            self._thread = threading.Thread(target=self._loop,
                                            name="ws-fanout", daemon=True)
            self._thread.start()

    def stop(self) -> None:
        self._stopped = True
        self._wakeup()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None

    def _wakeup(self) -> None:
        try:
            self._wake_w.send(b"x")
        except OSError:
            pass

    def kick(self, sess) -> None:
        """A session's outbox went (or may have gone) non-empty."""
        with self._lock:
            if sess in self._pending:
                return  # already queued for service: no wake needed
            self._pending.add(sess)
        self._wakeup()

    def forget(self, sess) -> None:
        with self._lock:
            self._pending.discard(sess)

    # -- writer loop -------------------------------------------------------
    def _loop(self) -> None:
        while not self._stopped:
            with self._lock:
                busy = bool(self._pending)
            try:
                # short poll while wlock-contended sessions wait for a
                # retry; long poll when everything is drained or parked
                events = self._sel.select(timeout=0.002 if busy else 0.5)
            except OSError:
                events = []
            for key, _mask in events:
                if key.data is None:  # wake pipe
                    try:
                        while self._wake_r.recv(4096):
                            pass
                    # wake-pipe drained dry (EAGAIN) — the expected exit
                    except (BlockingIOError, OSError):  # bcoslint: disable=swallowed-worker-exception
                        pass
                    continue
                try:  # writable again: back into the service batch
                    self._sel.unregister(key.fileobj)
                # raced _kill/forget: already unregistered or closed
                except (KeyError, ValueError, OSError):  # bcoslint: disable=swallowed-worker-exception
                    pass
                with self._lock:
                    self._pending.add(key.data)
            if self._stopped:
                return
            with self._lock:
                batch, self._pending = self._pending, set()
            retry = set()
            for sess in batch:
                try:
                    state = self._service(sess)
                except Exception:  # noqa: BLE001 — one session never
                    self._kill(sess)  # takes down the whole fan-out
                    state = "idle"
                if state == "retry":
                    retry.add(sess)
            if retry:
                with self._lock:
                    self._pending |= retry

    def _service(self, sess) -> str:
        """Drain one session as far as the socket allows. -> 'idle'
        (nothing left), 'retry' (_wlock contended — a send_now response
        is in flight), 'wait' (TCP window full: parked on EVENT_WRITE)."""
        conn = sess.conn
        wl = getattr(conn, "_wlock", None)
        if wl is None:  # fake/legacy conn: writer-less sessions drain
            return "idle"  # via their own thread, never land here
        if not wl.acquire(blocking=False):
            return "retry"
        try:
            while True:
                if sess._push_dead:
                    return "idle"
                wip = sess._wip
                if wip is not None:
                    try:
                        n = conn.sock.send(wip, socket.MSG_DONTWAIT)
                    except (BlockingIOError, InterruptedError):
                        return self._wait_writable(sess)
                    except OSError:
                        self._kill(sess)
                        return "idle"
                    if n < len(wip):
                        sess._wip = wip[n:]
                        return self._wait_writable(sess)
                    t0 = sess._wip_t0
                    sess._wip = None
                    sess._wip_t0 = None
                    if t0 is not None and sess.latency_cb is not None:
                        try:  # commit-dequeue -> last byte accepted
                            sess.latency_cb(time.perf_counter() - t0)
                        except Exception:  # noqa: BLE001
                            pass
                    continue
                with sess._push_cv:
                    cell = None
                    while sess._outbox:
                        c = sess._outbox.popleft()
                        if c[2]:
                            continue  # evicted while queued
                        c[2] = True  # consumed: eviction must skip it
                        sess._live -= 1
                        sess._bytes -= len(c[0])
                        cell = c
                        break
                    if cell is None:
                        return "idle"
                payload = cell[0]
                if not isinstance(payload, bytes):
                    payload = payload.encode()
                sess._wip = memoryview(conn._frame(OP_TEXT, payload))
                sess._wip_t0 = cell[3]
        finally:
            wl.release()

    def _wait_writable(self, sess) -> str:
        try:
            self._sel.register(sess.conn.sock, selectors.EVENT_WRITE, sess)
        except KeyError:
            pass  # already registered
        except Exception:  # noqa: BLE001 — closed/bogus fd
            self._kill(sess)
        return "wait"

    def _kill(self, sess) -> None:
        sess.close_push()
        try:
            self._sel.unregister(sess.conn.sock)
        except Exception:  # noqa: BLE001
            pass
        try:
            sess.conn.sock.close()
        except Exception:  # noqa: BLE001
            pass


class _Session:
    """Per-connection subscription state + bounded push outbox.

    `push()` ENQUEUES; a per-session writer thread drains onto the
    socket. The synchronous shape (`push -> sendall`) was a real
    blocking-while-locked finding: event pushes run on the scheduler's
    commit-NOTIFIER thread while holding the eventsub task lock, so one
    subscriber with a full TCP window stalled commit notification for
    every observer on the node (caught by the armed lockcheck plane —
    `socket_send under eventsub.task`, see analysis/lockcheck.py).
    Overflow drops the OLDEST queued push (pushes are best-effort
    deliveries; a reader this far behind has already lost the stream)
    and a dead socket ends the writer. Same discipline as the p2p
    session's bounded writer queue."""

    MAX_OUTBOX = 4096  # queued push frames per session

    def __init__(self, conn: WsConnection, writer: Optional[FanoutWriter]
                 = None, outbox_bytes: int = 1 << 20):
        self.conn = conn
        # shared fan-out writer (one thread for all sessions). None keeps
        # the per-session lazy writer thread — tests and embedded use.
        self.fanout = writer
        self.outbox_bytes = max(1, int(outbox_bytes))
        self.event_tasks: set[str] = set()
        self.sub_ids: set[str] = set()  # push-plane (SubHub) streams
        self.topics: set[str] = set()
        self.pending: dict[int, tuple[threading.Event, list]] = {}
        # outbox entries are shared mutable [payload, lossless, dead, t0]
        # cells held by BOTH deques (the p2p _Session lazy-deletion
        # discipline): eviction marks a cell dead in O(1) and the writer
        # skips it, so overflow handling never does deque surgery under
        # the cv on the commit-notifier thread. _live counts cells not
        # yet consumed or evicted (len(_outbox) would overcount dead
        # cells); _bytes bounds queued payload bytes ([rpc] sub_outbox_kb).
        self._outbox: "deque[list]" = deque()
        self._droppable: "deque[list]" = deque()  # live-push cells only
        self._live = 0
        self._bytes = 0
        self._push_cv = threading.Condition()
        self._push_dead = False
        self._writer: Optional[threading.Thread] = None
        # FanoutWriter partial-frame state (guarded by conn._wlock)
        self._wip: Optional[memoryview] = None
        self._wip_t0: Optional[float] = None
        self.latency_cb = None  # SubHub.note_latency when subs exist

    def send_now(self, obj) -> bool:
        """SYNCHRONOUS, lossless send — JSON-RPC responses and AMOP
        round-trip frames. These are admitted work a client is waiting
        on: they must never ride the drop-oldest outbox (a dropped
        sendTransaction response would orphan a COMMITTED tx), and an
        immediate False on a dead socket is what lets the AMOP publisher
        fail over to the next responder instead of burning its 5 s
        timeout. Callers run on worker-pool/dispatch threads (bounded),
        exactly as before the outbox existed.

        Encodes via `encode_jsonrpc`: a RawResult result splices its
        cached fragment bytes (buffer join) instead of re-dumps-ing.
        When the session has a push backlog or a partial frame in flight
        the response is ENQUEUED lossless instead (checked under
        conn._wlock then _push_cv — the FanoutWriter's lock order), so
        frames never interleave and ordering against queued pushes
        holds."""
        payload = encode_jsonrpc(obj)
        conn = self.conn
        wl = getattr(conn, "_wlock", None)
        frame = getattr(conn, "_frame", None)
        if wl is None or frame is None:
            # fake/legacy conns (tests): the old direct path
            try:
                conn.send_text(payload.decode())
                return True
            except Exception:
                return False
        kill = False
        enqueued = False
        try:
            with wl:
                with self._push_cv:
                    if self._push_dead:
                        return False
                    if self._live > 0 or self._wip is not None:
                        # backlogged: ride the outbox (lossless — a
                        # response must never be gapped) to keep frame
                        # atomicity against the fan-out writer
                        _, kill = self._enqueue_locked(payload, True, None)
                        enqueued = not kill
                        if enqueued:
                            self._push_cv.notify()
                if kill:
                    self._die()
                    return False
                if not enqueued:
                    if getattr(conn, "_closed", False):
                        return False
                    conn.sock.sendall(frame(OP_TEXT, payload))
            if enqueued and self.fanout is not None:
                self.fanout.kick(self)
            return True
        except Exception:
            return False

    def push(self, obj, lossless: bool = False, t0=None) -> bool:
        """Queue a server push (dict, or pre-rendered frame bytes from
        the SubHub fan-out). Never blocks on the subscriber's socket —
        event pushes are emitted on the scheduler's commit-NOTIFIER
        thread under the eventsub task lock, the blocking-while-locked
        finding this outbox exists to fix.

        LIVE pushes (default) are best-effort: overflow (frame count OR
        queued bytes) drops the OLDEST droppable frame (a reader this
        far behind has already lost the stream; counted in
        bcos_ws_push_dropped_total). `lossless=True` marks frames that
        carry a contract — the subscribeEvent history replay a client
        EXPLICITLY requested, per-hash receipt completions, queued RPC
        responses — which are never silently gapped: if overflow finds
        nothing droppable, the session is closed instead, so the client
        sees a disconnect it can retry rather than an invisible hole.
        One FIFO queue keeps replay/live/response ordering. `t0` is the
        commit-dequeue stamp the writer turns into notify latency.
        Returns False once the session is dead."""
        payload = obj if isinstance(obj, (bytes, bytearray)) \
            else json.dumps(obj)
        with self._push_cv:
            if self._push_dead:
                return False
            if self.fanout is None and self._writer is None:
                self._writer = threading.Thread(  # lazy: request-only
                    target=self._push_loop, name="ws-push",  # sessions
                    daemon=True)  # never pay a thread
                self._writer.start()
            dropped, kill = self._enqueue_locked(payload, lossless, t0)
            if not kill:
                self._push_cv.notify()
        if dropped:  # metrics outside the cv: REGISTRY has its own lock
            from ..utils.metrics import REGISTRY
            REGISTRY.inc("bcos_ws_push_dropped_total", dropped)
            REGISTRY.inc("bcos_sub_outbox_drop_total", dropped,
                         labels={"class": "droppable"})
            if self.fanout is not None:
                self.fanout.drops["droppable"] += dropped
        if kill:
            self._die()
            return False
        if self.fanout is not None:
            self.fanout.kick(self)
        return True

    def _enqueue_locked(self, payload, lossless: bool, t0):
        """_push_cv held. Applies the overflow policy and enqueues.
        -> (dropped_count, kill)."""
        size = len(payload)
        if not lossless and size > self.outbox_bytes:
            # a single droppable frame larger than the whole outbox can
            # never fit: shed IT, don't kill the session
            return 1, False
        # drain dead heads (consumed/evicted cells) — amortized O(1)
        while self._droppable and self._droppable[0][2]:
            self._droppable.popleft()
        dropped = 0
        while (self._live >= self.MAX_OUTBOX
               or self._bytes + size > self.outbox_bytes):
            if not self._droppable:
                # nothing droppable left: a client too slow for frames
                # it was promised
                self._push_dead = True
                self._outbox.clear()
                self._droppable.clear()
                self._live = 0
                self._bytes = 0
                self._push_cv.notify_all()
                return dropped, True
            cell = self._droppable.popleft()
            if cell[2]:
                continue
            cell[2] = True  # writer skips it; O(1), no surgery
            self._bytes -= len(cell[0])
            cell[0] = b""
            self._live -= 1
            dropped += 1
        cell = [payload, lossless, False, t0]
        self._outbox.append(cell)
        if not lossless:
            self._droppable.append(cell)
        self._live += 1
        self._bytes += size
        return dropped, False

    def _die(self) -> None:
        """Lossless overflow: kill the session so the client sees a
        disconnect it can retry rather than a silent gap."""
        from ..utils.metrics import REGISTRY
        REGISTRY.inc("bcos_sub_outbox_drop_total",
                     labels={"class": "lossless_kill"})
        if self.fanout is not None:
            self.fanout.drops["lossless_kill"] += 1
        LOG.warning(badge("WSRPC", "push-backlog-overflow",
                          peer=self.conn.peer))
        try:
            # RAW socket close, NOT the graceful CLOSE-frame handshake:
            # conn.close() sends a frame under _wlock, which the parked
            # writer may hold — a blocking close here would put the
            # commit-notifier thread right back in the stall this
            # outbox exists to prevent. The reader thread sees EOF and
            # drives _on_close cleanup.
            self.conn.sock.close()
        except Exception:
            pass

    def _push_loop(self) -> None:
        while True:
            with self._push_cv:
                while not self._outbox and not self._push_dead:
                    self._push_cv.wait()
                if self._push_dead:
                    return
                cell = self._outbox.popleft()
                if cell[2]:
                    continue  # evicted while queued: nothing to send
                cell[2] = True  # consumed: eviction must skip it now
                payload = cell[0]
                self._live -= 1
                self._bytes -= len(payload)
            try:
                self.conn.send_text(
                    payload.decode() if isinstance(payload, bytes)
                    else payload)
            except Exception:
                with self._push_cv:
                    self._push_dead = True
                    self._outbox.clear()
                    self._droppable.clear()
                    self._live = 0
                    self._bytes = 0
                return

    def close_push(self) -> None:
        with self._push_cv:
            self._push_dead = True
            self._outbox.clear()
            self._droppable.clear()
            self._live = 0
            self._bytes = 0
            self._push_cv.notify_all()


class WsRpcServer:
    """`impl` is a JsonRpcImpl OR the multi-group `GroupedJsonRpc` facade
    (init/group.py): both expose `handle_payload` for the JSON-RPC surface
    — group-routed requests answer with the same error objects as HTTP —
    and `.node` for the WS-only planes (eventsub/AMOP bind to the default
    group in multi-group mode)."""

    def __init__(self, impl: JsonRpcImpl, host: str = "127.0.0.1",
                 port: int = 0, pool=None, admission=None, subhub=None,
                 outbox_kb: int = 1024):
        self.impl = impl
        self.node = impl.node
        # push-based subscription plane (rpc/eventsub.SubHub): commit-time
        # fan-out of primed fragment bytes; None = plane disabled
        self.subhub = subhub if subhub is not None \
            else getattr(impl.node, "subhub", None)
        self._outbox_bytes = max(1, int(outbox_kb)) << 10
        self._fanout = FanoutWriter()
        # per-client admission (rpc/admission.ClientAdmission), shared
        # with the HTTP edge: WS traffic must not be the unmetered side
        # door around the token buckets/fair share. Keyed by peer address
        # (the WS handshake carries no retained x-api-key), so a client's
        # HTTP and WS traffic draw from ONE budget.
        self.admission = admission
        # bounded dispatch offload, shared with the HTTP edge when the
        # node wires one (init/node.py): method calls can block (receipt
        # waits, AMOP round trips), so they never run on the reader
        # thread — but neither does every message get its own OS thread
        self.pool = pool
        # fallback-thread cap: when the shared pool is saturated (or
        # absent) a bounded number of one-off threads keeps WS sessions
        # from deadlocking behind HTTP load — but beyond it this
        # transport sheds like HTTP does, or a frame-spamming client
        # turns pool saturation into unbounded OS threads parked in
        # 30 s receipt waits
        self._fallback = threading.BoundedSemaphore(
            max(4, pool.workers if pool is not None else 4))
        self._seq = itertools.count(1)
        self._lock = threading.Lock()
        self._sessions: dict[WsConnection, _Session] = {}
        # AMOP: topic -> sessions serving it (first healthy one answers)
        self._topic_sessions: dict[str, list[_Session]] = {}
        self._ws = WsServer(host, port, on_message=self._on_message,
                            on_open=self._on_open, on_close=self._on_close)
        self.host, self.port = self._ws.host, self._ws.port

    def start(self) -> None:
        self._fanout.start()  # before sessions: pushes need the drain
        self._ws.start()

    def stop(self) -> None:
        self._ws.stop()
        self._fanout.stop()

    def push_drop_stats(self) -> dict:
        """Outbox drops by class (getSystemStatus `subscriptions`)."""
        d = self._fanout.drops
        return {"droppable": d["droppable"],
                "losslessKills": d["lossless_kill"]}

    # -- session lifecycle -------------------------------------------------
    def _on_open(self, conn: WsConnection) -> None:
        sess = _Session(conn, writer=self._fanout,
                        outbox_bytes=self._outbox_bytes)
        if self.subhub is not None:
            sess.latency_cb = self.subhub.note_latency
        with self._lock:
            self._sessions[conn] = sess

    def _on_close(self, conn: WsConnection) -> None:
        with self._lock:
            sess = self._sessions.pop(conn, None)
        if sess is None:
            return
        sess.close_push()
        self._fanout.forget(sess)
        if self.subhub is not None:
            self.subhub.unsubscribe_owner(sess)
        # copies: a concurrent subscribe dispatch may still add entries (it
        # re-checks session liveness afterwards and cleans up its own)
        for task_id in list(sess.event_tasks):
            self.node.eventsub.unsubscribe(task_id)
        for topic in list(sess.topics):
            self._drop_topic(sess, topic)

    def _drop_topic(self, sess: _Session, topic: str) -> None:
        with self._lock:
            lst = self._topic_sessions.get(topic, [])
            if sess in lst:
                lst.remove(sess)
            if not lst:
                self._topic_sessions.pop(topic, None)
                if self.node.amop is not None:
                    self.node.amop.unsubscribe(topic)

    # -- ingress -----------------------------------------------------------
    def _on_message(self, conn: WsConnection, op: int, payload: bytes
                    ) -> None:
        if op != OP_TEXT:
            return
        with self._lock:
            sess = self._sessions.get(conn)
        if sess is None:
            return
        try:
            msg = json.loads(payload)
        except Exception:
            sess.send_now({"jsonrpc": "2.0", "id": None,
                       "error": {"code": -32700, "message": "parse error"}})
            return
        if isinstance(msg, list):
            # JSON-RPC 2.0 batch over WS: same framing as HTTP
            # (handle_payload — per-id errors, notifications omitted,
            # order preserved); WS-only methods are not batchable
            ok, lease = self._try_admit(sess, msg, payload)
            if ok:
                self._offload(self._dispatch_batch, sess, msg, lease)
            return
        if not isinstance(msg, dict):
            sess.send_now({"jsonrpc": "2.0", "id": None,
                       "error": {"code": -32600,
                                 "message": "invalid request"}})
            return
        if msg.get("type") == "amopResp":
            self._on_amop_resp(sess, msg)  # non-blocking: stays inline
            return
        if "method" not in msg:
            if "id" in msg:  # a notification-shaped frame stays silent
                sess.send_now({"jsonrpc": "2.0", "id": msg["id"],
                           "error": {"code": -32600,
                                     "message": "invalid request"}})
            return
        # dispatch off the reader thread: methods can block (sendTransaction
        # waits for a receipt; publishTopic waits for an amopResp that this
        # very reader thread must deliver — inline handling would deadlock a
        # session publishing to a topic it also serves)
        ok, lease = self._try_admit(sess, msg, payload)
        if ok:
            self._offload(self._dispatch, sess, msg, lease)

    def _try_admit(self, sess: _Session, msg, payload: bytes):
        """Admission check on the reader thread (cheap: a dict lookup).
        -> (admitted, lease_key). Rejections answer -32005 with the
        retryAfterMs hint per id; notifications shed silently."""
        if self.admission is None:
            return True, None
        from .admission import admit_payload

        # identity: the upgrade request's x-api-key when the client sent
        # one (same budget as its HTTP traffic), else the peer address;
        # classification/billing is admission.admit_payload — the SAME
        # policy the HTTP edge applies, one owner
        key = sess.conn.headers.get("x-api-key") \
            or sess.conn.peer.rsplit(":", 1)[0]
        retry = admit_payload(self.admission, key, payload)
        if retry is None:
            return True, key
        from .admission import JSONRPC_RATE_LIMITED
        err = {"code": JSONRPC_RATE_LIMITED, "message": "rate limited",
               "data": {"retryAfterMs": retry}}
        if isinstance(msg, list):
            errs = [{"jsonrpc": "2.0", "id": e.get("id"), "error": err}
                    for e in msg
                    if isinstance(e, dict) and e.get("id") is not None]
            if errs:
                sess.send_now(errs)
        elif isinstance(msg, dict) and msg.get("id") is not None:
            sess.send_now({"jsonrpc": "2.0", "id": msg["id"], "error": err})
        return False, None

    def _offload(self, fn, sess: _Session, msg, lease=None) -> None:
        """Run `fn(sess, msg)` on the shared bounded pool; a saturated (or
        absent) pool falls back to a BOUNDED set of one-off threads so a
        WS session never deadlocks behind HTTP load; past that cap the
        request is shed with the same busy error HTTP answers. `lease` is
        the admission inflight slot — released when the job finishes (or
        is shed below)."""
        if lease is not None:
            inner = fn

            def fn(s, m, _inner=inner):  # noqa: F811 — leased wrapper
                try:
                    _inner(s, m)
                finally:
                    self.admission.release(lease)
        if self.pool is not None and self.pool.try_submit(
                lambda: fn(sess, msg)):
            return
        if not self._fallback.acquire(blocking=False):
            if lease is not None:
                self.admission.release(lease)
            if isinstance(msg, list):
                # batch shed: per-id errors (order preserved, notifications
                # silent) so id-correlating clients resolve every waiter —
                # one id:null error would leave them all hanging
                errs = [{"jsonrpc": "2.0", "id": e.get("id"),
                         "error": {"code": -32000,
                                   "message": "server busy"}}
                        for e in msg
                        if isinstance(e, dict) and e.get("id") is not None]
                if errs:
                    sess.send_now(errs)
                return
            if isinstance(msg, dict) and "id" not in msg:
                return  # notification: never answered, even when shed
            sess.send_now({"jsonrpc": "2.0", "id": msg.get("id"),
                       "error": {"code": -32000, "message": "server busy"}})
            return

        def run() -> None:
            try:
                fn(sess, msg)
            finally:
                self._fallback.release()

        threading.Thread(target=run, name="ws-dispatch",
                         daemon=True).start()

    def _dispatch_batch(self, sess: _Session, msgs: list) -> None:
        resp = self.impl.handle_payload(msgs)
        if resp is not None:
            sess.send_now(resp)

    def _dispatch(self, sess: _Session, msg: dict) -> None:
        handler = self._ws_methods().get(msg["method"])
        if handler is None:
            resp = self.impl.handle_payload(msg)
            if resp is not None:  # None: notification, nothing to send
                sess.send_now(resp)
            return
        mid = msg.get("id")
        try:
            result = handler(sess, msg.get("params") or [])
            sess.send_now({"jsonrpc": "2.0", "id": mid, "result": result})
        except JsonRpcError as exc:
            sess.send_now({"jsonrpc": "2.0", "id": mid,
                       "error": {"code": exc.code, "message": exc.message}})
        except Exception as exc:
            sess.send_now({"jsonrpc": "2.0", "id": mid,
                       "error": {"code": -32603, "message": str(exc)}})

    def _ws_methods(self):
        return {
            "subscribeEvent": self._m_subscribe_event,
            "unsubscribeEvent": self._m_unsubscribe_event,
            "subscribe": self._m_subscribe,
            "unsubscribe": self._m_unsubscribe,
            "subscribeTopic": self._m_subscribe_topic,
            "unsubscribeTopic": self._m_unsubscribe_topic,
            "publishTopic": self._m_publish_topic,
            "broadcastTopic": self._m_broadcast_topic,
        }

    # -- push-plane subscriptions (SubHub) ---------------------------------
    def _m_subscribe(self, sess: _Session, params: list) -> str:
        """subscribe [kind, options?] -> subId. Kinds: newBlockHeaders,
        logs ({addresses, topics} filter), pendingTransactions, receipt
        ({txHash} — lossless one-shot). Admission already metered the
        request (reader thread); the hub's session/per-owner caps answer
        a subscription STORM with the typed -32006."""
        hub = self.subhub
        if hub is None:
            raise JsonRpcError(-32000, "node has no subscription plane")
        if not params or not isinstance(params[0], str):
            raise JsonRpcError(JSONRPC_INVALID_PARAMS,
                               "need [kind, options?]")
        kind = params[0]
        if kind not in SUB_KINDS:
            raise JsonRpcError(JSONRPC_INVALID_PARAMS,
                               f"unknown subscription kind {kind!r}")
        opts = params[1] if len(params) > 1 and isinstance(params[1], dict) \
            else {}
        flt = None
        tx_hash = None
        if kind == "logs" and (opts.get("addresses") or opts.get("topics")):
            flt = _parse_event_filter(opts)
        if kind == "receipt":
            h = opts.get("txHash")
            if not h:
                raise JsonRpcError(JSONRPC_INVALID_PARAMS,
                                   "receipt subscription needs {txHash}")
            tx_hash = bytes.fromhex(str(h).removeprefix("0x"))
        try:
            sub_id = hub.subscribe(kind, sess.push, owner=sess, flt=flt,
                                   tx_hash=tx_hash)
        except SubLimitError as exc:
            raise JsonRpcError(JSONRPC_SUB_LIMIT, str(exc)) from exc
        sess.sub_ids.add(sub_id)
        if not self._session_alive(sess):
            # disconnect raced the subscribe: _on_close already swept the
            # hub by owner, but this sub may have registered after —
            # clean up here instead of leaking it forever
            hub.unsubscribe(sub_id)
            raise JsonRpcError(-32000, "session closed")
        return sub_id

    def _m_unsubscribe(self, sess: _Session, params: list) -> bool:
        if not params:
            raise JsonRpcError(JSONRPC_INVALID_PARAMS, "need [subId]")
        sub_id = params[-1]
        if sub_id not in sess.sub_ids:  # only a session's own streams
            raise JsonRpcError(JSONRPC_INVALID_PARAMS,
                               "unknown subscription id")
        sess.sub_ids.discard(sub_id)
        hub = self.subhub
        return hub.unsubscribe(sub_id) if hub is not None else False

    # -- event subscription push ------------------------------------------
    def _m_subscribe_event(self, sess: _Session, params: list) -> str:
        if len(params) < 2 or not isinstance(params[1], dict):
            raise JsonRpcError(JSONRPC_INVALID_PARAMS,
                               "need [group, filter]")
        flt = _parse_event_filter(params[1])
        # eventsub.subscribe replays history synchronously BEFORE returning
        # the task id, and the commit thread may pump concurrently; buffer
        # pushes under a lock until the id exists so every push carries a
        # routable taskId and block order is preserved
        lk = threading.Lock()
        holder: list[str] = []
        buffered: list[tuple] = []

        def emit(task_id, number, tx_hash, log_index, log,
                 lossless=False) -> None:
            sess.push({
                "type": "eventPush",
                "taskId": task_id,
                "blockNumber": number,
                "txHash": "0x" + tx_hash.hex(),
                "logIndex": log_index,
                "log": {"address": "0x" + log.address.hex(),
                        "topics": ["0x" + t.hex() for t in log.topics],
                        "data": "0x" + log.data.hex()},
            }, lossless=lossless)

        def cb(number: int, tx_hash: bytes, log_index: int, log) -> None:
            with lk:
                if not holder:
                    buffered.append((number, tx_hash, log_index, log))
                    return
                emit(holder[0], number, tx_hash, log_index, log)

        task_id = self.node.eventsub.subscribe(flt, cb)
        with lk:
            holder.append(task_id)
            for args in buffered:
                # the buffered frames ARE the history replay the client
                # explicitly requested: enqueue them lossless — overflow
                # closes the session rather than silently gapping the
                # range (live pushes after this flush are best-effort)
                emit(task_id, *args, lossless=True)
            buffered.clear()
        sess.event_tasks.add(task_id)
        if not self._session_alive(sess):
            # disconnect raced the subscribe: _on_close saw an empty task
            # set, so clean up here instead of leaking the task forever
            self.node.eventsub.unsubscribe(task_id)
            raise JsonRpcError(-32000, "session closed")
        return task_id

    def _session_alive(self, sess: _Session) -> bool:
        with self._lock:
            return self._sessions.get(sess.conn) is sess

    def _m_unsubscribe_event(self, sess: _Session, params: list) -> bool:
        task_id = params[1] if len(params) > 1 else params[0]
        if task_id not in sess.event_tasks:  # a session may only cancel its own
            raise JsonRpcError(JSONRPC_INVALID_PARAMS, "unknown task id")
        sess.event_tasks.discard(task_id)
        return self.node.eventsub.unsubscribe(task_id)

    # -- AMOP bridge -------------------------------------------------------
    def _require_amop(self):
        if self.node.amop is None:
            raise JsonRpcError(-32000, "node has no gateway/AMOP plane")
        return self.node.amop

    def _m_subscribe_topic(self, sess: _Session, params: list) -> bool:
        amop = self._require_amop()
        for topic in params:
            sess.topics.add(topic)
            with self._lock:
                lst = self._topic_sessions.setdefault(topic, [])
                if sess not in lst:
                    lst.append(sess)
            amop.subscribe(topic, self._amop_handler)
            if not self._session_alive(sess):  # disconnect raced us
                self._drop_topic(sess, topic)
                raise JsonRpcError(-32000, "session closed")
        return True

    def _m_unsubscribe_topic(self, sess: _Session, params: list) -> bool:
        for topic in params:
            sess.topics.discard(topic)
            self._drop_topic(sess, topic)
        return True

    def _m_publish_topic(self, sess: _Session, params: list) -> Optional[str]:
        amop = self._require_amop()
        topic, data = params[0], bytes.fromhex(
            params[1].removeprefix("0x")) if len(params) > 1 else b""
        resp = amop.publish(topic, data)
        return None if resp is None else "0x" + resp.hex()

    def _m_broadcast_topic(self, sess: _Session, params: list) -> int:
        amop = self._require_amop()
        topic, data = params[0], bytes.fromhex(
            params[1].removeprefix("0x")) if len(params) > 1 else b""
        return amop.broadcast(topic, data)

    def _amop_handler(self, topic: str, data: bytes,
                      src: bytes) -> Optional[bytes]:
        """Node-side AMOP handler: relay to one serving WS session and wait
        for its amopResp (the reference's AirAMOPClient round trip)."""
        with self._lock:
            sessions = list(self._topic_sessions.get(topic, []))
        for sess in sessions:
            seq = next(self._seq)
            ev = threading.Event()
            out: list = []
            sess.pending[seq] = (ev, out)
            ok = sess.send_now({"type": "amopPush", "seq": seq, "topic": topic,
                            "data": "0x" + data.hex()})
            if not ok:
                sess.pending.pop(seq, None)
                continue
            if ev.wait(_AMOP_REPLY_TIMEOUT) and out:
                sess.pending.pop(seq, None)
                return out[0]
            sess.pending.pop(seq, None)
        LOG.warning(badge("WS", "amop-no-responder", topic=topic))
        return None

    def _on_amop_resp(self, sess: _Session, msg: dict) -> None:
        try:
            seq = int(msg.get("seq", -1))
        except (TypeError, ValueError):
            return  # malformed resp must not tear down the session
        entry = sess.pending.get(seq)
        if entry is None:
            return
        ev, out = entry
        try:
            out.append(bytes.fromhex(str(msg.get("data", "")).removeprefix(
                "0x")))
        except ValueError:
            out.append(b"")
        ev.set()
