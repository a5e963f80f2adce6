"""FrontService — the per-node message bus.

Reference counterpart: FISCO-BCOS bcos-front/bcos-front/FrontService.cpp
(:511 onReceiveMessage -> dispatcher map built at :145;
 FrontService.h:189 registerModuleMessageDispatcher) wired up in
libinitializer/FrontServiceInitializer.cpp:89-155 (PBFT, TxsSync,
ConsTxsSync, BlockSync handlers).

Envelope (deterministic wire codec):
    u16 module | u8 kind (0 push, 1 request, 2 response) | u64 seq
    | blob payload | [blob trace-context]
Requests carry a seq the responder echoes; `request()` blocks the caller
with a timeout (the reference's callback-with-timeout on
asyncSendMessageByNodeID). Handlers run on the gateway's delivery thread —
modules that need their own serialisation (PBFT's single worker) enqueue
internally, matching the reference's thread model.

The optional trailing blob is the sender thread's otrace span context
(utils/otrace.wire_bytes — 25 bytes, only present when a sampled trace is
active): this is how ONE transaction's trace stitches across nodes — the
leader broadcasts its pre-prepare under the block's context, every
replica's handler runs inside `ctx_scope` of the delivered context, and
the spans they record (PBFT phases, execute/commit stages) share the
originating trace_id. Frames from builds without the field parse
unchanged (the blob is absent, context None).
"""

from __future__ import annotations

import itertools
import threading
from typing import Callable, Optional

from ..codec.wire import Reader, Writer
from ..utils import otrace
from ..utils.log import LOG, badge
from .gateway import Gateway
from .moduleid import ModuleID as ModuleID  # re-export: consumers import
#                                             the module table from front

# handler(src_node_id, payload, respond) — respond is None for pushes,
# else a callable(bytes) that routes a response back to the requester.
Handler = Callable[[bytes, bytes, Optional[Callable[[bytes], None]]], None]

KIND_PUSH = 0
KIND_REQUEST = 1
KIND_RESPONSE = 2


class FrontService:
    def __init__(self, node_id: bytes, gateway: Gateway):
        self.node_id = node_id
        self.gateway = gateway
        self._handlers: dict[int, Handler] = {}
        self._seq = itertools.count(1)
        self._pending: dict[int, tuple[threading.Event, list, bytes]] = {}
        self._malformed = 0  # dropped-garbage counter (rate-limited warn)
        self._lock = threading.Lock()
        gateway.register_front(node_id, self)

    # -- module registration ----------------------------------------------
    def register_module(self, module: int, handler: Handler) -> None:
        self._handlers[int(module)] = handler

    # -- sends -------------------------------------------------------------
    @staticmethod
    def _pack(module: int, kind: int, seq: int, payload: bytes) -> bytes:
        w = Writer().u16(int(module)).u8(kind).u64(seq).blob(payload)
        tb = otrace.wire_bytes()  # sampled span context rides the frame
        if tb:
            w.blob(tb)
        return w.bytes()

    def send(self, module: int, dst: bytes, payload: bytes) -> bool:
        return self.gateway.send(self.node_id, dst,
                                 self._pack(module, KIND_PUSH, 0, payload))

    def broadcast(self, module: int, payload: bytes) -> None:
        self.gateway.broadcast(self.node_id,
                               self._pack(module, KIND_PUSH, 0, payload))

    def request(self, module: int, dst: bytes, payload: bytes,
                timeout: float = 5.0) -> Optional[bytes]:
        """Send a request and block for the response (or None on timeout)."""
        seq = next(self._seq)
        ev = threading.Event()
        slot: list = []
        with self._lock:
            self._pending[seq] = (ev, slot, dst)
        ok = self.gateway.send(self.node_id, dst,
                               self._pack(module, KIND_REQUEST, seq, payload))
        if not ok:
            with self._lock:
                self._pending.pop(seq, None)
            return None
        ev.wait(timeout)
        with self._lock:
            self._pending.pop(seq, None)
        return slot[0] if slot else None

    def peers(self) -> list[bytes]:
        return self.gateway.peers(self.node_id)

    def stop(self) -> None:
        self.gateway.unregister_front(self.node_id)

    # -- receive (gateway delivery thread) ---------------------------------
    def on_network_message(self, src: bytes, data: bytes) -> None:
        try:
            r = Reader(data)
            module, kind, seq = r.u16(), r.u8(), r.u64()
            payload = r.blob()
            ctx = None
            if not r.done():  # optional trailing span context
                try:
                    ctx = otrace.unpack_ctx(r.blob())
                except ValueError:
                    ctx = None
        except ValueError:
            # malformed frame: drop cheaply — a garbage flood must not buy
            # a traceback (or even a log line) per frame; count it and
            # warn once per 1000 so the signal survives without giving an
            # attacker log-volume amplification
            self._malformed += 1
            if self._malformed % 1000 == 1:
                LOG.warning(badge("FRONT", "malformed-frame",
                                  src=src[:8].hex(), size=len(data),
                                  total=self._malformed))
            return
        if kind == KIND_RESPONSE:
            with self._lock:
                entry = self._pending.get(seq)
            if entry is not None:
                ev, slot, dst = entry
                if src != dst:  # only the requested peer may answer
                    return
                slot.append(payload)
                ev.set()
            return
        handler = self._handlers.get(module)
        if handler is None:
            LOG.warning(badge("FRONT", "no-module-handler", module=module))
            return
        respond = None
        if kind == KIND_REQUEST:
            def respond(resp: bytes, _seq=seq, _src=src, _module=module):
                self.gateway.send(self.node_id, _src,
                                  self._pack(_module, KIND_RESPONSE, _seq,
                                             resp))
        # the delivered frame's span context scopes the handler: modules
        # that defer to their own worker (PBFT) pin otrace.current() onto
        # the queued object before returning
        with otrace.ctx_scope(ctx):
            handler(src, payload, respond)
