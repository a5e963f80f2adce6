"""AMOP — Advanced Messages Onchain Protocol (topic pub/sub off-chain bus).

Reference counterpart: FISCO-BCOS bcos-gateway/bcos-gateway/libamop/
AMOPImpl.cpp (topic subscription registry + unicast/broadcast dispatch) and
the RPC-side bridge bcos-rpc/bcos-rpc/amop/. Nodes announce their local
topic subscriptions to peers; `publish` unicasts to one subscriber of the
topic and waits for its response, `broadcast` fans out to every subscriber.
SDK clients attach their callbacks through the node they connect to (here:
in-process handler registration; the RPC layer exposes the same calls).

Wire messages (framework wire codec, module AMOP):
  kind u8: 0 ANNOUNCE  payload: seq(u32) topics(list of text)
           1 PUB       payload: topic, data   (front request/response)
           2 BPUB      payload: topic, data   (push, no response)
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

from ..codec.wire import Reader, Writer
from ..utils.log import LOG, badge
from .front import FrontService
from .moduleid import ModuleID

ANNOUNCE, PUB, BPUB = 0, 1, 2

# subscriber callback: (topic, data, src_node) -> optional response bytes
TopicHandler = Callable[[str, bytes, bytes], Optional[bytes]]


class AMOPService:
    def __init__(self, front: FrontService):
        self.front = front
        self._lock = threading.Lock()
        self._subs: dict[str, TopicHandler] = {}
        self._peer_topics: dict[bytes, set[str]] = {}
        self._announce_seq = 0
        front.register_module(ModuleID.AMOP, self._on_message)
        self._announce()  # tell peers we exist (possibly no topics yet)

    # -- subscription management -------------------------------------------
    def subscribe(self, topic: str, handler: TopicHandler) -> None:
        with self._lock:
            self._subs[topic] = handler
        self._announce()

    def unsubscribe(self, topic: str) -> None:
        with self._lock:
            self._subs.pop(topic, None)
        self._announce()

    def topics(self) -> list[str]:
        with self._lock:
            return sorted(self._subs)

    def peer_subscribers(self, topic: str) -> list[bytes]:
        with self._lock:
            return sorted(p for p, ts in self._peer_topics.items()
                          if topic in ts)

    def _announce(self, to: Optional[bytes] = None) -> None:
        # build AND send under the lock: front enqueue order must match seq
        # order, or a reordered stale topic set sticks on peers forever
        with self._lock:
            self._announce_seq += 1
            w = Writer()
            w.u8(ANNOUNCE).u32(self._announce_seq)
            w.seq(sorted(self._subs), lambda ww, t: ww.text(t))
            if to is None:
                self.front.broadcast(ModuleID.AMOP, w.bytes())
            else:
                self.front.send(ModuleID.AMOP, to, w.bytes())

    # -- publish -----------------------------------------------------------
    def publish(self, topic: str, data: bytes, timeout: float = 5.0
                ) -> Optional[bytes]:
        """Unicast to one subscriber (deterministic pick: lowest node id);
        returns its response, or the local handler's if only we subscribe."""
        w = Writer()
        w.u8(PUB).text(topic).blob(data)
        for peer in self.peer_subscribers(topic):
            resp = self.front.request(ModuleID.AMOP, peer, w.bytes(),
                                      timeout=timeout)
            if resp is not None:
                return Reader(resp).blob()
        local = self._subs.get(topic)
        if local is not None:
            return local(topic, data, self.front.node_id)
        return None

    def broadcast(self, topic: str, data: bytes) -> int:
        """Fan out to every peer subscriber (and the local handler); returns
        the number of peers messaged."""
        w = Writer()
        w.u8(BPUB).text(topic).blob(data)
        peers = self.peer_subscribers(topic)
        for peer in peers:
            self.front.send(ModuleID.AMOP, peer, w.bytes())
        local = self._subs.get(topic)
        if local is not None:
            try:
                local(topic, data, self.front.node_id)
            except Exception:
                LOG.exception(badge("AMOP", "local-handler-failed",
                                    topic=topic))
        return len(peers)

    # -- ingress -----------------------------------------------------------
    def _on_message(self, src: bytes, payload: bytes, respond) -> None:
        try:
            r = Reader(payload)
            kind = r.u8()
            if kind == ANNOUNCE:
                r.u32()  # seq (enqueue order == seq order; FIFO per link)
                topics = set(r.seq(lambda rr: rr.text()))
                with self._lock:
                    new_peer = src not in self._peer_topics
                    self._peer_topics[src] = topics
                if new_peer:
                    # a peer that joined after our last announce must still
                    # learn our topics: reply with a direct announce
                    self._announce(to=src)
                return
            topic = r.text()
            data = r.blob()
        except Exception:
            LOG.warning(badge("AMOP", "bad-packet", src=src[:8].hex()))
            return
        handler = self._subs.get(topic)
        if handler is None:
            return  # stale announcement; publisher retries the next peer
        try:
            out = handler(topic, data, src)
        except Exception:
            LOG.exception(badge("AMOP", "handler-failed", topic=topic))
            return
        if kind == PUB and respond is not None:
            w = Writer()
            w.blob(out if out is not None else b"")
            respond(w.bytes())
