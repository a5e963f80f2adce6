"""Gateway — inter-node message transport.

Reference counterpart: FISCO-BCOS bcos-gateway/bcos-gateway/Gateway.cpp
(:184 onReceiveP2PMessage) over bcos-boostssl TLS sessions, with the
`FakeGateWay` in-process variant used by every multi-node test fixture
(bcos-framework/bcos-framework/testutils/faker/FakeFrontService.h:39-102 —
it delivers a message by directly invoking the destination node's registered
module handler, keyed by ModuleID).

`FakeGateway` here is that fixture pattern promoted to a first-class
transport: nodes register their FrontService under their node ID; sends are
delivered on a shared dispatch thread pool so ordering/async semantics match
a socket transport (no re-entrant delivery into the sender's stack). It also
supports dropping nodes (partition) and per-link filters for failure tests.
The socket transport (the p2p slice, not ported yet) speaks the same
envelope.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Optional

from ..utils import failpoints as _fp
from ..utils.log import LOG, badge


class Gateway:
    """Transport interface the FrontService binds to."""

    def register_front(self, node_id: bytes, front) -> None:
        raise NotImplementedError

    def unregister_front(self, node_id: bytes) -> None:
        raise NotImplementedError

    def send(self, src: bytes, dst: bytes, data: bytes) -> bool:
        raise NotImplementedError

    def broadcast(self, src: bytes, data: bytes) -> None:
        raise NotImplementedError

    def peers(self, src: bytes) -> list[bytes]:
        raise NotImplementedError


class GroupGateway(Gateway):
    """Namespaces one group's traffic onto a shared transport.

    The reference multiplexes every P2P payload by (groupID, moduleID) over
    shared TLS sessions (bcos-gateway/bcos-gateway/gateway/
    GatewayNodeManager.cpp groupID->nodeID registry). Here the same effect:
    each group's nodes register under `group_id || node_id` on the shared
    gateway, so multiple groups coexist on one transport without seeing
    each other's messages.
    """

    def __init__(self, shared: Gateway, group_id: str):
        self.shared = shared
        self.prefix = group_id.encode() + b"\x00"

    def _w(self, node_id: bytes) -> bytes:
        return self.prefix + node_id

    def register_front(self, node_id: bytes, front) -> None:
        self.shared.register_front(self._w(node_id), _Unwrap(front, len(self.prefix)))

    def unregister_front(self, node_id: bytes) -> None:
        self.shared.unregister_front(self._w(node_id))

    def send(self, src: bytes, dst: bytes, data: bytes) -> bool:
        return self.shared.send(self._w(src), self._w(dst), data)

    def broadcast(self, src: bytes, data: bytes) -> None:
        # only to same-group peers (shared.broadcast would cross groups)
        for dst in self.peers(src):
            self.send(src, dst, data)

    def peers(self, src: bytes) -> list[bytes]:
        return [p[len(self.prefix):] for p in self.shared.peers(self._w(src))
                if p.startswith(self.prefix)]


class _Unwrap:
    """Strips the group prefix off inbound source ids before the front."""

    def __init__(self, front, cut: int):
        self.front = front
        self.cut = cut

    def on_network_message(self, src: bytes, data: bytes) -> None:
        self.front.on_network_message(src[self.cut:], data)


# frame-level group multiplexing (MuxGateway): first payload byte. Safe to
# discriminate because untagged front frames start with the ModuleID's
# high byte, and no module id reaches 0xF5xx.
MUX_MAGIC = 0xF5


class MuxGateway:
    """Many groups' traffic over ONE point-to-point transport session set.

    `GroupGateway` namespaces by wrapping node IDS — right for the
    in-process FakeGateway, where registration ids are free. A socket
    transport (net/p2p.py) authenticates sessions by the REAL node key,
    so group separation must travel in the FRAME instead: this mux
    registers ONE front (itself) under the node's real id and prefixes
    every outbound payload with `MUX_MAGIC u8len group`, demuxing inbound
    frames to the right group's front — the reference gateway's
    (groupID, moduleID) multiplexing over shared TLS sessions
    (bcos-gateway GatewayNodeManager.cpp).

    Deployment contract: peer processes run the SAME group set (the
    daemon's [groups] shape), so `peers()` is the transport's peer set.
    """

    def __init__(self, shared: Gateway):
        self.shared = shared
        self._lock = threading.Lock()
        self._fronts: dict[str, "object"] = {}
        self._node_id: Optional[bytes] = None

    def view(self, group_id: str) -> "Gateway":
        return _MuxView(self, group_id)

    # -- front protocol (registered once on the shared transport) ----------
    def on_network_message(self, src: bytes, data: bytes) -> None:
        if not data or data[0] != MUX_MAGIC or len(data) < 2:
            LOG.warning(badge("MUXGW", "untagged-frame-dropped",
                              src=src[:8].hex()))
            return
        glen = data[1]
        group = data[2:2 + glen].decode("utf-8", "replace")
        with self._lock:
            front = self._fronts.get(group)
        if front is None:
            return  # a group this process does not host
        front.on_network_message(src, data[2 + glen:])

    # -- mux wiring --------------------------------------------------------
    def _register(self, group_id: str, node_id: bytes, front) -> None:
        with self._lock:
            first = not self._fronts
            if self._node_id is not None and node_id != self._node_id:
                raise ValueError(
                    "MuxGateway carries ONE node identity across groups; "
                    "per-group keys need per-group transports")
            self._node_id = node_id
            self._fronts[group_id] = front
        if first:
            self.shared.register_front(node_id, self)

    def _unregister(self, group_id: str) -> None:
        with self._lock:
            self._fronts.pop(group_id, None)
            last = not self._fronts
            node_id = self._node_id
        if last and node_id is not None:
            self.shared.unregister_front(node_id)

    def _tag(self, group_id: str, data: bytes) -> bytes:
        g = group_id.encode()
        return bytes((MUX_MAGIC, len(g))) + g + data


class _MuxView(Gateway):
    """One group's Gateway interface over the shared mux."""

    def __init__(self, mux: MuxGateway, group_id: str):
        self.mux = mux
        self.group_id = group_id

    def register_front(self, node_id: bytes, front) -> None:
        self.mux._register(self.group_id, node_id, front)

    def unregister_front(self, node_id: bytes) -> None:
        self.mux._unregister(self.group_id)

    def send(self, src: bytes, dst: bytes, data: bytes) -> bool:
        return self.mux.shared.send(src, dst,
                                    self.mux._tag(self.group_id, data))

    def broadcast(self, src: bytes, data: bytes) -> None:
        tagged = self.mux._tag(self.group_id, data)
        for dst in self.mux.shared.peers(src):
            self.mux.shared.send(src, dst, tagged)

    def peers(self, src: bytes) -> list[bytes]:
        return self.mux.shared.peers(src)


class FakeGateway(Gateway):
    """In-process transport with one ordered delivery queue per node.

    Per-destination FIFO mirrors a TCP session's ordering; cross-node order
    is unspecified, like the network. `partition(node)` simulates a crashed
    or isolated node; `set_filter(fn)` can drop/inspect individual messages
    (fn(src, dst, data) -> deliver?).
    """

    # per-destination delivery-queue bound (frames): a stalled in-process
    # node must not buffer its peers' sends without bound — the socket
    # transport's per-session byte budget, approximated in frames here.
    # Generous enough that only a genuinely wedged consumer hits it.
    MAX_QUEUE_FRAMES = 100_000

    def __init__(self):
        self._lock = threading.Lock()
        self._fronts: dict[bytes, "object"] = {}
        self._queues: dict[bytes, queue.Queue] = {}
        self._threads: dict[bytes, threading.Thread] = {}
        self._partitioned: set[bytes] = set()
        self._filter: Optional[Callable[[bytes, bytes, bytes], bool]] = None
        self._stopped = False
        self.dropped = 0

    # -- wiring ------------------------------------------------------------
    def register_front(self, node_id: bytes, front) -> None:
        with self._lock:
            self._fronts[node_id] = front
            if node_id not in self._queues:
                q: queue.Queue = queue.Queue(self.MAX_QUEUE_FRAMES)
                t = threading.Thread(target=self._deliver_loop,
                                     args=(node_id, q),
                                     name=f"gw-{node_id[:4].hex()}",
                                     daemon=True)
                self._queues[node_id] = q
                self._threads[node_id] = t
                t.start()

    def unregister_front(self, node_id: bytes) -> None:
        with self._lock:
            self._fronts.pop(node_id, None)

    def stop(self) -> None:
        self._stopped = True
        with self._lock:
            for q in self._queues.values():
                try:
                    q.put_nowait(None)
                except queue.Full:
                    pass  # _stopped is checked each loop iteration

    def _put(self, q: queue.Queue, dst: bytes, item) -> bool:
        """Bounded enqueue: a full destination queue DROPS the frame
        (counted + surfaced like the socket transport's sendq metric)
        instead of blocking the sender behind a wedged consumer."""
        try:
            q.put_nowait(item)
            return True
        except queue.Full:
            self.dropped += 1
            from ..utils.metrics import REGISTRY
            REGISTRY.inc("bcos_p2p_sendq_dropped_total",
                         labels={"peer": dst[:8].hex(), "kind": "fake"})
            return False

    # -- fault injection ---------------------------------------------------
    def partition(self, node_id: bytes, isolated: bool = True) -> None:
        with self._lock:
            if isolated:
                self._partitioned.add(node_id)
            else:
                self._partitioned.discard(node_id)

    def set_filter(self, fn: Optional[
            Callable[[bytes, bytes, bytes], "bool | float | int"]]) -> None:
        """fn returns a fault verdict — see send(): True deliver, falsy
        drop, float t delay t seconds, int n>1 deliver n duplicates."""
        self._filter = fn

    # -- transport ---------------------------------------------------------
    def peers(self, src: bytes) -> list[bytes]:
        with self._lock:
            return [n for n in self._fronts
                    if n != src and n not in self._partitioned]

    def send(self, src: bytes, dst: bytes, data: bytes) -> bool:
        if _fp.fire_lossy("p2p.send"):
            return False  # same site the socket gateway crosses: the
            #               in-process failpoint matrix exercises frame
            #               loss without real sockets
        with self._lock:
            if (src in self._partitioned or dst in self._partitioned
                    or dst not in self._fronts):
                return False
            q = self._queues.get(dst)
        if q is None:
            return False
        # fault-injection verdicts (network chaos for consensus soaks —
        # the runtime analogue the reference only has as test mocks,
        # MockDeadLockExecutor.h):
        #   True deliver | False drop | float t: deliver after t seconds |
        #   int n>1: deliver n duplicates (bool checked before int!)
        flt = self._filter
        verdict = True if flt is None else flt(src, dst, data)
        if verdict is True:
            return self._put(q, dst, (src, data))
        if not verdict:
            # False, None, 0, 0.0 — preserves the original falsy-drop
            # contract (a filter that forgets to return must fail CLOSED)
            return False
        if isinstance(verdict, float):
            t = threading.Timer(verdict, self._put,
                                args=(q, dst, (src, data)))
            t.daemon = True
            t.start()
            return True
        if isinstance(verdict, int) and verdict > 1:
            for _ in range(verdict):
                self._put(q, dst, (src, data))
            return True
        return self._put(q, dst, (src, data))

    @staticmethod
    def module_of(data: bytes) -> int:
        """ModuleID of a front-packed frame (for module-targeted faults)."""
        import struct as _struct
        return _struct.unpack(">H", data[:2])[0] if len(data) >= 2 else -1

    def broadcast(self, src: bytes, data: bytes) -> None:
        for dst in self.peers(src):
            self.send(src, dst, data)

    def _deliver_loop(self, node_id: bytes, q: queue.Queue) -> None:
        while not self._stopped:
            try:
                # timed get, not a bare block: stop() may fail to enqueue
                # its None sentinel into a FULL queue — the loop must
                # still observe _stopped instead of parking forever
                item = q.get(timeout=1.0)
            except queue.Empty:
                continue
            if item is None:
                return
            src, data = item
            if _fp.fire_lossy("p2p.recv"):
                continue  # injected inbound loss (matches p2p._read_loop)
            with self._lock:
                front = self._fronts.get(node_id)
                dead = node_id in self._partitioned
            if front is None or dead:
                continue
            try:
                front.on_network_message(src, data)
            except Exception:
                LOG.exception(badge("GATEWAY", "dispatch-failed",
                                    dst=node_id[:8].hex()))
