"""P2P socket gateway: TCP (optionally TLS) transport between real nodes.

Reference counterpart: FISCO-BCOS bcos-gateway/bcos-gateway/ —
`Host`/`Session` ASIO loops (libnetwork/Host.cpp, Session.cpp),
`Service` connection management with reconnect (libp2p/Service.cpp), the
length-prefixed compressed `P2PMessageV2` wire format, the distance-vector
router for multi-hop delivery (libp2p/router/RouterTableImpl.cpp), and the
peer allow/deny lists (libnetwork/PeerBlacklist.h); TLS contexts from
bcos-boostssl/context/ContextBuilder.cpp. This implementation keeps the same
shape on Python threads + blocking sockets: one listener, one reader thread
per session, a reconnect loop for configured peers, length-prefixed frames.

Frames: u32 length | payload. The first frame each way is a handshake
carrying the magic, protocol version, and the sender's node ID (pubkey);
afterwards frames are typed:

  DATA  u8 kind=0 | u8 flags (bit0: zlib, bit1: zstd) | u8 ttl | u16 len src | u16 len
        dst | payload — routed hop by hop to `dst`, decompressed and handed
        to `front.on_network_message(src, payload)` at the destination.
  ROUTE u8 kind=1 | u16 count | count * (u16 len node | u8 distance) — the
        sender's distance vector; neighbors recompute and re-advertise on
        change, so any node can reach any other across intermediate hops.

Pass an `ssl.SSLContext` pair (server_ctx/client_ctx) for TLS — the
reference's cert-based node authentication maps onto standard TLS certs; the
node ID inside the handshake must then match the session's authenticated
identity (enforced by the caller's context verify settings). An
`net.smtls.SMTLSContext` pair slots into the same seams (the reference's
GM TLS when sm_crypto is on).

A copy of the JAX package's transport; its frames are that package's, so
gateways of the two packages link and exchange DATA and ROUTE frames
(tests/test_torch_p2p.py).
"""

from __future__ import annotations

import socket
import ssl
import struct
import threading
import time
import zlib

try:  # zstd frame compression (libp2p/P2PMessageV2.h uses zstd); zlib
    # remains the fallback for peers without the zstandard module
    import zstandard as _zstd
    _ZC = _zstd.ZstdCompressor(level=3)
except Exception:  # pragma: no cover — environment without zstandard
    _zstd = None
    _ZC = None
import random
from collections import deque
from typing import Optional

from ..analysis import lockcheck as lc
from ..utils import failpoints as fp
from ..utils.log import LOG, badge
from .front import KIND_PUSH as _KIND_PUSH
from .gateway import MUX_MAGIC, Gateway
from .moduleid import ModuleID

# fault sites (utils/failpoints.py): `return_err` at p2p.send drops the
# outbound frame (the caller sees a refused send), at p2p.recv the inbound
# frame vanishes before dispatch — exactly a lossy network, deterministic
fp.register("p2p.send", "p2p.recv")


def reconnect_delay(base: float, fails: int, cap: float,
                    rng: random.Random) -> float:
    """Exponential backoff with randomized jitter. Without jitter every
    peer of a healed partition recomputes the SAME schedule and redials in
    lockstep — a reconnect storm against the just-recovered side. Each
    delay is drawn uniformly from [0.5, 1.0] x the exponential step, so a
    fleet's redials spread across half the window while the worst case
    never exceeds the undithered schedule."""
    step = min(base * (2.0 ** min(fails, 16)), cap)
    return step * (0.5 + rng.random() * 0.5)

MAGIC = b"FBTP"
# v3: capability byte in the hello (zstd negotiation). The handshake is
# strictly version-gated: a mesh upgrades wire versions flag-day style
# (mixed-VERSION peers cannot connect); the zlib fallback below covers
# same-version peers whose environment lacks the zstandard module.
VERSION = 3
CAP_ZSTD = 1
MAX_FRAME = 128 * 1024 * 1024
MAX_SEND_QUEUE = 64 * 1024 * 1024  # per-session outbound byte budget
MAX_TTL = 16
MAX_DISTANCE = 8  # drop longer advertised paths (count-to-infinity guard)
KIND_DATA, KIND_ROUTE = 0, 1
FLAG_COMPRESSED = 1       # zlib (legacy peers)
FLAG_ZSTD = 2             # zstd, the reference's P2PMessageV2 codec


# gossip-class modules: sheddable under per-peer send-queue pressure (the
# anti-entropy sweep repairs tx gossip; AMOP pub/sub is best-effort by
# contract). Consensus (PBFT), BlockSync, ConsTxsSync, SnapshotSync and
# every other module are protected — never evicted from a send queue.
_DROPPABLE_MODULES = frozenset({int(ModuleID.TxsSync), int(ModuleID.AMOP)})
# _KIND_PUSH is net/front.py's KIND_PUSH (the one envelope definition):
# a stale local copy would shed protected REQUEST/RESPONSE frames if the
# envelope ever renumbered


def _is_gossip(data: bytes) -> bool:
    """Classify a front-packed payload by its leading module id AND kind,
    looking through the multi-group mux tag (MUX_MAGIC u8len group) when
    present. Only PUSH frames are sheddable: TxsSync REQUEST/RESPONSE
    frames are PBFT's fetch-missing path — dropping one stalls a replica's
    pre-prepare verification into a view change, exactly what shedding
    must never do. Unknown shapes classify as NOT gossip — fail toward
    protecting."""
    off = 0
    if len(data) >= 2 and data[0] == MUX_MAGIC:
        off = 2 + data[1]
    if len(data) < off + 3:
        return False
    return ((data[off] << 8) | data[off + 1]) in _DROPPABLE_MODULES \
        and data[off + 2] == _KIND_PUSH


def _send_frame(sock: socket.socket, payload: bytes) -> None:
    lc.note_blocking("socket_send", "p2p._send_frame")
    sock.sendall(struct.pack(">I", len(payload)) + payload)


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


def _recv_frame(sock: socket.socket) -> Optional[bytes]:
    head = _recv_exact(sock, 4)
    if head is None:
        return None
    (length,) = struct.unpack(">I", head)
    if length > MAX_FRAME:
        return None
    return _recv_exact(sock, length)


def _pack_data(flags: int, ttl: int, src: bytes, dst: bytes,
               payload: bytes) -> bytes:
    return (bytes([KIND_DATA, flags, ttl])
            + struct.pack(">H", len(src)) + src
            + struct.pack(">H", len(dst)) + dst + payload)


def _unpack_data(frame: bytes):
    flags, ttl = frame[1], frame[2]
    off = 3
    (slen,) = struct.unpack_from(">H", frame, off)
    off += 2
    src = frame[off:off + slen]
    off += slen
    (dlen,) = struct.unpack_from(">H", frame, off)
    off += 2
    dst = frame[off:off + dlen]
    off += dlen
    return flags, ttl, src, dst, frame[off:]


def _pack_route(vector: dict[bytes, int]) -> bytes:
    parts = [bytes([KIND_ROUTE]), struct.pack(">H", len(vector))]
    for node, dist in vector.items():
        parts.append(struct.pack(">H", len(node)) + node + bytes([dist]))
    return b"".join(parts)


def _unpack_route(frame: bytes) -> dict[bytes, int]:
    (count,) = struct.unpack_from(">H", frame, 1)
    off = 3
    out = {}
    for _ in range(count):
        (ln,) = struct.unpack_from(">H", frame, off)
        off += 2
        node = frame[off:off + ln]
        off += ln
        out[node] = frame[off]
        off += 1
    return out


class RouterTable:
    """Distance-vector routes: dst -> (distance, next-hop neighbor).

    Recomputed from scratch on every topology event (neighbor up/down,
    vector received) — simple and correct at consortium scale (tens of
    nodes), the shape of RouterTableImpl.cpp without incremental updates.
    Callers hold the gateway lock.
    """

    def __init__(self, self_id: bytes):
        self.self_id = self_id
        self._vectors: dict[bytes, dict[bytes, int]] = {}  # neighbor -> adv
        self.routes: dict[bytes, tuple[int, bytes]] = {}

    def neighbor_up(self, neighbor: bytes) -> bool:
        self._vectors.setdefault(neighbor, {})
        return self._recompute()

    def neighbor_down(self, neighbor: bytes) -> bool:
        self._vectors.pop(neighbor, None)
        return self._recompute()

    def update_vector(self, neighbor: bytes, vector: dict[bytes, int]
                      ) -> bool:
        if neighbor not in self._vectors:
            return False  # stale: session already dropped
        self._vectors[neighbor] = vector
        return self._recompute()

    def _recompute(self) -> bool:
        routes: dict[bytes, tuple[int, bytes]] = {
            nb: (1, nb) for nb in self._vectors}
        for nb, vec in self._vectors.items():
            for dst, dist in vec.items():
                if dst == self.self_id or dist + 1 > MAX_DISTANCE:
                    continue
                cur = routes.get(dst)
                if cur is None or dist + 1 < cur[0] or (
                        dist + 1 == cur[0] and nb < cur[1]):
                    routes[dst] = (dist + 1, nb)
        changed = routes != self.routes
        self.routes = routes
        return changed

    def vector(self) -> dict[bytes, int]:
        out = {self.self_id: 0}
        out.update({dst: dist for dst, (dist, _hop) in self.routes.items()})
        return out

    def next_hop(self, dst: bytes) -> Optional[bytes]:
        entry = self.routes.get(dst)
        return entry[1] if entry else None

    def reachable(self) -> list[bytes]:
        return list(self.routes)


class _Session:
    """One peer link: socket + bounded outbound queue + writer thread.

    Backpressure (the reference's Session.cpp send-buffer discipline): the
    caller NEVER blocks on a slow peer's socket — frames queue up to a byte
    budget and a dedicated writer drains them. Past the budget, the OLDEST
    queued GOSSIP frame is dropped first (a stalled follower's backlog of
    tx floods is the least valuable bytes in the queue, and the txpool's
    anti-entropy sweep re-delivers them); consensus/sync frames are never
    evicted — when no gossip can be shed, the NEWEST frame is refused
    instead (counted; PBFT's retransmit/view-change paths tolerate loss by
    design). Either way a slow peer can neither lag this node nor grow its
    memory without bound. Drops surface as
    `bcos_p2p_sendq_dropped_total{peer=...,kind=gossip|other}`."""

    def __init__(self, peer_id: bytes, sock: socket.socket, on_dead,
                 max_queue: int = MAX_SEND_QUEUE):
        self.peer_id = peer_id
        self.sock = sock
        self._on_dead = on_dead  # called with THIS session (identity-safe)
        self.max_queue = max_queue
        # entries are shared mutable [frame, droppable, dead] cells held
        # by BOTH queues; eviction is LAZY (mark dead, adjust bytes, let
        # the writer skip it) so overflow handling is O(1) amortized —
        # a middle-of-deque delete would be O(backlog) under the cv,
        # stalling every sender to this peer exactly while it is slow
        self._q: "deque[list]" = deque()
        self._droppable: "deque[list]" = deque()  # gossip-class entries
        self._cv = lc.make_condition("p2p.session")
        self._bytes = 0
        self._closed = False
        self.dropped = 0
        self._writer = threading.Thread(
            target=self._write_loop, name=f"p2p-w-{peer_id[:4].hex()}",
            daemon=True)
        # NOT started here: a thread launched mid-__init__ races the
        # publication of the fields it reads (bcoslint:
        # thread-start-in-ctor). The owner calls start() once the
        # session is fully constructed and registered.

    def start(self) -> None:
        self._writer.start()

    def _count_drop(self, kind: str) -> None:
        self.dropped += 1
        from ..utils.metrics import REGISTRY
        REGISTRY.inc("bcos_p2p_sendq_dropped_total",
                     labels={"peer": self.peer_id[:8].hex(), "kind": kind})
        if self.dropped in (1, 100, 10000):
            LOG.warning(badge("P2P", "send-queue-full",
                              peer=self.peer_id[:8].hex(),
                              dropped=self.dropped))

    def enqueue(self, frame: bytes, droppable: bool = False) -> bool:
        """`droppable` marks frames gossip-class (TxsSync/AMOP pushes):
        sheddable for a slow peer. Everything else (consensus, block
        sync, fetch-missing request/response, routed transit) is
        protected — see the class docstring."""
        drops = 0
        refused = None
        with self._cv:
            if self._closed:
                return False  # writer already gone; don't strand frames
            # drain dead heads (entries the writer already consumed):
            # without this the droppable index would retain every gossip
            # frame's bytes for the session's lifetime — amortized O(1)
            while self._droppable and self._droppable[0][2]:
                self._droppable.popleft()
            while self._bytes + len(frame) > self.max_queue \
                    and self._droppable:
                # evict the OLDEST live droppable entry: mark dead, the
                # writer skips it — O(1), no deque surgery
                e = self._droppable.popleft()
                if e[2]:
                    continue  # already sent (or previously evicted)
                e[2] = True
                self._bytes -= len(e[0])
                e[0] = b""  # free the bytes now, not at index drain
                drops += 1
            if self._bytes + len(frame) > self.max_queue:
                refused = "gossip" if droppable else "other"
            else:
                self._bytes += len(frame)
                entry = [frame, droppable, False]
                self._q.append(entry)
                if droppable:
                    self._droppable.append(entry)
                self._cv.notify()
        # metrics/logging outside the cv: REGISTRY has its own lock
        for _ in range(drops):
            self._count_drop("gossip")
        if refused is not None:
            self._count_drop(refused)
            return False
        return True

    def _write_loop(self) -> None:
        while True:
            with self._cv:
                while not self._q and not self._closed:
                    self._cv.wait()
                if self._closed:
                    return
                entry = self._q.popleft()
                if entry[2]:
                    continue  # evicted while queued: nothing to send
                entry[2] = True  # consumed: eviction must skip it now
                frame = entry[0]
                entry[0] = b""  # the droppable index may still hold the
                #                 cell — don't pin the bytes through it
                self._bytes -= len(frame)
            try:
                _send_frame(self.sock, frame)
            except OSError:
                self._on_dead(self)
                return

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        try:
            self.sock.close()
        except OSError:
            pass


class P2PGateway(Gateway):
    def __init__(self, node_id: bytes, host: str = "127.0.0.1",
                 port: int = 0, peers: Optional[list[tuple[str, int]]] = None,
                 server_ssl: Optional[ssl.SSLContext] = None,
                 client_ssl: Optional[ssl.SSLContext] = None,
                 reconnect_interval: float = 1.0,
                 allow_list: Optional[set[bytes]] = None,
                 deny_list: Optional[set[bytes]] = None,
                 compress_threshold: int = 1024,
                 health=None):
        self.node_id = node_id
        # health plane (utils/health.py): a node that cannot reach ANY
        # configured peer reports `p2p.isolated` degraded (writes shed —
        # they could never commit) and clears on the first session up
        self.health = health
        self._isolated = False
        self._jitter_rng = random.Random()
        self.configured_peers = list(peers or [])
        self.server_ssl = server_ssl
        self.client_ssl = client_ssl
        self.reconnect_interval = reconnect_interval
        # PeerBlacklist.h semantics: a non-None allow_list admits ONLY its
        # members; deny_list rejects its members in any case
        self.allow_list = allow_list
        self.deny_list = deny_list or set()
        self.compress_threshold = compress_threshold
        self._front = None
        self._sessions: dict[bytes, _Session] = {}
        self._peer_by_addr: dict[tuple[str, int], bytes] = {}
        self._router = RouterTable(node_id)
        self._lock = lc.make_lock("p2p.gateway")
        # held across build+enqueue of ROUTE frames so two concurrent
        # topology events cannot deliver a stale vector after a newer one.
        # RLock: a full send queue inside the advertise loop drops that
        # session, which re-advertises re-entrantly (bounded — each drop
        # removes a session).
        self._adv_lock = lc.make_rlock("p2p.adv")
        self._topo_version = 0  # bumped under _lock on any routing change
        self._stopped = False

        self._listener = socket.create_server((host, port))
        self.host, self.port = self._listener.getsockname()[:2]
        self._threads: list[threading.Thread] = []

    def _acl_ok(self, peer_id: bytes) -> bool:
        if peer_id in self.deny_list:
            return False
        return self.allow_list is None or peer_id in self.allow_list

    # -- Gateway interface -------------------------------------------------
    def register_front(self, node_id: bytes, front) -> None:
        assert node_id == self.node_id
        self._front = front
        self._spawn(self._accept_loop, "p2p-accept")
        self._spawn(self._connect_loop, "p2p-connect")

    def unregister_front(self, node_id: bytes) -> None:
        self.stop()

    def peers(self, src: bytes = b"") -> list[bytes]:
        """Every reachable node — direct sessions AND multi-hop routes, so
        front-level broadcast spans the whole connected component."""
        with self._lock:
            return sorted(set(self._sessions) | set(self._router.reachable()))

    def _recompute_codec_locked(self) -> None:
        """zstd is used only when every DIRECT session negotiated
        CAP_ZSTD and no peer is multi-hop (transit forwards frames
        unmodified, so a distant peer's capability is unknown — the
        mesh-wide lowest common denominator must include them; full-mesh
        consortium deployments keep zstd, line/star topologies degrade
        to zlib). Recomputed on session AND route changes."""
        if _ZC is None or not self._sessions:
            self._use_zstd = False
            return
        direct_ok = {p for p, s in self._sessions.items()
                     if getattr(s, "caps", 0) & CAP_ZSTD}
        reachable = set(self._sessions) | set(self._router.reachable())
        self._use_zstd = reachable <= direct_ok

    def _encode_payload(self, data: bytes) -> tuple[int, bytes]:
        if len(data) >= self.compress_threshold:
            if getattr(self, "_use_zstd", False):
                return FLAG_ZSTD, _ZC.compress(data)
            return FLAG_COMPRESSED, zlib.compress(data, 6)
        return 0, data

    def send(self, src: bytes, dst: bytes, data: bytes) -> bool:
        if fp.fire_lossy("p2p.send"):
            return False  # injected loss: frame dropped before the wire
        droppable = _is_gossip(data)  # classified BEFORE compression
        flags, payload = self._encode_payload(data)
        frame = _pack_data(flags, MAX_TTL, self.node_id, dst, payload)
        return self._forward(dst, frame, droppable)

    def _forward(self, dst: bytes, frame: bytes,
                 droppable: bool = False) -> bool:
        """Hand a DATA frame to the session for dst, or its next hop.
        Non-blocking: enqueues on the session's bounded writer queue.
        Transit frames (forwarded for other nodes) default to protected —
        their compressed payload hides the module id."""
        with self._lock:
            hop = dst if dst in self._sessions else self._router.next_hop(dst)
            sess = self._sessions.get(hop) if hop else None
        if sess is None:
            return False
        return sess.enqueue(frame, droppable)

    def broadcast(self, src: bytes, data: bytes) -> None:
        droppable = _is_gossip(data)
        flags, payload = self._encode_payload(data)  # compress ONCE
        for dst in self.peers():
            self._forward(dst, _pack_data(flags, MAX_TTL, self.node_id,
                                          dst, payload), droppable)

    def _advertise_routes(self) -> None:
        # loop until the vector we just finished enqueueing is still
        # current: a full-queue drop mid-loop removes that session and
        # re-enters (RLock) with a NEWER vector; when the outer pass then
        # resumes with its stale frame, the version check catches it and
        # re-enqueues fresh — the LAST frame every live neighbor gets is
        # always the newest.
        with self._adv_lock:
            while True:
                with self._lock:
                    ver = self._topo_version
                    frame = _pack_route(self._router.vector())
                    targets = list(self._sessions.values())
                for sess in targets:
                    if not sess.enqueue(frame):
                        # a peer 64MB behind cannot be kept route-consistent;
                        # drop the session (it re-advertises re-entrantly)
                        # rather than silently desync its routing table
                        self._drop_session(sess)
                with self._lock:
                    if self._topo_version == ver:
                        return

    def stop(self) -> None:
        self._stopped = True
        try:
            self._listener.close()
        except OSError:
            pass
        with self._lock:
            sessions = list(self._sessions.values())
            self._sessions.clear()
        for sess in sessions:
            sess.close()

    def add_peer(self, host: str, port: int) -> None:
        with self._lock:
            if (host, port) not in self.configured_peers:
                self.configured_peers.append((host, port))

    # -- internals ---------------------------------------------------------
    def _spawn(self, fn, name: str) -> None:
        t = threading.Thread(target=fn, name=name, daemon=True)
        t.start()
        self._threads.append(t)

    def _handshake(self, sock: socket.socket
                   ) -> Optional[tuple[bytes, int]]:
        caps = CAP_ZSTD if _ZC is not None else 0
        hello = MAGIC + bytes([VERSION, caps]) + self.node_id
        _send_frame(sock, hello)
        frame = _recv_frame(sock)
        if frame is None or len(frame) < 6 or frame[:4] != MAGIC:
            return None
        if frame[4] != VERSION:
            return None
        return frame[6:], frame[5]

    def _install(self, peer_id: bytes, sock: socket.socket,
                 outbound: bool, caps: int = 0) -> bool:
        """One session per pair, deterministic direction: the smaller node id
        dials, the larger accepts — no replacement livelock on simultaneous
        connects (Service.cpp keeps one session per peer the same way)."""
        if peer_id == self.node_id:
            return False
        if not self._acl_ok(peer_id):
            LOG.warning(badge("P2P", "peer-rejected-acl",
                              peer=peer_id[:8].hex()))
            return False
        if outbound != (self.node_id < peer_id):
            return False  # wrong direction: the other side owns this link
        with self._lock:
            if peer_id in self._sessions:
                return False  # duplicate dial; first session wins
            sess = _Session(peer_id, sock, self._drop_session)
            sess.caps = caps
            self._sessions[peer_id] = sess
            self._router.neighbor_up(peer_id)
            self._topo_version += 1
            self._recompute_codec_locked()
        sess.start()  # writer thread, after full construction
        self._spawn(lambda: self._read_loop(sess, sock),
                    f"p2p-read-{peer_id[:4].hex()}")
        if self._isolated and self.health is not None:
            self._isolated = False
            self.health.clear("p2p.isolated")
        LOG.info(badge("P2P", "session-up", peer=peer_id[:8].hex(),
                       n=len(self._sessions)))
        self._update_session_gauge()
        self._advertise_routes()
        return True

    def _update_session_gauge(self) -> None:
        from ..utils.metrics import REGISTRY
        with self._lock:
            n = len(self._sessions)
        REGISTRY.set_gauge("bcos_p2p_sessions", n)

    def _drop_session(self, sess: "_Session") -> None:
        """Tear down a SPECIFIC session: a stale writer/reader for a dead
        link must not remove a healthy replacement registered under the
        same peer id."""
        self._drop(sess.peer_id, sess)

    def _drop(self, peer_id: bytes, expect: "Optional[_Session]" = None
              ) -> None:
        with self._lock:
            sess = self._sessions.get(peer_id)
            if sess is None or (expect is not None and sess is not expect):
                stale = expect
                sess = None
            else:
                self._sessions.pop(peer_id, None)
                self._router.neighbor_down(peer_id)
                self._topo_version += 1
                self._recompute_codec_locked()
                stale = None
        if stale is not None:
            stale.close()  # silence the dead session; topology unchanged
            return
        if sess is not None:
            sess.close()
            self._update_session_gauge()
            self._advertise_routes()

    def _accept_loop(self) -> None:
        while not self._stopped:
            try:
                sock, _addr = self._listener.accept()
            except OSError:
                return
            if self.server_ssl is not None:
                try:
                    sock = self.server_ssl.wrap_socket(sock, server_side=True)
                except OSError:  # ssl.SSLError AND smtls.SMTLSError — a
                    continue     # garbage dial must not kill the acceptor
            try:
                hs = self._handshake(sock)
            except OSError:
                continue
            peer_id, caps = hs if hs else (None, 0)
            if peer_id is None or not self._install(peer_id, sock,
                                                    outbound=False,
                                                    caps=caps):
                try:
                    sock.close()
                except OSError:
                    pass

    MAX_RECONNECT_BACKOFF = 30.0

    def _connect_loop(self) -> None:
        # per-address exponential backoff (Service.cpp's reconnect timer
        # discipline): a dead/refusing peer is retried at 1x, 2x, 4x ... the
        # base interval up to MAX_RECONNECT_BACKOFF, and a successful dial
        # resets its address — so a restarting node re-links within one base
        # interval while a permanently-down peer costs ~nothing
        backoff: dict[tuple[str, int], tuple[int, float]] = {}
        while not self._stopped:
            with self._lock:
                targets = list(self.configured_peers)
                connected = set(self._sessions)
            now = time.monotonic()
            for host, port in targets:
                if self._stopped:
                    return
                with self._lock:
                    known = self._peer_by_addr.get((host, port))
                if known is not None and known in connected:
                    backoff.pop((host, port), None)
                    continue  # already linked to this address's node
                fails, next_at = backoff.get((host, port), (0, 0.0))
                if now < next_at:
                    continue
                sock = None
                try:
                    sock = socket.create_connection((host, port), timeout=3)
                    if self.client_ssl is not None:
                        sock = self.client_ssl.wrap_socket(
                            sock, server_hostname=host)
                    hs = self._handshake(sock)
                    peer_id, caps = hs if hs else (None, 0)
                    if peer_id is None:
                        # TCP accepted but the hello failed (hung node,
                        # wrong protocol, dead upstream behind a proxy):
                        # as dead as a refused dial — and each retry costs
                        # a full TLS handshake, so it MUST back off too
                        raise OSError("handshake failed")
                    with self._lock:
                        self._peer_by_addr[(host, port)] = peer_id
                    if self._install(peer_id, sock, outbound=True,
                                     caps=caps):
                        sock = None  # session owns it now
                        backoff.pop((host, port), None)
                    else:
                        # refused session (ACL deny, wrong direction while
                        # the inbound link is still forming, duplicate):
                        # each retry still paid a full TLS handshake, so
                        # it backs off like a failure; an inbound session
                        # landing meanwhile makes the loop skip the
                        # address entirely
                        raise OSError("session refused")
                except OSError:
                    if sock is not None:
                        try:  # every failure path, incl. a wrap/hello
                            sock.close()  # raise: leaked fds accumulate
                        except OSError:   # per retry for a daemon's life
                            pass
                    # exponent clamped inside reconnect_delay: fails grows
                    # forever for a permanently-dead peer and 2.0**1025
                    # would overflow, killing this thread and all future
                    # redials. The jitter keeps a healed partition's peers
                    # from redialing in lockstep.
                    delay = reconnect_delay(self.reconnect_interval, fails,
                                            self.MAX_RECONNECT_BACKOFF,
                                            self._jitter_rng)
                    backoff[(host, port)] = (fails + 1,
                                             time.monotonic() + delay)
                    continue
            self._check_isolation(backoff)
            time.sleep(self.reconnect_interval)

    # consecutive dial failures per address before the node may call
    # itself isolated (one flaky dial must not shed writes)
    ISOLATION_FAILS = 3

    def _check_isolation(self, backoff: dict) -> None:
        """Repeated reconnect failure used to be swallowed by the dial
        loop: a node with configured peers, ZERO sessions, and every
        address >= ISOLATION_FAILS consecutive failures is partitioned
        from the whole mesh — report it instead of idling."""
        if self.health is None:
            return
        with self._lock:
            if self._sessions or not self.configured_peers:
                return  # clearing happens at session install
            isolated = all(
                backoff.get(addr, (0, 0.0))[0] >= self.ISOLATION_FAILS
                for addr in self.configured_peers)
            n = len(self.configured_peers)
            if isolated:
                self._isolated = True
        if isolated:
            # a session installing between the locked check and this call
            # is healed by the probe (and by _install's own clear)
            self.health.degraded(
                "p2p.isolated",
                f"no session; all {n} configured peer(s) failing >= "
                f"{self.ISOLATION_FAILS} dials",
                probe=self._connectivity_ok)

    def _connectivity_ok(self) -> bool:
        """Self-healing probe for `p2p.isolated`: any live session means
        the node is reachable again (covers the report/install race)."""
        with self._lock:
            return bool(self._sessions)

    def _read_loop(self, sess: "_Session", sock: socket.socket) -> None:
        peer_id = sess.peer_id
        while not self._stopped:
            try:
                frame = _recv_frame(sock)
            except OSError:
                frame = None
            if frame is None:
                self._drop_session(sess)
                return
            if fp.fire_lossy("p2p.recv"):
                continue  # injected loss: inbound frame never dispatched
            try:
                self._on_frame(peer_id, frame)
            except Exception:
                LOG.exception(badge("P2P", "dispatch-failed",
                                    peer=peer_id[:8].hex()))

    def _on_frame(self, peer_id: bytes, frame: bytes) -> None:
        if not frame:
            return
        kind = frame[0]
        if kind == KIND_ROUTE:
            vector = {n: d for n, d in _unpack_route(frame).items()
                      if self._acl_ok(n)}
            with self._lock:
                changed = self._router.update_vector(peer_id, vector)
                if changed:
                    self._topo_version += 1
                    self._recompute_codec_locked()  # reachability changed
            if changed:
                self._advertise_routes()
            return
        if kind != KIND_DATA:
            return
        flags, ttl, src, dst, payload = _unpack_data(frame)
        # hop-level filtering: ACL-denied identities may neither inject nor
        # transit, and a frame claiming a DIRECT neighbor's identity must
        # arrive on that neighbor's own session. End-to-end authenticity of
        # multi-hop sources rides on message signatures (PBFT packets, tx
        # sigs, commit seals) exactly as in the reference's routed gateway.
        if not self._acl_ok(src) or not self._acl_ok(dst):
            return
        if src == self.node_id:
            return  # a frame claiming OUR identity off the wire is forged
        with self._lock:
            if src in self._sessions and src != peer_id:
                spoofed = True
            else:
                spoofed = False
        if spoofed:
            LOG.warning(badge("P2P", "src-spoof-dropped",
                              claimed=src[:8].hex(), via=peer_id[:8].hex()))
            return
        if dst != self.node_id:
            # transit: forward toward dst with a decremented ttl
            if ttl > 0:
                fwd = frame[:2] + bytes([ttl - 1]) + frame[3:]
                if not self._forward(dst, fwd):
                    LOG.warning(badge("P2P", "no-route",
                                      dst=dst[:8].hex(), ttl=ttl))
            return
        if flags & FLAG_ZSTD:
            if _zstd is None:
                LOG.warning(badge("P2P", "zstd-frame-unsupported",
                                  src=src[:8].hex()))
                return
            try:  # bounded: max_output_size stops decompression bombs
                payload = _zstd.ZstdDecompressor().decompress(
                    payload, max_output_size=MAX_FRAME)
            except _zstd.ZstdError:
                LOG.warning(badge("P2P", "bad-zstd-frame-dropped",
                                  src=src[:8].hex()))
                return
        elif flags & FLAG_COMPRESSED:
            # bounded inflate: a 128 MB cap stops zlib bombs cold
            d = zlib.decompressobj()
            payload = d.decompress(payload, MAX_FRAME)
            if d.unconsumed_tail:
                LOG.warning(badge("P2P", "overlong-inflate-dropped",
                                  src=src[:8].hex()))
                return
        front = self._front
        if front is not None:
            front.on_network_message(src, payload)
