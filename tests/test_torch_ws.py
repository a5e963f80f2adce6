"""The port's websocket plane (net/websocket.py, rpc/ws_server.py,
rpc/eventsub.py, net/amop.py, sdk/ws.py) against the JAX package's:

  * RFC 6455 framing byte for byte: every length form, masking under the
    same mask key, fragments reassembled around a ping, the close echo,
    the handshake's accept key, and each package's client on the other
    package's server;
  * subscriptions over a live solo Node with `ws_port=0`
    (`newBlockHeaders`, `receipt`, `logs`, `pendingTransactions`): the
    same txs sent through each package's own WsSdkClient give the same
    pushes (header hashes and times aside, which carry the seal time);
  * AMOP: the in-process service over a FakeGateway, and publish and
    subscribe through the WS bridge, with the same replies from both.
"""

import socket
import threading
import time

import pytest

import test_torch_pbft as pb  # tests/ is on sys.path under pytest
import test_torch_rpc as rpc

JAX, PORT = rpc.JAX, "fisco_bcos_tpu_torch"
ROOTS = (JAX, PORT)
MASK = b"\x37\xfa\x21\x3d"


def ws(root: str):
    return pb.mod(root, "net.websocket")


@pytest.fixture()
def fixed_mask(monkeypatch):
    for root in ROOTS:
        monkeypatch.setattr(ws(root).os, "urandom", lambda n: (MASK * 8)[:n])


LENGTHS = (0, 1, 125, 126, 127, 65535, 65536, 70_000)


@pytest.mark.parametrize("masked", [False, True])
def test_frames_are_byte_equal(fixed_mask, masked):
    for n in LENGTHS:
        payload = bytes((i * 7 + n) % 256 for i in range(n))
        got = []
        for root in ROOTS:
            W = ws(root)
            conn = W.WsConnection(None, mask_outgoing=masked)
            got.append([conn._frame(op, payload) for op in (W.OP_TEXT, W.OP_BINARY,
                                                             W.OP_PING, W.OP_CLOSE)])
            assert W._xor_mask(W._xor_mask(payload, MASK), MASK) == payload
        assert got[0] == got[1], n
        frame = got[1][1]
        assert frame[0] == 0x82 and bool(frame[1] & 0x80) == masked
        if masked:
            assert MASK in frame[:14]


def _exchange(root: str, wire: bytes):
    """`wire` into one end of a socket pair read by the package's server-
    side WsConnection: -> (the messages recv() returned, the bytes it sent
    back: pongs and the close echo)."""
    W = ws(root)
    a, b = socket.socketpair()
    try:
        conn = W.WsConnection(a, mask_outgoing=False)
        b.sendall(wire)
        b.shutdown(socket.SHUT_WR)
        msgs = []
        while True:
            m = conn.recv()
            if m is None:
                break
            msgs.append(m)
        a.shutdown(socket.SHUT_WR)
        back = b""
        while True:
            chunk = b.recv(65536)
            if not chunk:
                break
            back += chunk
        return msgs, back
    finally:
        a.close()
        b.close()


def _client_frame(op: int, payload: bytes, fin: bool = True) -> bytes:
    """A masked client frame written by hand (the reference's layout)."""
    mk = MASK
    ln = len(payload)
    hdr = bytes([(0x80 if fin else 0) | op])
    if ln < 126:
        hdr += bytes([0x80 | ln])
    else:
        hdr += bytes([0x80 | 126]) + ln.to_bytes(2, "big")
    body = bytes(c ^ mk[i % 4] for i, c in enumerate(payload))
    return hdr + mk + body


WIRES = {
    "fragments": (_client_frame(0x1, b"hel", fin=False) + _client_frame(0x9, b"ping!")
                  + _client_frame(0x0, b"lo ", fin=False) + _client_frame(0x0, b"world")
                  + _client_frame(0x2, bytes(300)) + _client_frame(0x8, b"\x03\xe8bye")),
    "close": _client_frame(0x1, b"one") + _client_frame(0x8, b"\x03\xe9"),
    "truncated": _client_frame(0x1, b"whole") + _client_frame(0x2, bytes(200))[:50],
}


@pytest.mark.parametrize("case", sorted(WIRES))
def test_fragments_pings_and_close_match_jax(case):
    want = _exchange(JAX, WIRES[case])
    got = _exchange(PORT, WIRES[case])
    assert got == want
    msgs, back = got
    if case == "fragments":
        assert msgs == [(0x1, b"hello world"), (0x2, bytes(300))]
        assert back == b"\x8a\x05ping!" + b"\x88\x02\x03\xe8"
    elif case == "close":
        assert msgs == [(0x1, b"one")] and back == b"\x88\x02\x03\xe9"
    else:
        assert msgs == [(0x1, b"whole")] and back == b""


def test_handshake_and_each_client_on_the_other_server():
    key = "dGhlIHNhbXBsZSBub25jZQ=="
    assert ws(PORT)._accept_key(key) == ws(JAX)._accept_key(key) == \
        "s3pPLMBiTxaQ9kYGzzhZRbK+xOo="
    for server_root, client_root in ((JAX, PORT), (PORT, JAX), (PORT, PORT)):
        S, C = ws(server_root), ws(client_root)
        seen = []

        def on_message(conn, op, payload, seen=seen, S=S):
            seen.append((op, payload))
            conn.send_text(payload.decode()[::-1]) if op == S.OP_TEXT else \
                conn.send_binary(payload)

        srv = S.WsServer(on_message=on_message)
        srv.start()
        try:
            conn = C.ws_connect("127.0.0.1", srv.port)
            conn.send_text("abc")
            assert conn.recv() == (C.OP_TEXT, b"cba")
            blob = bytes(range(256)) * 300
            conn.send_binary(blob)
            assert conn.recv() == (C.OP_BINARY, blob)
            conn.close()
            assert seen == [(S.OP_TEXT, b"abc"), (S.OP_BINARY, blob)]
        finally:
            srv.stop()


# -- subscriptions -------------------------------------------------------------

def _steady_push(ev: dict) -> tuple:
    res = ev["result"]
    if ev["kind"] == "newBlockHeaders":
        res = rpc.steady(res)
    return ev["kind"], res


def _subscriptions(root: str, kind: str):
    """One WsSdkClient session holding all four kinds of subscription;
    two waves sent through a second session. -> the pushes by kind, in
    order, and the polled receipts."""
    WsSdkClient = pb.mod(root, "sdk.ws").WsSdkClient
    with rpc.serving(root, kind, rpc_port=0, ws_port=0, tx_count_limit=4,
                     min_seal_time=0.5) as node:
        sub = WsSdkClient("127.0.0.1", node.ws.port)
        cli = WsSdkClient("127.0.0.1", node.ws.port)
        sdk = rpc.client(root, node)
        try:
            waves = [rpc.frames(kind, rpc.REGISTERS, "sub"),
                     rpc.frames(kind, rpc.TRANSFERS, "sub2")]
            suite = node.suite
            T = pb.mod(root, "protocol")
            hashes = [T.Transaction.decode(w).hash(suite) for wave in waves for w in wave]
            sub.subscribe("newBlockHeaders")
            sub.subscribe("pendingTransactions")
            sub.subscribe("logs", {"topics": [["0x" + b"transfer".hex()]]})
            for h in (hashes[0], hashes[5]):
                sub.subscribe("receipt", {"txHash": "0x" + h.hex()})
            for wave in waves:
                for w in wave:
                    res = cli.request("sendTransaction", ["group0", "", "0x" + w.hex(),
                                                          False, False])
                    assert res["status"] is None
                for w in wave:
                    h = T.Transaction.decode(w).hash(suite)
                    assert node.txpool.wait_for_receipt(h, 30) is not None
            events = []
            want = 7 + 2 + 2 + 2   # pending txs, headers, transfer logs, receipts
            deadline = time.monotonic() + 30
            while len(events) < want and time.monotonic() < deadline:
                ev = sub.next_event(0.2)
                if ev is not None:
                    events.append(_steady_push(ev))
            assert sub.next_event(0.3) is None
            by_kind = {}
            for k, res in events:
                by_kind.setdefault(k, []).append(res)
            polled = [sdk.get_transaction_receipt("0x" + h.hex()) for h in (hashes[0],
                                                                             hashes[5])]
            return by_kind, polled, node.subhub.stats()["sessions"]
        finally:
            for c in (sub, cli, sdk):
                c.close()


@pytest.mark.parametrize("kind", rpc.CHAINS)
def test_subscriptions_push_what_jax_pushes(kind):
    want = _subscriptions(JAX, kind)
    got = _subscriptions(PORT, kind)
    assert got == want
    by_kind, polled, _ = got
    assert {k: len(v) for k, v in by_kind.items()} == {
        "pendingTransactions": 7, "newBlockHeaders": 2, "logs": 2, "receipt": 2}
    assert by_kind["receipt"] == polled      # a push equals the polled JSON
    assert [h["number"] for h in by_kind["newBlockHeaders"]] == [1, 2]


# -- AMOP --------------------------------------------------------------------

def _amop_net(root: str):
    gw = pb.mod(root, "net.gateway").FakeGateway()
    front = pb.mod(root, "net.front").FrontService
    amop = pb.mod(root, "net.amop").AMOPService
    fronts = [front(bytes([i + 1]) * 32, gw) for i in range(3)]
    return gw, fronts, [amop(f) for f in fronts]


def _wait(pred, timeout=10.0):
    assert pb.wait_until(pred, timeout)


def _amop_service(root: str):
    gw, fronts, svcs = _amop_net(root)
    got, hits, ev = [], [], threading.Event()
    try:
        svcs[1].subscribe("weather", lambda t, d, s: got.append((t, d, s)) or b"reply:" + d)
        _wait(lambda: svcs[0].peer_subscribers("weather") == [fronts[1].node_id])
        out = [svcs[0].publish("weather", b"sunny?")]

        def mk(i):
            def h(topic, data, src):
                hits.append((i, data))
                if len(hits) >= 2:
                    ev.set()
            return h

        svcs[1].subscribe("news", mk(1))
        svcs[2].subscribe("news", mk(2))
        _wait(lambda: len(svcs[0].peer_subscribers("news")) == 2)
        out.append(svcs[0].broadcast("news", b"flash"))
        assert ev.wait(10)
        svcs[1].unsubscribe("weather")
        _wait(lambda: not svcs[0].peer_subscribers("weather"))
        out.append(svcs[0].publish("weather", b"again", timeout=0.5))
        return out, got, sorted(hits), [s.topics() for s in svcs]
    finally:
        gw.stop()


def _amop_bridge(root: str):
    """Two WS sessions on a node with a front: a unicast round trip, a
    broadcast, a self-publish on one session, an unsubscribed topic."""
    WsSdkClient = pb.mod(root, "sdk.ws").WsSdkClient
    gw = pb.mod(root, "net.gateway").FakeGateway()
    N = pb.mod(root, "init.node")
    jkeys, pkeys = pb.node_keys("ecdsa", 1)
    node = N.Node(rpc.node_config(root, ws_port=0), gateway=gw,
                  keypair=(jkeys if root == JAX else pkeys)[0])
    node.start()
    sub = WsSdkClient("127.0.0.1", node.ws.port)
    pub = WsSdkClient("127.0.0.1", node.ws.port)
    try:
        received = []
        sub.subscribe_topic("orders", lambda t, d: received.append((t, d)) or b"pong:" + d)
        out = [pub.publish_topic("orders", b"ping1")]
        sub.broadcast_topic("orders", b"fanout")
        _wait(lambda: len(received) >= 2)
        pub.subscribe_topic("self", lambda t, d: b"me:" + d)
        out.append(pub.publish_topic("self", b"loop"))
        sub.unsubscribe_topic("orders")
        out.append(pub.publish_topic("orders", b"ping2"))
        return out, received, sorted(node.amop.topics())
    finally:
        sub.close()
        pub.close()
        node.stop()
        gw.stop()


AMOP = {"service": _amop_service, "ws_bridge": _amop_bridge}


@pytest.mark.parametrize("case", sorted(AMOP))
def test_amop_publish_and_subscribe_match_jax(case):
    want = AMOP[case](JAX)
    got = AMOP[case](PORT)
    assert got == want
    if case == "service":
        out, got_msgs, hits, _ = got
        assert out == [b"reply:sunny?", 2, None]
        assert got_msgs == [("weather", b"sunny?", bytes([1]) * 32)]
        assert hits == [(1, b"flash"), (2, b"flash")]
    else:
        out, received, _ = got
        assert out == [b"pong:ping1", b"me:loop", None]
        assert received == [("orders", b"ping1"), ("orders", b"fanout")]
