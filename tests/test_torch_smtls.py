"""The port's SM-TLS (net/smtls.py) against the JAX package's: the cases of
tests/test_smtls.py and tests/test_smtls_adversarial.py run on the port;
credentials issued from the same seeds encode to the same bytes; the
record layer's HMAC-SM3 and KDF (the port hashes with the native SM3) and
a record's bytes on the wire (the port's SM4-CTR enciphers a record's
blocks at once) equal the JAX package's; and a port endpoint completes
the handshake with a JAX endpoint in either role, records flowing both
ways.
"""

import socket
import struct
import threading
import time

import pytest

from fisco_bcos_tpu.net import smtls as jtls
from fisco_bcos_tpu_torch.crypto import refimpl
from fisco_bcos_tpu_torch.net.smtls import (
    Certificate,
    CertificateAuthority,
    SMSocket,
    SMTLSContext,
    SMTLSError,
    _hmac_sm3,
    _sm3_kdf,
)


def _pair_handshake(server_ctx, client_ctx):
    a, b = socket.socketpair()
    out = {}

    def srv():
        out["server"] = server_ctx.wrap_socket(a, server_side=True)

    t = threading.Thread(target=srv)
    t.start()
    out["client"] = client_ctx.wrap_socket(b, server_side=False)
    t.join(10)
    return out["client"], out["server"]


def _recv_all(sock, n: int) -> bytes:
    got = b""
    while len(got) < n:
        chunk = sock.recv(n - len(got))
        assert chunk, "EOF before the record's end"
        got += chunk
    return got


# -- tests/test_smtls.py's cases on the port ---------------------------------

def test_ca_issue_and_verify():
    ca = CertificateAuthority(seed=b"ca-seed" * 4)
    cred = ca.issue("node0", seed=b"node0-seed")
    assert CertificateAuthority.verify_cert(ca.pub, cred.sign_cert)
    assert CertificateAuthority.verify_cert(ca.pub, cred.enc_cert)
    assert cred.sign_cert.usage == 0 and cred.enc_cert.usage == 1
    assert cred.sign_cert.pub != cred.enc_cert.pub
    again = Certificate.decode(cred.sign_cert.encode())
    assert again == cred.sign_cert
    bad = Certificate("node1", again.usage, again.pub, again.serial, again.sig)
    assert not CertificateAuthority.verify_cert(ca.pub, bad)


def test_handshake_and_records_both_ways():
    ca = CertificateAuthority(seed=b"ca2" * 8)
    srv_ctx = SMTLSContext(ca.pub, ca.issue("server", seed=b"s" * 8))
    cli_ctx = SMTLSContext(ca.pub, ca.issue("client", seed=b"c" * 8))
    c, s = _pair_handshake(srv_ctx, cli_ctx)
    assert c.peer_subject == "server" and s.peer_subject == "client"
    c.sendall(b"ping " * 1000)
    assert _recv_all(s, 5000) == b"ping " * 1000
    s.sendall(b"pong")
    assert c.recv(4) == b"pong"
    c.close()
    s.close()


def test_untrusted_ca_rejected():
    ca1 = CertificateAuthority(seed=b"trusted!" * 4)
    ca2 = CertificateAuthority(seed=b"intruder" * 4)
    srv_ctx = SMTLSContext(ca1.pub, ca1.issue("server"))
    rogue_ctx = SMTLSContext(ca1.pub, ca2.issue("mallory"))
    a, b = socket.socketpair()
    err = {}

    def srv():
        try:
            srv_ctx.wrap_socket(a, server_side=True)
        except SMTLSError as e:
            err["server"] = e

    t = threading.Thread(target=srv)
    t.start()
    with pytest.raises(SMTLSError):
        rogue_ctx.wrap_socket(b, server_side=False)
    t.join(10)
    assert "server" in err


def test_hmac_sm3_keyed_and_deterministic():
    t1 = _hmac_sm3(b"k1", b"message")
    t2 = _hmac_sm3(b"k2", b"message")
    assert t1 != t2 and t1 == _hmac_sm3(b"k1", b"message") and len(t1) == 32


def test_transcript_signature_is_role_bound():
    ca = CertificateAuthority(seed=b"ca4" * 8)
    cred = ca.issue("node", seed=b"n" * 8)
    t_digest = refimpl.sm3(b"some-transcript")
    client_sig = refimpl.sm2_sign(cred.sign_key, refimpl.sm3(b"client" + t_digest))
    assert not refimpl.sm2_verify(cred.sign_cert.pub, refimpl.sm3(b"server" + t_digest),
                                  *client_sig)
    assert refimpl.sm2_verify(cred.sign_cert.pub, refimpl.sm3(b"client" + t_digest),
                              *client_sig)


def _gateways(ids, ctxs):
    from fisco_bcos_tpu_torch.net.p2p import P2PGateway

    return [P2PGateway(i, server_ssl=c, client_ssl=c) for i, c in zip(ids, ctxs)]


def test_gateway_over_smtls():
    """Two port P2P gateways linked through SM-TLS contexts deliver front
    traffic, each session an SMSocket."""
    ca = CertificateAuthority(seed=b"chain-ca" * 4)
    ids = [b"\x01" * 32, b"\x02" * 32]
    gws = _gateways(ids, [SMTLSContext(ca.pub, ca.issue(f"node{i}", seed=bytes([i]) * 8))
                          for i in range(2)])
    gws[0].add_peer(gws[1].host, gws[1].port)
    gws[1].add_peer(gws[0].host, gws[0].port)
    got = {}

    class FakeFront:
        def __init__(self, name):
            self.name = name

        def on_network_message(self, src, payload):
            got[self.name] = (src, payload)

    try:
        gws[0].register_front(ids[0], FakeFront("a"))
        gws[1].register_front(ids[1], FakeFront("b"))
        t0 = time.monotonic()
        while time.monotonic() - t0 < 20:
            if gws[0].send(ids[0], ids[1], b"hello-sm") and "b" in got:
                break
            time.sleep(0.05)
        assert got.get("b") == (ids[0], b"hello-sm"), got
        assert gws[1].send(ids[1], ids[0], b"yo")
        t0 = time.monotonic()
        while "a" not in got and time.monotonic() - t0 < 10:
            time.sleep(0.05)
        assert got.get("a") == (ids[1], b"yo")
        assert all(isinstance(s.sock, SMSocket) for g in gws for s in g._sessions.values())
    finally:
        for gw in gws:
            gw.stop()


def test_gateway_accept_survives_garbage_dial():
    ca = CertificateAuthority(seed=b"acc-ca" * 5)
    ids = [b"\x07" * 32, b"\x08" * 32]
    gws = _gateways(ids, [SMTLSContext(ca.pub, ca.issue(f"n{i}", seed=bytes([9 + i]) * 8))
                          for i in range(2)])

    class NullFront:
        def on_network_message(self, src, payload):
            pass

    try:
        gws[0].register_front(ids[0], NullFront())
        s = socket.create_connection((gws[0].host, gws[0].port), timeout=5)
        s.sendall(b"\x00\x00\x00\x04junk")
        s.close()
        time.sleep(0.2)
        gws[1].register_front(ids[1], NullFront())
        gws[1].add_peer(gws[0].host, gws[0].port)
        gws[0].add_peer(gws[1].host, gws[1].port)
        t0 = time.monotonic()
        while time.monotonic() - t0 < 15 and len(gws[0].peers()) != 1:
            time.sleep(0.05)
        assert len(gws[0].peers()) == 1, "accept loop died after garbage dial"
    finally:
        for gw in gws:
            gw.stop()


# -- tests/test_smtls_adversarial.py's cases on the port ---------------------

HANDSHAKE_FRAMES = 2  # hello + transcript signature, each direction


def _read_frame(src):
    head = src.recv(4)
    if len(head) < 4:
        raise OSError("closed")
    (ln,) = struct.unpack(">I", head)
    body = b""
    while len(body) < ln:
        chunk = src.recv(ln - len(body))
        if not chunk:
            raise OSError("closed")
        body += chunk
    return head + body


def handshake_through_mitm(mutator=None):
    """Client <-> MITM <-> server; the MITM forwards the handshake, then
    hands the raw sockets to `mutator`. -> (client, server)."""
    ca = CertificateAuthority(seed=b"adv" * 8)
    srv_ctx = SMTLSContext(ca.pub, ca.issue("server"))
    cli_ctx = SMTLSContext(ca.pub, ca.issue("client"))
    c_inner, mitm_c = socket.socketpair()
    mitm_s, s_inner = socket.socketpair()

    def pump():
        try:
            for _ in range(HANDSHAKE_FRAMES):
                for src, dst in ((mitm_c, mitm_s), (mitm_s, mitm_c)):
                    dst.sendall(_read_frame(src))
            if mutator is not None:
                mutator(mitm_c, mitm_s)
        except OSError:
            pass

    threading.Thread(target=pump, daemon=True).start()
    res = {}

    def srv():
        try:
            res["sock"] = srv_ctx.wrap_socket(s_inner, server_side=True)
        except SMTLSError as exc:
            res["err"] = exc

    st = threading.Thread(target=srv, daemon=True)
    st.start()
    client = cli_ctx.wrap_socket(c_inner, server_side=False)
    st.join(10)
    return client, res.get("sock")


def _truncate(mitm_c, mitm_s):
    frame = _read_frame(mitm_c)
    mitm_s.sendall(frame[:len(frame) // 2])
    mitm_s.close()


def _splice(mitm_c, mitm_s):
    body = _read_frame(mitm_c)[4:] + _read_frame(mitm_c)[4:]
    mitm_s.sendall(struct.pack(">I", len(body)) + body)


def _reflect(mitm_c, mitm_s):
    mitm_c.sendall(_read_frame(mitm_c))


def _reorder(mitm_c, mitm_s):
    f1, f2 = _read_frame(mitm_c), _read_frame(mitm_c)
    mitm_s.sendall(f2)
    mitm_s.sendall(f1)


def _inject_hello(mitm_c, mitm_s):
    ca2 = CertificateAuthority(seed=b"evil" * 8)
    ctx2 = SMTLSContext(ca2.pub, ca2.issue("mallory"))
    _sk, eph_pub = refimpl.keygen(refimpl.SM2P256V1, b"e" * 16)
    hello = ctx2._hello(b"\x41" * 32, eph_pub)
    mitm_s.sendall(struct.pack(">I", len(hello)) + hello)


def _oversize(mitm_c, mitm_s):
    mitm_s.sendall(struct.pack(">I", (16 * 1024 * 1024) + 1))
    mitm_s.sendall(b"\x00" * 64)


def _tamper(mitm_c, mitm_s):
    flipped = bytearray(_read_frame(mitm_c))
    flipped[14] ^= 0x01   # inside the ciphertext
    mitm_s.sendall(bytes(flipped))


# (mutator, what the client sends, whose recv must fail closed)
ATTACKS = {
    "truncated_record_yields_eof_not_plaintext": (_truncate, [b"top secret payload"], "eof"),
    "spliced_records_rejected": (_splice, [b"record one", b"record two"], "server"),
    "reflection_rejected": (_reflect, [b"bounce me"], "client"),
    "reordered_records_rejected": (_reorder, [b"first", b"second"], "server"),
    "mid_stream_hello_injection_rejected": (_inject_hello, [], "server"),
    "oversized_record_header_rejected": (_oversize, [], "server"),
    "record_tamper_detected": (_tamper, [b"secret message"], "server"),
}


@pytest.mark.parametrize("case", sorted(ATTACKS))
def test_active_attacks_fail_closed(case):
    mutator, sends, victim = ATTACKS[case]
    c, s = handshake_through_mitm(mutator)
    try:
        for m in sends:
            c.sendall(m)
        if victim == "eof":
            try:
                assert s.recv(64) == b""
            except SMTLSError:
                pass
        else:
            with pytest.raises(SMTLSError):
                (c if victim == "client" else s).recv(64)
    finally:
        c.close()
        s.close()


def test_handshake_frame_truncation_fails_closed():
    ca = CertificateAuthority(seed=b"dg" * 8)
    srv_ctx = SMTLSContext(ca.pub, ca.issue("server"))
    cli_ctx = SMTLSContext(ca.pub, ca.issue("client"))
    c_inner, mitm_c = socket.socketpair()
    mitm_s, s_inner = socket.socketpair()

    def pump():
        try:
            frame = _read_frame(mitm_c)
            mitm_s.sendall(frame[:4] + frame[4:4 + (len(frame) - 4) // 3])
            mitm_s.close()
            mitm_c.close()
        except OSError:
            pass

    threading.Thread(target=pump, daemon=True).start()
    res = {}

    def srv():
        try:
            res["sock"] = srv_ctx.wrap_socket(s_inner, server_side=True)
        except (SMTLSError, OSError) as exc:
            res["err"] = exc

    st = threading.Thread(target=srv, daemon=True)
    st.start()
    with pytest.raises((SMTLSError, OSError)):
        cli_ctx.wrap_socket(c_inner, server_side=False)
    st.join(10)
    assert "sock" not in res


# -- the port against the JAX package -----------------------------------------

def test_credentials_and_certificates_equal_the_jax_package():
    ca, jca = CertificateAuthority(seed=b"x-ca" * 8), jtls.CertificateAuthority(seed=b"x-ca" * 8)
    assert ca.pub == jca.pub
    for subject in ("node0", "node1"):
        cred = ca.issue(subject, seed=subject.encode() * 4)
        jcred = jca.issue(subject, seed=subject.encode() * 4)
        assert cred.encode() == jcred.encode()
        assert jtls.CertificateAuthority.verify_cert(ca.pub, jtls.Certificate.decode(
            cred.sign_cert.encode()))
        assert jtls.Credential.decode(cred.encode()).encode() == cred.encode()


@pytest.mark.parametrize("n", (0, 1, 55, 64, 65, 4096, 100_003))
def test_hmac_and_kdf_equal_the_jax_package(n):
    msg = bytes((7 * i + n) & 0xFF for i in range(n))
    for key in (b"k" * 32, b"K" * 64, b"long key " * 9):
        assert _hmac_sm3(key, msg) == jtls._hmac_sm3(key, msg)
    assert _sm3_kdf(msg[:48], b"label", 96) == jtls._sm3_kdf(msg[:48], b"label", 96)
    assert _sm3_kdf(b"s", msg[:17], 31) == jtls._sm3_kdf(b"s", msg[:17], 31)


@pytest.mark.parametrize("alg", ("sm4", "aes"))
def test_records_on_the_wire_equal_the_jax_package(alg):
    """Sockets of both packages on the same keys put the same bytes on the
    wire for the same records, and each reads the other's."""
    keys = (b"\x11" * 16, b"\x22" * 16, b"\x33" * 32, b"\x44" * 32)
    records = [b"a", b"x" * 4097, bytes(range(256)) * 300]
    wires = []
    for mod in (jtls, None):
        a, b = socket.socketpair()
        sock = (mod.SMSocket if mod else SMSocket)(a, *keys, alg, "peer", None)
        for r in records:
            sock.sendall(r)
        sock.close()
        raw = b""
        while True:
            chunk = b.recv(1 << 16)
            if not chunk:
                break
            raw += chunk
        b.close()
        wires.append(raw)
    assert wires[1] == wires[0]
    # the record's receiver: recv and send keys swapped
    rkeys = (keys[1], keys[0], keys[3], keys[2])
    for rmod in (jtls, None):
        a, b = socket.socketpair()
        b.sendall(wires[1])
        b.close()
        rx = (rmod.SMSocket if rmod else SMSocket)(a, *rkeys, alg, "peer", None)
        for r in records:
            assert _recv_all(rx, len(r)) == r
        rx.close()


@pytest.mark.parametrize("port_role", ("server", "client"))
def test_sessions_across_the_packages(port_role):
    """A port endpoint and a JAX endpoint under one CA complete the
    handshake in either role and exchange records both ways."""
    ca = CertificateAuthority(seed=b"mixed-ca" * 4)
    jca = jtls.CertificateAuthority(seed=b"mixed-ca" * 4)
    port_ctx = SMTLSContext(ca.pub, ca.issue("port", seed=b"p" * 8))
    jax_ctx = jtls.SMTLSContext(jca.pub, jca.issue("jax", seed=b"j" * 8))
    if port_role == "server":
        c, s = _pair_handshake(port_ctx, jax_ctx)
        assert isinstance(s, SMSocket) and isinstance(c, jtls.SMSocket)
    else:
        c, s = _pair_handshake(jax_ctx, port_ctx)
        assert isinstance(c, SMSocket) and isinstance(s, jtls.SMSocket)
    assert {c.peer_subject, s.peer_subject} == {"port", "jax"}
    big = bytes(range(256)) * 1000   # past a socket pair's buffer: sent beside the read
    t = threading.Thread(target=c.sendall, args=(big,))
    t.start()
    assert _recv_all(s, len(big)) == big
    t.join(10)
    s.sendall(b"pong" * 9)
    assert _recv_all(c, 36) == b"pong" * 9
    c.close()
    s.close()
