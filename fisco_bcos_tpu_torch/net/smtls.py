"""SM-TLS analogue: 国密 dual-certificate secure transport for P2P/RPC.

Reference counterpart: FISCO-BCOS bcos-boostssl/bcos-boostssl/context/
ContextBuilder.cpp (`buildSslContext` selects a GMSSL dual-cert context when
`sm_crypto` is on: a *sign* cert/key pair for authentication plus a separate
*enc* cert/key pair for key exchange, all SM2, with SM4 record protection)
and NodeConfig.cpp:355-459 (cert section). CPython's `ssl` module cannot
speak GB/T 38636 TLCP, so this module implements the same trust shape as an
application-layer channel:

COMPATIBILITY NOTE: the wire format is NOT GB/T 38636 (TLCP); it will not
interoperate with TASSL/GMSSL peers. Both ends of every link must run this
framework (all node/SDK transports here do). The trust model, dual-cert
discipline and algorithm suite (SM2/SM3/SM4) match the reference; the
record framing is this module's own, with fail-closed semantics verified
by tests/test_smtls_adversarial.py and, for this package,
tests/test_torch_smtls.py (truncation, splicing, reflection, reorder,
injection, oversize).

* **Dual-cert credentials** — every endpoint holds a SIGN keypair (proves
  identity) and a separate ENC keypair (participates in key agreement),
  each wrapped in a minimal SM2-signed certificate chained to a shared CA.
* **Handshake** — one hello each way over length-prefixed frames: 32-byte
  random, both certs, an ephemeral SM2 public key, and an SM2 signature by
  the SIGN key over the role-labelled transcript (binds randoms + certs +
  ephemerals + the signer's client/server role, so nothing can be spliced
  across sessions and a signature can never be reflected back at its
  producer by a cert-mirroring man in the middle).
* **Key schedule** — three ECDH contributions feed an SM3 KDF:
  Z_ee (ephemeral x ephemeral) for forward secrecy plus Z_ce / Z_sc
  (each side's static ENC key x the peer's ephemeral), which is what makes
  the ENC cert load-bearing exactly as in the TLCP suites. Directional SM4
  keys + IV seeds come out of the KDF.
* **Records** — u32 length | u64 sequence | SM4-CTR ciphertext |
  SM3-keyed tag over (seq | ciphertext). Sequence numbers are explicit and
  strictly checked, so replayed or reordered records tear the channel down.

`SMTLSContext.wrap_socket(sock, server_side=...)` mirrors the
`ssl.SSLContext` calling convention used by `net.p2p.P2PGateway`, so the
same `server_ssl=`/`client_ssl=` seams accept either standard TLS contexts
or these (matching the reference, where the gateway is agnostic to which
ContextBuilder flavor produced its asio context).

The record path computes the same bytes as the JAX package's copy, by
other means: SM4-CTR enciphers all of a record's counter blocks at once
(crypto/symm.py `BlockCipher.ctr`, numpy uint32 arrays), and the HMAC and
the KDF hash with the native SM3 (crypto/nativehash.py `host_hash`)
instead of the pure-Python `refimpl.sm3`. The handshake's SM2 arithmetic
is refimpl's, as in the JAX package's.
"""

from __future__ import annotations

import functools
import hmac
import os
import socket
import struct
import threading
from dataclasses import dataclass
from typing import Optional

from ..codec.wire import Reader, Writer
from ..crypto import refimpl
from ..crypto.nativehash import host_hash
from ..crypto.symm import BlockCipher

_CURVE = refimpl.SM2P256V1
_MAGIC = b"SMT1"
_MAX_RECORD = 16 * 1024 * 1024
_USAGE_SIGN, _USAGE_ENC = 0, 1


class SMTLSError(OSError):
    """Handshake or record-layer failure (subclass of OSError so existing
    socket error handling in the gateway treats it as a dead link)."""


@functools.cache
def _host_sm3():
    """The host SM3, resolved on first use: native when it loads."""
    return host_hash("sm3")


def _sm3(data: bytes) -> bytes:
    return _host_sm3()(data)


def _hmac_sm3(key: bytes, msg: bytes) -> bytes:
    """HMAC over SM3 (RFC 2104 with SM3's 64-byte block)."""
    if len(key) > 64:
        key = _sm3(key)
    key = key.ljust(64, b"\x00")
    inner = _sm3(bytes(k ^ 0x36 for k in key) + msg)
    return _sm3(bytes(k ^ 0x5C for k in key) + inner)


def _sm3_kdf(secret: bytes, label: bytes, length: int) -> bytes:
    out = b""
    counter = 1
    while len(out) < length:
        out += _sm3(secret + label + struct.pack(">I", counter))
        counter += 1
    return out[:length]


def _point_bytes(P) -> bytes:
    return P[0].to_bytes(32, "big") + P[1].to_bytes(32, "big")


def _parse_point(b: bytes):
    if len(b) != 64:
        raise SMTLSError("bad point encoding")
    P = (int.from_bytes(b[:32], "big"), int.from_bytes(b[32:], "big"))
    if not refimpl.ec_on_curve(_CURVE, P):
        raise SMTLSError("point not on curve")
    return P


def _ecdh(priv: int, pub) -> bytes:
    Z = refimpl.ec_mul(_CURVE, priv, pub)
    if Z is None:
        raise SMTLSError("degenerate ECDH share")
    return Z[0].to_bytes(32, "big")


# ---------------------------------------------------------------------------
# minimal SM2 certificates
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Certificate:
    """Minimal cert: who, which key, what for, signed by the CA's SIGN key.

    Stands in for the X.509v3 pair the reference loads from
    `sm_ssl.sign_cert` / `sm_ssl.en_cert` (NodeConfig.cpp cert section);
    the framework's wire codec keeps it deterministic and tiny.
    """

    subject: str
    usage: int  # _USAGE_SIGN | _USAGE_ENC
    pub: tuple  # SM2 public point
    serial: int
    sig: tuple  # CA SM2 signature (r, s) over tbs()

    def tbs(self) -> bytes:
        w = Writer()
        w.blob(self.subject.encode())
        w.u8(self.usage)
        w.blob(_point_bytes(self.pub))
        w.u64(self.serial)
        return w.bytes()

    def encode(self) -> bytes:
        w = Writer()
        w.blob(self.tbs())
        w.blob(self.sig[0].to_bytes(32, "big"))
        w.blob(self.sig[1].to_bytes(32, "big"))
        return w.bytes()

    @classmethod
    def decode(cls, blob: bytes) -> "Certificate":
        r = Reader(blob)
        tbs = r.blob()
        sr = int.from_bytes(r.blob(), "big")
        ss = int.from_bytes(r.blob(), "big")
        tr = Reader(tbs)
        subject = tr.blob().decode()
        usage = tr.u8()
        pub = _parse_point(tr.blob())
        serial = tr.u64()
        return cls(subject, usage, pub, serial, (sr, ss))


@dataclass(frozen=True)
class Credential:
    """One endpoint's dual-cert identity."""

    sign_cert: Certificate
    sign_key: int
    enc_cert: Certificate
    enc_key: int

    def encode(self) -> bytes:
        """Serialize certs + private keys (the analogue of the node's
        sm_ssl.sign_key/en_key PEM files — protect at rest with
        security.DataEncryption exactly like node.key)."""
        w = Writer()
        w.blob(self.sign_cert.encode())
        w.blob(self.sign_key.to_bytes(32, "big"))
        w.blob(self.enc_cert.encode())
        w.blob(self.enc_key.to_bytes(32, "big"))
        return w.bytes()

    @classmethod
    def decode(cls, blob: bytes) -> "Credential":
        r = Reader(blob)
        sign_cert = Certificate.decode(r.blob())
        sign_key = int.from_bytes(r.blob(), "big")
        enc_cert = Certificate.decode(r.blob())
        enc_key = int.from_bytes(r.blob(), "big")
        return cls(sign_cert, sign_key, enc_cert, enc_key)


class CertificateAuthority:
    """Issues dual-cert credentials; its SIGN public key is the trust root
    (the analogue of the chain CA cert build_chain.sh generates)."""

    def __init__(self, seed: Optional[bytes] = None, name: str = "fbtpu-ca"):
        self.name = name
        self._key, self.pub = refimpl.keygen(_CURVE, seed)
        self._serial = 0
        self._lock = threading.Lock()

    def _issue_one(self, subject: str, usage: int, pub) -> Certificate:
        with self._lock:
            self._serial += 1
            serial = self._serial
        tbs = Certificate(subject, usage, pub, serial, (0, 0)).tbs()
        digest = refimpl.sm3(tbs)
        sig = refimpl.sm2_sign(self._key, digest)
        return Certificate(subject, usage, pub, serial, sig)

    def issue(self, subject: str,
              seed: Optional[bytes] = None) -> Credential:
        sk_sign, pub_sign = refimpl.keygen(
            _CURVE, None if seed is None else refimpl.sm3(seed + b"sign"))
        sk_enc, pub_enc = refimpl.keygen(
            _CURVE, None if seed is None else refimpl.sm3(seed + b"enc"))
        return Credential(
            self._issue_one(subject, _USAGE_SIGN, pub_sign), sk_sign,
            self._issue_one(subject, _USAGE_ENC, pub_enc), sk_enc)

    @staticmethod
    def verify_cert(ca_pub, cert: Certificate) -> bool:
        digest = refimpl.sm3(cert.tbs())
        return refimpl.sm2_verify(ca_pub, digest, *cert.sig)


# ---------------------------------------------------------------------------
# record-protected socket
# ---------------------------------------------------------------------------

def _send_frame(sock: socket.socket, payload: bytes) -> None:
    sock.sendall(struct.pack(">I", len(payload)) + payload)


class SMTLSClosed(SMTLSError):
    """Clean connection close (EOF at a record boundary) — the only
    framing condition `SMSocket.recv` maps to b'' EOF semantics;
    protocol violations (oversized/truncated records) raise."""


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            if not buf:
                raise SMTLSClosed("peer closed SM-TLS connection")
            raise SMTLSError("truncated SM-TLS record")
        buf += chunk
    return buf


def _recv_frame(sock: socket.socket) -> bytes:
    (length,) = struct.unpack(">I", _recv_exact(sock, 4))
    if length > _MAX_RECORD:
        raise SMTLSError("oversized SM-TLS record")
    try:
        return _recv_exact(sock, length)
    except SMTLSClosed:
        # EOF after the header is a torn record, not a clean close
        raise SMTLSError("truncated SM-TLS record") from None


class SMSocket:
    """Socket facade carrying SM4-CTR + SM3-MAC records.

    Exposes the subset of the `ssl.SSLSocket` surface the gateway uses:
    sendall / recv / close / getsockname / getpeername, plus the
    authenticated peer identity (`peer_subject`, `peer_sign_pub`).
    """

    def __init__(self, sock: socket.socket, send_key: bytes, recv_key: bytes,
                 send_mac: bytes, recv_mac: bytes, algorithm: str,
                 peer_subject: str, peer_sign_pub):
        self._sock = sock
        self._send_cipher = BlockCipher(algorithm, send_key)
        self._recv_cipher = BlockCipher(algorithm, recv_key)
        self._send_mac = send_mac
        self._recv_mac = recv_mac
        self._send_seq = 0
        self._recv_seq = 0
        self._rbuf = b""
        self._slock = threading.Lock()
        self.peer_subject = peer_subject
        self.peer_sign_pub = peer_sign_pub

    @staticmethod
    def _tag(mac_key: bytes, seq: bytes, ct: bytes) -> bytes:
        return _hmac_sm3(mac_key, seq + ct)

    def sendall(self, data: bytes) -> None:
        with self._slock:
            seq = struct.pack(">Q", self._send_seq)
            self._send_seq += 1
            iv = seq + bytes(8)
            ct = self._send_cipher.ctr(iv, data)
            tag = self._tag(self._send_mac, seq, ct)
            _send_frame(self._sock, seq + ct + tag)

    def recv(self, n: int) -> bytes:
        if not self._rbuf:
            try:
                rec = _recv_frame(self._sock)
            except SMTLSClosed:
                return b""  # clean close: EOF for the caller's read loop
            if len(rec) < 40:
                raise SMTLSError("short SM-TLS record")
            seq, ct, tag = rec[:8], rec[8:-32], rec[-32:]
            if struct.unpack(">Q", seq)[0] != self._recv_seq:
                raise SMTLSError("SM-TLS sequence violation (replay?)")
            # constant-time compare: rules out timing-assisted tag forgery
            if not hmac.compare_digest(
                    self._tag(self._recv_mac, seq, ct), tag):
                raise SMTLSError("SM-TLS record MAC mismatch")
            self._recv_seq += 1
            self._rbuf = self._recv_cipher.ctr(seq + bytes(8), ct)
        out, self._rbuf = self._rbuf[:n], self._rbuf[n:]
        return out

    def close(self) -> None:
        self._sock.close()

    def getsockname(self):
        return self._sock.getsockname()

    def getpeername(self):
        return self._sock.getpeername()


# ---------------------------------------------------------------------------
# context / handshake
# ---------------------------------------------------------------------------

class SMTLSContext:
    """Dual-cert channel factory, call-compatible with `ssl.SSLContext`
    where the P2P gateway and service sockets use it."""

    def __init__(self, ca_pub, credential: Credential,
                 algorithm: str = "sm4"):
        self.ca_pub = ca_pub
        self.cred = credential
        self.algorithm = algorithm

    # -- hello construction -------------------------------------------------
    def _hello(self, random_: bytes, eph_pub) -> bytes:
        w = Writer()
        w.blob(_MAGIC)
        w.blob(random_)
        w.blob(self.cred.sign_cert.encode())
        w.blob(self.cred.enc_cert.encode())
        w.blob(_point_bytes(eph_pub))
        return w.bytes()

    def _check_peer(self, hello: bytes):
        r = Reader(hello)
        if r.blob() != _MAGIC:
            raise SMTLSError("bad SM-TLS magic")
        random_ = r.blob()
        if len(random_) != 32:
            raise SMTLSError("bad hello random")
        sign_cert = Certificate.decode(r.blob())
        enc_cert = Certificate.decode(r.blob())
        eph = _parse_point(r.blob())
        for cert, usage in ((sign_cert, _USAGE_SIGN), (enc_cert, _USAGE_ENC)):
            if cert.usage != usage:
                raise SMTLSError("certificate usage mismatch")
            if not CertificateAuthority.verify_cert(self.ca_pub, cert):
                raise SMTLSError("certificate not signed by trusted CA")
        if sign_cert.subject != enc_cert.subject:
            raise SMTLSError("dual-cert subject mismatch")
        return random_, sign_cert, enc_cert, eph

    def wrap_socket(self, sock: socket.socket, server_side: bool = False,
                    server_hostname: Optional[str] = None) -> SMSocket:
        try:
            return self._handshake(sock, server_side)
        except (OSError, ValueError, struct.error) as exc:
            try:
                sock.close()
            except OSError:
                pass
            raise SMTLSError(f"SM-TLS handshake failed: {exc}") from exc

    def _handshake(self, sock: socket.socket, server_side: bool) -> SMSocket:
        my_random = os.urandom(32)
        eph_priv, eph_pub = refimpl.keygen(_CURVE)
        my_hello = self._hello(my_random, eph_pub)

        if server_side:
            peer_hello = _recv_frame(sock)
            _send_frame(sock, my_hello)
        else:
            _send_frame(sock, my_hello)
            peer_hello = _recv_frame(sock)
        (peer_random, peer_sign_cert, peer_enc_cert,
         peer_eph) = self._check_peer(peer_hello)

        # transcript is ordered client-hello | server-hello on both sides
        transcript = (peer_hello + my_hello if server_side
                      else my_hello + peer_hello)
        t_digest = refimpl.sm3(transcript)

        # exchange transcript signatures (SIGN cert authenticates the
        # ephemerals — splicing either hello breaks both signatures).
        # Each side signs under its own ROLE label: without it, a MITM
        # mirroring the client's public certs could reflect the client's
        # own signature back as the "server" proof.
        my_role = b"server" if server_side else b"client"
        peer_role = b"client" if server_side else b"server"
        my_sig = refimpl.sm2_sign(
            self.cred.sign_key, refimpl.sm3(my_role + t_digest))
        sig_msg = my_sig[0].to_bytes(32, "big") + my_sig[1].to_bytes(32, "big")
        if server_side:
            peer_sig = _recv_frame(sock)
            _send_frame(sock, sig_msg)
        else:
            _send_frame(sock, sig_msg)
            peer_sig = _recv_frame(sock)
        if len(peer_sig) != 64:
            raise SMTLSError("bad transcript signature encoding")
        pr = int.from_bytes(peer_sig[:32], "big")
        ps = int.from_bytes(peer_sig[32:], "big")
        if not refimpl.sm2_verify(peer_sign_cert.pub,
                                  refimpl.sm3(peer_role + t_digest), pr, ps):
            raise SMTLSError("transcript signature verification failed")

        # dual-cert key schedule: Z_ee + both static-ENC contributions.
        # client's Z_ce = ECDH(client eph, server ENC static) equals the
        # server's ECDH(server ENC static key, client eph) — and vice
        # versa, so both ends derive the same ordered triple.
        z_ee = _ecdh(eph_priv, peer_eph)
        z_mine = _ecdh(self.cred.enc_key, peer_eph)  # my ENC x their eph
        z_peer = _ecdh(eph_priv, peer_enc_cert.pub)  # their ENC x my eph
        if server_side:
            z_client_enc, z_server_enc = z_peer, z_mine
            client_random, server_random = peer_random, my_random
        else:
            z_client_enc, z_server_enc = z_mine, z_peer
            client_random, server_random = my_random, peer_random
        master = _sm3_kdf(z_ee + z_client_enc + z_server_enc,
                          b"fbtpu-smtls-master" + client_random
                          + server_random + t_digest, 32)
        key_len = 16
        block = _sm3_kdf(master, b"fbtpu-smtls-keys", 2 * key_len + 64)
        c2s_key, s2c_key = block[:key_len], block[key_len:2 * key_len]
        c2s_mac = block[2 * key_len:2 * key_len + 32]
        s2c_mac = block[2 * key_len + 32:]
        if server_side:
            send_key, recv_key = s2c_key, c2s_key
            send_mac, recv_mac = s2c_mac, c2s_mac
        else:
            send_key, recv_key = c2s_key, s2c_key
            send_mac, recv_mac = c2s_mac, s2c_mac
        return SMSocket(sock, send_key, recv_key, send_mac, recv_mac,
                        self.algorithm, peer_sign_cert.subject,
                        peer_sign_cert.pub)
