"""Discrete-log zero-knowledge proofs + linkable ring signatures.

Reference counterpart: FISCO-BCOS bcos-crypto/bcos-crypto/zkp/
discretezkp/ (WeDPR discrete-log ZKP verifiers: knowledge / equality
proofs behind the ZkpPrecompiled surface) and
FISCO-BCOS bcos-executor/src/precompiled/extension/
RingSigPrecompiled.cpp (ring-signature verification via an external lib).

Implemented natively over the framework's secp256k1 reference arithmetic
(crypto/refimpl.py) rather than an FFI:

  * Schnorr NIZK proof of knowledge of x with P = x*G (Fiat-Shamir).
  * Chaum-Pedersen equality proof: the same x behind P = x*G and Q = x*H
    (the "either-equality" shape WeDPR exposes for confidential amounts).
  * LSAG linkable ring signature (Liu-Wei-Wong): signer hides among n
    public keys; the key image links two signatures by the same key.

All verifiers are deterministic pure functions of their inputs, so they
are precompile-safe (consensus executes them identically everywhere).
"""

from __future__ import annotations

import dataclasses
import hashlib
import hmac
from typing import Optional, Sequence

from . import refimpl

C = refimpl.SECP256K1
G = (C.gx, C.gy)

Point = Optional[tuple[int, int]]


def _h_scalar(*parts: bytes) -> int:
    h = hashlib.sha256()
    for p in parts:
        h.update(len(p).to_bytes(4, "big") + p)
    return int.from_bytes(h.digest(), "big") % C.n


def _enc(P: Point) -> bytes:
    if P is None:
        return b"\x00" * 64
    return P[0].to_bytes(32, "big") + P[1].to_bytes(32, "big")


def _dec(b: bytes) -> Point:
    if len(b) != 64:
        raise ValueError("bad point encoding")
    if b == b"\x00" * 64:
        return None
    P = (int.from_bytes(b[:32], "big"), int.from_bytes(b[32:], "big"))
    if not refimpl.is_on_curve(C, P):
        raise ValueError("point not on curve")
    return P


def _nonce(secret: int, *parts: bytes) -> int:
    """Deterministic nonce (RFC 6979 spirit): never reuse k across msgs."""
    msg = b"".join(len(p).to_bytes(4, "big") + p for p in parts)
    k = hmac.new(secret.to_bytes(32, "big"), msg, hashlib.sha256).digest()
    v = int.from_bytes(k, "big") % C.n
    return v or 1


def hash_to_point(data: bytes) -> tuple[int, int]:
    """Map bytes to a curve point with unknown discrete log (try-and-
    increment over x candidates; p = 3 mod 4 so sqrt is a power)."""
    ctr = 0
    while True:
        x = int.from_bytes(
            hashlib.sha256(data + ctr.to_bytes(4, "big")).digest(),
            "big") % C.p
        rhs = (pow(x, 3, C.p) + C.a * x + C.b) % C.p
        y = pow(rhs, (C.p + 1) // 4, C.p)
        if (y * y) % C.p == rhs:
            return (x, y)
        ctr += 1


# ---------------------------------------------------------------------------
# Schnorr proof of knowledge: P = x*G
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class KnowledgeProof:
    commit: tuple[int, int]  # R = k*G
    response: int  # s = k + c*x mod n

    def encode(self) -> bytes:
        return _enc(self.commit) + self.response.to_bytes(32, "big")

    @classmethod
    def decode(cls, b: bytes) -> "KnowledgeProof":
        return cls(_dec(b[:64]), int.from_bytes(b[64:96], "big"))


def prove_knowledge(x: int, context: bytes = b"") -> KnowledgeProof:
    P = refimpl.ec_mul(C, x, G)
    k = _nonce(x, b"know", _enc(P), context)
    R = refimpl.ec_mul(C, k, G)
    c = _h_scalar(b"know", _enc(G), _enc(P), _enc(R), context)
    return KnowledgeProof(R, (k + c * x) % C.n)


def verify_knowledge(P: tuple[int, int], proof: KnowledgeProof,
                     context: bytes = b"") -> bool:
    if P is None or proof.commit is None or not refimpl.is_on_curve(C, P):
        return False
    c = _h_scalar(b"know", _enc(G), _enc(P), _enc(proof.commit), context)
    lhs = refimpl.ec_mul(C, proof.response % C.n, G)
    rhs = refimpl.ec_add(C, proof.commit, refimpl.ec_mul(C, c, P))
    return lhs == rhs


# ---------------------------------------------------------------------------
# Chaum-Pedersen equality: P = x*G and Q = x*H share the same x
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class EqualityProof:
    commit_g: tuple[int, int]
    commit_h: tuple[int, int]
    response: int

    def encode(self) -> bytes:
        return (_enc(self.commit_g) + _enc(self.commit_h)
                + self.response.to_bytes(32, "big"))

    @classmethod
    def decode(cls, b: bytes) -> "EqualityProof":
        return cls(_dec(b[:64]), _dec(b[64:128]),
                   int.from_bytes(b[128:160], "big"))


def prove_equality(x: int, H: tuple[int, int],
                   context: bytes = b"") -> EqualityProof:
    P = refimpl.ec_mul(C, x, G)
    Q = refimpl.ec_mul(C, x, H)
    k = _nonce(x, b"eq", _enc(P), _enc(Q), context)
    Rg = refimpl.ec_mul(C, k, G)
    Rh = refimpl.ec_mul(C, k, H)
    c = _h_scalar(b"eq", _enc(G), _enc(H), _enc(P), _enc(Q),
                  _enc(Rg), _enc(Rh), context)
    return EqualityProof(Rg, Rh, (k + c * x) % C.n)


def verify_equality(P: tuple[int, int], Q: tuple[int, int],
                    H: tuple[int, int], proof: EqualityProof,
                    context: bytes = b"") -> bool:
    for pt in (P, Q, H, proof.commit_g, proof.commit_h):
        if pt is None or not refimpl.is_on_curve(C, pt):
            return False
    c = _h_scalar(b"eq", _enc(G), _enc(H), _enc(P), _enc(Q),
                  _enc(proof.commit_g), _enc(proof.commit_h), context)
    s = proof.response % C.n
    if refimpl.ec_mul(C, s, G) != refimpl.ec_add(
            C, proof.commit_g, refimpl.ec_mul(C, c, P)):
        return False
    return refimpl.ec_mul(C, s, H) == refimpl.ec_add(
        C, proof.commit_h, refimpl.ec_mul(C, c, Q))


# ---------------------------------------------------------------------------
# LSAG linkable ring signature
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RingSignature:
    key_image: tuple[int, int]
    c0: int
    responses: list[int]

    def encode(self) -> bytes:
        out = _enc(self.key_image) + self.c0.to_bytes(32, "big")
        out += len(self.responses).to_bytes(4, "big")
        for s in self.responses:
            out += s.to_bytes(32, "big")
        return out

    @classmethod
    def decode(cls, b: bytes) -> "RingSignature":
        ki = _dec(b[:64])
        c0 = int.from_bytes(b[64:96], "big")
        n = int.from_bytes(b[96:100], "big")
        if n > 4096 or len(b) < 100 + 32 * n:
            raise ValueError("bad ring signature")
        rs = [int.from_bytes(b[100 + 32 * i:132 + 32 * i], "big")
              for i in range(n)]
        return cls(ki, c0, rs)


def _ring_hash(message: bytes, ring: Sequence[tuple[int, int]],
               L: Point, R: Point) -> int:
    return _h_scalar(b"lsag", message,
                     b"".join(_enc(P) for P in ring), _enc(L), _enc(R))


def ring_sign(message: bytes, ring: Sequence[tuple[int, int]],
              secret: int, index: int) -> RingSignature:
    """Sign hiding among `ring`; ring[index] must equal secret*G."""
    n = len(ring)
    assert ring[index] == refimpl.ec_mul(C, secret, G)
    Hp = hash_to_point(b"".join(_enc(P) for P in ring))
    key_image = refimpl.ec_mul(C, secret, Hp)

    cs = [0] * n
    ss = [0] * n
    k = _nonce(secret, b"lsag", message, _enc(Hp))
    L = refimpl.ec_mul(C, k, G)
    R = refimpl.ec_mul(C, k, Hp)
    cs[(index + 1) % n] = _ring_hash(message, ring, L, R)
    i = (index + 1) % n
    while i != index:
        ss[i] = _nonce(secret, b"s", message, i.to_bytes(4, "big"))
        L = refimpl.ec_add(C, refimpl.ec_mul(C, ss[i], G),
                           refimpl.ec_mul(C, cs[i], ring[i]))
        R = refimpl.ec_add(C, refimpl.ec_mul(C, ss[i], Hp),
                           refimpl.ec_mul(C, cs[i], key_image))
        cs[(i + 1) % n] = _ring_hash(message, ring, L, R)
        i = (i + 1) % n
    ss[index] = (k - cs[index] * secret) % C.n
    return RingSignature(key_image, cs[0], ss)


def ring_verify(message: bytes, ring: Sequence[tuple[int, int]],
                sig: RingSignature) -> bool:
    n = len(ring)
    if n == 0 or len(sig.responses) != n or sig.key_image is None:
        return False
    for P in ring:
        if P is None or not refimpl.is_on_curve(C, P):
            return False
    if not refimpl.is_on_curve(C, sig.key_image):
        return False
    Hp = hash_to_point(b"".join(_enc(P) for P in ring))
    c = sig.c0 % C.n
    for i in range(n):
        s = sig.responses[i] % C.n
        L = refimpl.ec_add(C, refimpl.ec_mul(C, s, G),
                           refimpl.ec_mul(C, c, ring[i]))
        R = refimpl.ec_add(C, refimpl.ec_mul(C, s, Hp),
                           refimpl.ec_mul(C, c, sig.key_image))
        c = _ring_hash(message, ring, L, R)
    return c == sig.c0 % C.n


def linked(sig_a: RingSignature, sig_b: RingSignature) -> bool:
    """Two valid ring signatures by the same secret share a key image."""
    return sig_a.key_image == sig_b.key_image
