"""Pure-Python reference crypto (host-side oracle + low-volume fallback).

Independent from-spec implementations used as the golden oracle for the TPU
kernels and as the host CPU path for low-volume operations (key generation,
signing a node's own consensus messages — one signature per PBFT phase,
mirroring how the reference only *batches* verification, not signing:
TransactionSync.cpp:516-537 batches verify; PBFTCodec.cpp:47 signs singly).

Python ints are arbitrary-precision, which makes these implementations short
and obviously correct — they are the determinism anchor the TPU kernels are
tested against (SURVEY §4: golden-value crypto tests CPU↔TPU).
"""

from __future__ import annotations

import hmac
import hashlib
import os
from dataclasses import dataclass

# ---------------------------------------------------------------------------
# Keccak-256 (Ethereum padding 0x01)
# ---------------------------------------------------------------------------

_KECCAK_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]
_KECCAK_ROT = [0, 1, 62, 28, 27, 36, 44, 6, 55, 20, 3, 10, 43, 25, 39,
               41, 45, 15, 21, 8, 18, 2, 61, 56, 14]
_M64 = (1 << 64) - 1


def _rotl64(x: int, r: int) -> int:
    r %= 64
    return ((x << r) | (x >> (64 - r))) & _M64


def _keccak_f(lanes: list[int]) -> list[int]:
    a = lanes
    for rc in _KECCAK_RC:
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20] for x in range(5)]
        d = [c[(x + 4) % 5] ^ _rotl64(c[(x + 1) % 5], 1) for x in range(5)]
        a = [a[i] ^ d[i % 5] for i in range(25)]
        b = [0] * 25
        for x in range(5):
            for y in range(5):
                b[y + 5 * ((2 * x + 3 * y) % 5)] = _rotl64(a[x + 5 * y], _KECCAK_ROT[x + 5 * y])
        a = [
            b[i] ^ ((~b[(i % 5 + 1) % 5 + 5 * (i // 5)]) & _M64
                    & b[(i % 5 + 2) % 5 + 5 * (i // 5)])
            for i in range(25)
        ]
        a[0] ^= rc
    return a


def keccak256(data: bytes) -> bytes:
    rate = 136
    n = len(data)
    padded = bytearray(data)
    padlen = rate - (n % rate)
    padded += b"\x00" * padlen
    padded[n] ^= 0x01
    padded[-1] ^= 0x80
    lanes = [0] * 25
    for off in range(0, len(padded), rate):
        block = padded[off : off + rate]
        for i in range(rate // 8):
            lanes[i] ^= int.from_bytes(block[8 * i : 8 * i + 8], "little")
        lanes = _keccak_f(lanes)
    return b"".join(lanes[i].to_bytes(8, "little") for i in range(4))


# ---------------------------------------------------------------------------
# SM3
# ---------------------------------------------------------------------------

_M32 = (1 << 32) - 1


def _rotl32(x: int, r: int) -> int:
    r %= 32
    return ((x << r) | (x >> (32 - r))) & _M32


def sm3(data: bytes) -> bytes:
    iv = [0x7380166F, 0x4914B2B9, 0x172442D7, 0xDA8A0600,
          0xA96F30BC, 0x163138AA, 0xE38DEE4D, 0xB0FB0E4E]
    n = len(data)
    msg = bytearray(data)
    msg.append(0x80)
    while len(msg) % 64 != 56:
        msg.append(0)
    msg += (n * 8).to_bytes(8, "big")
    V = iv
    for off in range(0, len(msg), 64):
        W = [int.from_bytes(msg[off + 4 * i : off + 4 * i + 4], "big") for i in range(16)]
        for j in range(16, 68):
            x = W[j - 16] ^ W[j - 9] ^ _rotl32(W[j - 3], 15)
            W.append((x ^ _rotl32(x, 15) ^ _rotl32(x, 23)) ^ _rotl32(W[j - 13], 7) ^ W[j - 6])
        A, B, C, D, E, F, G, H = V
        for j in range(64):
            Tj = 0x79CC4519 if j < 16 else 0x7A879D8A
            a12 = _rotl32(A, 12)
            SS1 = _rotl32((a12 + E + _rotl32(Tj, j)) & _M32, 7)
            SS2 = SS1 ^ a12
            if j < 16:
                FF, GG = A ^ B ^ C, E ^ F ^ G
            else:
                FF = (A & B) | (A & C) | (B & C)
                GG = (E & F) | ((~E & _M32) & G)
            TT1 = (FF + D + SS2 + (W[j] ^ W[j + 4])) & _M32
            TT2 = (GG + H + SS1 + W[j]) & _M32
            D, C, B, A = C, _rotl32(B, 9), A, TT1
            H, G, F, E = G, _rotl32(F, 19), E, (TT2 ^ _rotl32(TT2, 9) ^ _rotl32(TT2, 17))
        V = [v ^ o for v, o in zip(V, [A, B, C, D, E, F, G, H])]
    return b"".join(v.to_bytes(4, "big") for v in V)


# ---------------------------------------------------------------------------
# Elliptic curves (affine, Python ints)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class CurveParams:
    name: str
    p: int
    a: int
    b: int
    n: int
    gx: int
    gy: int


SECP256K1 = CurveParams(
    name="secp256k1",
    p=0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFC2F,
    a=0,
    b=7,
    n=0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141,
    gx=0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798,
    gy=0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8,
)

SM2P256V1 = CurveParams(
    name="sm2p256v1",
    p=0xFFFFFFFEFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFF00000000FFFFFFFFFFFFFFFF,
    a=0xFFFFFFFEFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFF00000000FFFFFFFFFFFFFFFC,
    b=0x28E9FA9E9D9F5E344D5A9E4BCF6509A7F39789F515AB8F92DDBCBD414D940E93,
    n=0xFFFFFFFEFFFFFFFFFFFFFFFFFFFFFFFF7203DF6B21C6052B53BBF40939D54123,
    gx=0x32C4AE2C1F1981195F9904466A39C9948FE30BBFF2660BE1715A4589334C74C7,
    gy=0xBC3736A2F4F6779C59BDCEE36B692153D0A9877CC62A474002DF32E52139F0A0,
)


def is_on_curve(c: CurveParams, P) -> bool:
    """Affine point validity (None = infinity is NOT considered on-curve
    for input validation purposes)."""
    if P is None:
        return False
    x, y = P
    if not (0 <= x < c.p and 0 <= y < c.p):
        return False
    return (y * y - (x * x * x + c.a * x + c.b)) % c.p == 0


def ec_add(c: CurveParams, P, Q):
    if P is None:
        return Q
    if Q is None:
        return P
    x1, y1 = P
    x2, y2 = Q
    if x1 == x2:
        if (y1 + y2) % c.p == 0:
            return None
        lam = (3 * x1 * x1 + c.a) * pow(2 * y1, -1, c.p) % c.p
    else:
        lam = (y2 - y1) * pow(x2 - x1, -1, c.p) % c.p
    x3 = (lam * lam - x1 - x2) % c.p
    y3 = (lam * (x1 - x3) - y1) % c.p
    return (x3, y3)


def ec_mul(c: CurveParams, k: int, P):
    R = None
    A = P
    while k:
        if k & 1:
            R = ec_add(c, R, A)
        A = ec_add(c, A, A)
        k >>= 1
    return R


def ec_on_curve(c: CurveParams, P) -> bool:
    if P is None:
        return True
    x, y = P
    return (y * y - (x * x * x + c.a * x + c.b)) % c.p == 0


# ---------------------------------------------------------------------------
# ECDSA (secp256k1) sign / verify / recover — Python-int oracle
# ---------------------------------------------------------------------------

def _rfc6979_k(secret: int, h: bytes, n: int, extra: bytes = b"") -> int:
    """Deterministic nonce (RFC 6979, HMAC-SHA256)."""
    qlen = 32
    V = b"\x01" * 32
    K = b"\x00" * 32
    x = secret.to_bytes(qlen, "big")
    K = hmac.new(K, V + b"\x00" + x + h + extra, hashlib.sha256).digest()
    V = hmac.new(K, V, hashlib.sha256).digest()
    K = hmac.new(K, V + b"\x01" + x + h + extra, hashlib.sha256).digest()
    V = hmac.new(K, V, hashlib.sha256).digest()
    while True:
        V = hmac.new(K, V, hashlib.sha256).digest()
        k = int.from_bytes(V, "big")
        if 1 <= k < n:
            return k
        K = hmac.new(K, V + b"\x00", hashlib.sha256).digest()
        V = hmac.new(K, V, hashlib.sha256).digest()


def ecdsa_sign(c: CurveParams, secret: int, msg_hash: bytes):
    """-> (r, s, v) with v the recovery id (0/1, y-parity of R; low-s form)."""
    e = int.from_bytes(msg_hash, "big") % c.n
    while True:
        k = _rfc6979_k(secret, msg_hash, c.n)
        R = ec_mul(c, k, (c.gx, c.gy))
        r = R[0] % c.n
        if r == 0:
            continue
        s = (pow(k, -1, c.n) * (e + r * secret)) % c.n
        if s == 0:
            continue
        v = R[1] & 1
        if s > c.n // 2:
            s = c.n - s
            v ^= 1
        return r, s, v


def ecdsa_verify(c: CurveParams, pub, msg_hash: bytes, r: int, s: int) -> bool:
    if not (1 <= r < c.n and 1 <= s < c.n) or not ec_on_curve(c, pub) or pub is None:
        return False
    e = int.from_bytes(msg_hash, "big") % c.n
    w = pow(s, -1, c.n)
    u1, u2 = (e * w) % c.n, (r * w) % c.n
    R = ec_add(c, ec_mul(c, u1, (c.gx, c.gy)), ec_mul(c, u2, pub))
    return R is not None and R[0] % c.n == r


def ecdsa_recover(c: CurveParams, msg_hash: bytes, r: int, s: int, v: int):
    """Recover public key from signature; None if invalid."""
    if not (1 <= r < c.n and 1 <= s < c.n):
        return None
    x = r + (v >> 1) * c.n
    if x >= c.p:
        return None
    ysq = (pow(x, 3, c.p) + c.a * x + c.b) % c.p
    y = pow(ysq, (c.p + 1) // 4, c.p)
    if (y * y) % c.p != ysq:
        return None
    if (y & 1) != (v & 1):
        y = c.p - y
    e = int.from_bytes(msg_hash, "big") % c.n
    rinv = pow(r, -1, c.n)
    # Q = r^-1 (s*R - e*G)
    Q = ec_add(
        c,
        ec_mul(c, (s * rinv) % c.n, (x, y)),
        ec_mul(c, (-e * rinv) % c.n, (c.gx, c.gy)),
    )
    return Q


# ---------------------------------------------------------------------------
# SM2 sign / verify (GB/T 32918) — Python-int oracle
# ---------------------------------------------------------------------------

def sm2_sign(secret: int, msg_hash: bytes, k: int | None = None):
    """SM2 signature over a precomputed digest e (the reference signs the
    SM3(Z_A || M) digest computed upstream). -> (r, s)."""
    c = SM2P256V1
    e = int.from_bytes(msg_hash, "big") % c.n
    while True:
        if k is None:
            kk = _rfc6979_k(secret, msg_hash, c.n, extra=b"sm2")
        else:
            kk = k
        P = ec_mul(c, kk, (c.gx, c.gy))
        r = (e + P[0]) % c.n
        if r == 0 or r + kk == c.n:
            k = None
            continue
        s = (pow(1 + secret, -1, c.n) * (kk - r * secret)) % c.n
        if s == 0:
            k = None
            continue
        return r, s


def sm2_verify(pub, msg_hash: bytes, r: int, s: int) -> bool:
    c = SM2P256V1
    if not (1 <= r < c.n and 1 <= s < c.n) or pub is None or not ec_on_curve(c, pub):
        return False
    e = int.from_bytes(msg_hash, "big") % c.n
    t = (r + s) % c.n
    if t == 0:
        return False
    P = ec_add(c, ec_mul(c, s, (c.gx, c.gy)), ec_mul(c, t, pub))
    if P is None:
        return False
    return (e + P[0]) % c.n == r


# ---------------------------------------------------------------------------
# GLV endomorphism (secp256k1) — host oracle for the device decomposition
# ---------------------------------------------------------------------------
# secp256k1 has j-invariant 0 (a = 0, p = 1 mod 3), so phi(x, y) =
# (beta*x, y) is an endomorphism with phi(P) = lambda*P for the matching
# cube roots of unity (beta^3 = 1 mod p, lambda^3 = 1 mod n). Splitting a
# scalar k = k1 + k2*lambda (mod n) with |k1|, |k2| ~ sqrt(n) halves the
# doubling ladder. Constants are the standard public secp256k1 values
# (verified against each other in ec.Curve.__init__); the decomposition is
# the mul-shift form: c_i = floor(k * g_i / 2^384) with g_i =
# round(2^384 * b_i' / n), then k2 = c1*(-b1) + c2*(-b2) mod n and
# k1 = k - k2*lambda mod n — exact by construction, the rounding only
# nudges the (still ~128-bit) magnitudes.

GLV_LAMBDA = 0x5363AD4CC05C30E0A5261C028812645A122E22EA20816678DF02967C1B23BD72
GLV_BETA = 0x7AE96A2B657C07106E64479EAC3434E99CF0497512F58995C1396C28719501EE
_GLV_MINUS_B1 = 0xE4437ED6010E88286F547FA90ABFE4C3
_GLV_B2 = 0x3086D221A7D46BCDE86C90E49284EB15
_GLV_MINUS_B2 = (-_GLV_B2) % SECP256K1.n
_GLV_G1 = ((1 << 384) * _GLV_B2 + SECP256K1.n // 2) // SECP256K1.n
_GLV_G2 = ((1 << 384) * _GLV_MINUS_B1 + SECP256K1.n // 2) // SECP256K1.n


def glv_split(k: int, n: int = SECP256K1.n) -> tuple[int, int]:
    """k -> (k1, k2) with k1 + k2*lambda = k (mod n), both in [0, n).

    Mapped to signed form (min(k_i, n - k_i)) the magnitudes are ~2^128.
    """
    c1 = (k * _GLV_G1) >> 384
    c2 = (k * _GLV_G2) >> 384
    k2 = (c1 * _GLV_MINUS_B1 + c2 * _GLV_MINUS_B2) % n
    k1 = (k - k2 * GLV_LAMBDA) % n
    return k1, k2


def keygen(c: CurveParams = SECP256K1, seed: bytes | None = None):
    """-> (secret_int, (pub_x, pub_y)). Seed for deterministic test keys."""
    if seed is not None:
        secret = int.from_bytes(hashlib.sha256(seed).digest(), "big") % (c.n - 1) + 1
    else:
        secret = int.from_bytes(os.urandom(32), "big") % (c.n - 1) + 1
    return secret, ec_mul(c, secret, (c.gx, c.gy))
