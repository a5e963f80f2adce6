"""BLS-style signature aggregation over the repo's own BN254 substrate.

Scheme (same-message aggregation, the commit-seal shape): secrets live in
Z_r, public keys in G2 (X = x * G2_GEN), signatures in G1
(sigma = x * H(m)).  A quorum's seals over ONE executed-header hash
aggregate by point addition — sigma_agg = sum sigma_i — and verify with a
single product-of-pairings check

    e(sigma_agg, -G2) * e(H(m), sum X_i) == 1

riding `crypto/bn254.py`'s shared-final-exponentiation `pairing_check`
(the algebra precompile 8 already owns; `ops/fp.py` carries the same
field to the limb/device lane).  G1 arithmetic is the short-Weierstrass
chord/tangent over y^2 = x^3 + 3 (crypto/refimpl.py idiom, mod-p ints).

Rogue-key defence: same-message aggregation is forgeable if an attacker
may claim an arbitrary G2 point as its key (pick X_evil = X_target^-1 * Y
and "sign" for both).  Keys therefore enter an `AggKeyRegistry` only with
a proof of possession — pi = x * H_pop(pub_bytes) under a DOMAIN-SEPARATED
hash — which an attacker without x cannot produce for a composed key.
Verifiers refuse to aggregate any unregistered key.

Hash-to-curve is try-and-increment (P = 3 mod 4, so sqrt is one `pow`):
fine here because inputs are 32-byte digests, not attacker-timed secrets.

Perf: pure Python ints — one aggregate verify is two Miller loops + one
final exponentiation (~1 s host-side), so `seal_mode = aggregate` is the
correctness-first wire-format path; `cert` keeps ECDSA seals on the batch
lane at full speed (consensus/qc.py picks).
"""

from __future__ import annotations

import hashlib
from typing import Iterable, Optional, Sequence

from .bn254 import (
    P,
    R,
    g1_on_curve,
    g2_in_subgroup,
    g2_add,
    g2_mul,
    g2_neg,
    pairing_check,
)

# EIP-197 G2 generator (the canonical alt_bn128 twist generator).
G2_GEN = (
    (10857046999023057135944570762232829481370756359578518086990519993285655852781,
     11559732032986387107991004021392285783925812861821192530917403151452391805634),
    (8495653923123431417604973247489272438418190587263600148770280649306958101930,
     4082367875863433681332203403145435568316851327593401208105741076214120093531),
)

DST_SIGN = b"BCOS-TPU-AGG-SIG-v1"
DST_POP = b"BCOS-TPU-AGG-POP-v1"

G1_BYTES = 64   # x(32) | y(32), big-endian; all-zero = infinity
G2_BYTES = 128  # x.c0 | x.c1 | y.c0 | y.c1


# -- G1 affine arithmetic (y^2 = x^3 + 3 over F_p) --------------------------

def g1_add(a, b):
    if a is None:
        return b
    if b is None:
        return a
    x1, y1 = a
    x2, y2 = b
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        lam = (3 * x1 * x1) * pow(2 * y1, P - 2, P) % P
    else:
        lam = (y2 - y1) * pow(x2 - x1, P - 2, P) % P
    x3 = (lam * lam - x1 - x2) % P
    return (x3, (lam * (x1 - x3) - y1) % P)


def g1_mul(pt, k: int):
    acc = None
    add = pt
    k %= R
    while k:
        if k & 1:
            acc = g1_add(acc, add)
        add = g1_add(add, add)
        k >>= 1
    return acc


def g1_neg(pt):
    if pt is None:
        return None
    return (pt[0], (-pt[1]) % P)


def g1_to_bytes(pt) -> bytes:
    if pt is None:
        return b"\x00" * G1_BYTES
    return pt[0].to_bytes(32, "big") + pt[1].to_bytes(32, "big")


def g1_from_bytes(raw: bytes):
    """Decode + curve-check an affine G1 point; raises on junk.  BN254's
    G1 has cofactor 1, so on-curve IS in-subgroup (no extra check)."""
    if len(raw) != G1_BYTES:
        raise ValueError(f"G1 point must be {G1_BYTES} bytes, got {len(raw)}")
    if raw == b"\x00" * G1_BYTES:
        return None
    pt = (int.from_bytes(raw[:32], "big"), int.from_bytes(raw[32:], "big"))
    if pt[0] >= P or pt[1] >= P or not g1_on_curve(pt):
        raise ValueError("not a G1 curve point")
    return pt


def g2_to_bytes(q) -> bytes:
    if q is None:
        return b"\x00" * G2_BYTES
    (x0, x1), (y0, y1) = q
    return b"".join(v.to_bytes(32, "big") for v in (x0, x1, y0, y1))


def g2_from_bytes(raw: bytes):
    """Decode + SUBGROUP-check a G2 point (the twist has cofactor points
    that would make the pairing ill-defined — same rule as EIP-197)."""
    if len(raw) != G2_BYTES:
        raise ValueError(f"G2 point must be {G2_BYTES} bytes, got {len(raw)}")
    if raw == b"\x00" * G2_BYTES:
        return None
    v = [int.from_bytes(raw[i:i + 32], "big") for i in range(0, 128, 32)]
    if any(c >= P for c in v):
        raise ValueError("G2 coordinate out of field")
    q = ((v[0], v[1]), (v[2], v[3]))
    if not g2_in_subgroup(q):
        raise ValueError("not an r-torsion G2 point")
    return q


# -- hash to G1 -------------------------------------------------------------

def hash_to_g1(msg: bytes, dst: bytes = DST_SIGN):
    """Try-and-increment: x from H(dst | ctr | msg), y the principal root
    of x^3 + 3 when square (P = 3 mod 4 -> one pow), sign bit from the
    hash so the map doesn't favour one root."""
    ctr = 0
    while True:
        h = hashlib.sha256(dst + ctr.to_bytes(4, "big") + msg).digest()
        x = int.from_bytes(h, "big") % P
        rhs = (x * x * x + 3) % P
        y = pow(rhs, (P + 1) // 4, P)
        if y * y % P == rhs:
            if (h[0] & 1) != (y & 1):
                y = P - y
            return (x, y)
        ctr += 1


# -- keys / sign / verify ---------------------------------------------------

def derive_secret(seed: bytes) -> int:
    """Deterministic BLS secret from existing node key material (so a
    sealer needs no second key file): expand-then-reduce into [1, r-1]."""
    wide = hashlib.sha256(b"agg-sk" + seed).digest() + \
        hashlib.sha256(b"agg-sk2" + seed).digest()
    return int.from_bytes(wide, "big") % (R - 1) + 1


def pub_from_secret(secret: int):
    return g2_mul(G2_GEN, secret)


def sign(secret: int, digest: bytes) -> bytes:
    return g1_to_bytes(g1_mul(hash_to_g1(digest, DST_SIGN), secret))


def verify(pub, digest: bytes, sig: bytes) -> bool:
    """Single-signature check: e(sigma, -G2) * e(H(m), X) == 1."""
    try:
        s = g1_from_bytes(sig)
    except ValueError:
        return False
    if s is None or pub is None:
        return False
    return pairing_check([(s, g2_neg(G2_GEN)),
                          (hash_to_g1(digest, DST_SIGN), pub)])


def aggregate_sigs(sigs: Iterable[bytes]) -> bytes:
    """Point-sum of signature encodings; raises on any malformed point."""
    acc = None
    for raw in sigs:
        acc = g1_add(acc, g1_from_bytes(raw))
    return g1_to_bytes(acc)


def aggregate_pubs(pubs: Iterable):
    acc = None
    for q in pubs:
        acc = g2_add(acc, q)
    return acc


def verify_aggregate(pubs: Sequence, digest: bytes, agg_sig: bytes) -> bool:
    """ONE pairing-product check for a whole quorum's seals over one
    digest.  Callers must only pass registry-admitted (PoP-checked) keys —
    this function deliberately has no registry so the hot path carries no
    second lookup; consensus/qc.py enforces admission."""
    if not pubs:
        return False
    try:
        s = g1_from_bytes(agg_sig)
    except ValueError:
        return False
    if s is None:
        return False
    return pairing_check([(s, g2_neg(G2_GEN)),
                          (hash_to_g1(digest, DST_SIGN),
                           aggregate_pubs(pubs))])


# -- proof of possession ----------------------------------------------------

def pop_prove(secret: int) -> bytes:
    """pi = x * H_pop(pub_bytes) — only the secret holder can produce it
    for a key, including any adversarially COMPOSED key (the rogue-key
    shape X_evil = Y - X_target has no known discrete log)."""
    pub_bytes = g2_to_bytes(pub_from_secret(secret))
    return g1_to_bytes(g1_mul(hash_to_g1(pub_bytes, DST_POP), secret))


def pop_verify(pub, proof: bytes) -> bool:
    try:
        pi = g1_from_bytes(proof)
    except ValueError:
        return False
    if pi is None or pub is None:
        return False
    return pairing_check([(pi, g2_neg(G2_GEN)),
                          (hash_to_g1(g2_to_bytes(pub), DST_POP), pub)])


class AggKeyRegistry:
    """node_id (ECDSA pub bytes, the consensus roster key) -> admitted BLS
    public key.  Registration REQUIRES a valid proof of possession; a key
    that never proved possession never aggregates.  The registry is the
    trust root of `seal_mode = aggregate`: distribute it like the sealer
    list itself (genesis/governance), never from a peer at runtime."""

    def __init__(self):
        self._keys: dict[bytes, tuple] = {}

    def register(self, node_id: bytes, pub_bytes: bytes, pop: bytes) -> bool:
        try:
            pub = g2_from_bytes(pub_bytes)
        except ValueError:
            return False
        if pub is None or not pop_verify(pub, pop):
            return False
        self._keys[bytes(node_id)] = pub
        return True

    def pub_for(self, node_id: bytes) -> Optional[tuple]:
        return self._keys.get(bytes(node_id))

    def __len__(self) -> int:
        return len(self._keys)

    @classmethod
    def from_seeds(cls, seeds: Sequence[tuple[bytes, bytes]]
                   ) -> "AggKeyRegistry":
        """Test/tooling helper: [(node_id, secret seed)] -> registry with
        every key derived, proved, and admitted through the normal gate."""
        reg = cls()
        for node_id, seed in seeds:
            secret = derive_secret(seed)
            if not reg.register(node_id, g2_to_bytes(pub_from_secret(secret)),
                                pop_prove(secret)):
                raise ValueError("self-generated PoP failed to admit")
        return reg
