"""Seeded secp256k1 and SM2 signature vectors, valid and adversarial, for
the port's tests (CPU and card), built with the port's pure-Python oracle,
and the tests that hold the vectors to what they claim to be."""

from __future__ import annotations

import random

import numpy as np
import torch

from fisco_bcos_tpu_torch.crypto import refimpl
from fisco_bcos_tpu_torch.ops import ec
from fisco_bcos_tpu_torch.ops.bigint import batch_to_limbs

C = refimpl.SECP256K1
S = refimpl.SM2P256V1


def signed_vectors(n: int, nkeys: int = 4, tag: int = 0):
    """n signatures by nkeys keys over distinct digests, then corrupted in
    the ways the JAX tests pin. -> list of dicts with e, r, s, v, qx, qy
    (ints) and the digest bytes."""
    keys = [refimpl.keygen(C, seed=bytes([tag, k])) for k in range(nkeys)]
    out = []
    for i in range(n):
        sk, (qx, qy) = keys[i % nkeys]
        h = refimpl.keccak256(bytes([tag]) + i.to_bytes(4, "big"))
        r, s, v = refimpl.ecdsa_sign(C, sk, h)
        out.append(dict(e=int.from_bytes(h, "big"), r=r, s=s, v=v,
                        qx=qx, qy=qy))
    corrupt = [
        lambda d: d.update(r=0),
        lambda d: d.update(s=C.n),
        lambda d: d.update(v=4),
        lambda d: d.update(e=d["e"] ^ 1),
        lambda d: d.update(qx=(d["qx"] + 1) % C.p),
        lambda d: d.update(s=0),
        lambda d: d.update(v=d["v"] ^ 2),
        lambda d: d.update(qx=0, qy=0),
    ]
    for j, f in enumerate(corrupt):
        if 1 + 2 * j < n:
            f(out[1 + 2 * j])
    return out


def collision_vectors():
    """Vectors that force the ladder's doubling and cancellation cases:
    the key is +-G and e = +-r, so u1 = +-u2."""
    out = []
    for j, (sk, sign_e, flip_y) in enumerate(
            [(1, 1, False), (1, -1, False), (1, 1, True)]):
        h = refimpl.keccak256(b"collide" + bytes([j]))
        r, s, v = refimpl.ecdsa_sign(C, sk, h)
        e = r if sign_e > 0 else C.n - r
        qy = C.p - C.gy if flip_y else C.gy
        out.append(dict(e=e, r=r, s=s, v=v, qx=C.gx, qy=qy))
    return out


SM2_CORRUPTIONS = ("r=0", "s>=n", "t=0", "digest", "wrong key", "off curve",
                   "zero key", "qx>=p")


def sm2_vectors(n: int, nkeys: int = 3, tag: int = 0):
    """n SM2 signatures by nkeys keys over distinct digests; lane 1 + 2j
    then carries corruption SM2_CORRUPTIONS[j] (as far as n reaches).
    -> list of dicts with e, r, s, qx, qy (ints)."""
    keys = [refimpl.keygen(S, seed=bytes([tag, k])) for k in range(nkeys)]
    out = []
    for i in range(n):
        sk, (qx, qy) = keys[i % nkeys]
        h = refimpl.sm3(bytes([tag]) + i.to_bytes(4, "big"))
        r, s = refimpl.sm2_sign(sk, h)
        out.append(dict(e=int.from_bytes(h, "big"), r=r, s=s, qx=qx, qy=qy))
    other = keys[-1][1]
    corrupt = [
        lambda d: d.update(r=0),
        lambda d: d.update(s=S.n + d["s"] % 7),
        lambda d: d.update(s=S.n - d["r"]),
        lambda d: d.update(e=d["e"] ^ 1),
        lambda d: d.update(qx=other[0], qy=other[1]),
        lambda d: d.update(qy=d["qy"] ^ 1),
        lambda d: d.update(qx=0, qy=0),
        lambda d: d.update(qx=S.p + 3),
    ]
    for j, f in enumerate(corrupt):
        if 1 + 2 * j < n:
            f(out[1 + 2 * j])
    return out


def _top_digit(k: int) -> int:
    return k >> (4 * ((k.bit_length() - 1) // 4)) if k else 0


def sm2_collision_vectors():
    """Valid SM2 signatures that force the ladder's doubling and
    cancellation cases: key +-2G (SM2 forbids the secret n - 1, so not
    +-G), and the leading window of s twice that of t = r + s at the same
    position, so the first Q add meets acc = +-(its own operand)."""
    out = []
    for sk in (2, S.n - 2):
        pub = refimpl.ec_mul(S, sk, (S.gx, S.gy))
        for i in range(4000):
            h = refimpl.sm3(b"collide" + bytes([sk & 1]) + i.to_bytes(4, "big"))
            r, s = refimpl.sm2_sign(sk, h)
            t = (r + s) % S.n
            if (s.bit_length() + 3) // 4 == (t.bit_length() + 3) // 4 \
                    and _top_digit(s) == 2 * _top_digit(t):
                out.append(dict(e=int.from_bytes(h, "big"), r=r, s=s,
                                qx=pub[0], qy=pub[1]))
                break
    return out


def sm2_verifies(d) -> bool:
    return refimpl.sm2_verify((d["qx"], d["qy"]), d["e"].to_bytes(32, "big"),
                              d["r"], d["s"])


def ladder_lanes(c, n: int, seed: int):
    """n lanes of ladder operands (k1, k2, qx, qy lists of ints, scalars
    canonical mod c.n) for k1*G + k2*Q: lane j < len(ec.LADDER_EDGES) is
    that edge (ec.ladder_edge_lanes), the rest random scalars on seeded
    keys."""
    rng = np.random.default_rng(seed)
    k1 = [int.from_bytes(rng.bytes(32), "big") % c.n for _ in range(n)]
    k2 = [int.from_bytes(rng.bytes(32), "big") % c.n for _ in range(n)]
    pts = [refimpl.keygen(c, seed=bytes([seed % 256]) + i.to_bytes(2, "big"))[1]
           for i in range(n)]
    return ec.ladder_edge_lanes(c, k1, k2, [q[0] for q in pts], [q[1] for q in pts])


def lift_x(c: refimpl.CurveParams, x: int):
    """The affine point (x, y) of c with y even, or None."""
    rhs = (x ** 3 + c.a * x + c.b) % c.p
    y = pow(rhs, (c.p + 1) // 4, c.p)
    if y * y % c.p != rhs:
        return None
    return x, y if y % 2 == 0 else c.p - y


def ecdsa_edge_lanes():
    """secp256k1 lanes at the edges of the recover and verify kernels'
    inverses and square root -> (recover lanes {e, r, s, v}, verify lanes
    {e, r, s, qx, qy}), plain ints; chip_smoke.py takes them too.

    Recovery: r at 1, n - 2 and n - 1 with every v (x = r, and x = r + n
    where that stays below p); s at 1, n - 2 and n - 1; x = r + n the
    largest below p on the curve; a lane whose key lands at infinity (R =
    kG, e = s k mod n: ok 0 and zeros); x = 5, the x of the ladder's
    off-curve edge Q = (5, 0). Verify: r at 1, n - 2 and n - 1 (the key
    solved for from a point R with x(R) = r mod n, so that the signature
    is valid, where such a point exists), s at 1, n - 2 and n - 1, the key
    Q = -G (secret n - 1), each a valid signature; and the key (5, 0),
    off the curve."""
    c = refimpl.SECP256K1
    rng = random.Random(7)
    G = (c.gx, c.gy)
    edges = (1, c.n - 2, c.n - 1)
    rec = []
    for r in edges:
        for v in range(4):
            rec.append(dict(e=rng.getrandbits(256), r=r, s=rng.randrange(1, c.n), v=v))
    for s in edges:
        R = refimpl.ec_mul(c, rng.randrange(1, c.n), G)
        rec.append(dict(e=rng.getrandbits(256), r=R[0] % c.n, s=s,
                        v=(R[1] & 1) | 2 * (R[0] >= c.n)))
    x = c.p - 1
    while lift_x(c, x) is None:
        x -= 1
    rec.append(dict(e=rng.getrandbits(256), r=x - c.n, s=rng.randrange(1, c.n), v=2))
    rec.append(dict(rec[-1], v=3))
    k = rng.randrange(1, c.n)
    R = refimpl.ec_mul(c, k, G)
    s = rng.randrange(1, c.n)
    rec.append(dict(e=s * k % c.n, r=R[0] % c.n, s=s, v=(R[1] & 1) | 2 * (R[0] >= c.n)))
    for v in range(2):
        rec.append(dict(e=rng.getrandbits(256), r=5, s=rng.randrange(1, c.n), v=v))

    def signed(R, r, s):
        """e and the key Q under which (r, s) verifies: Q = u2^-1 (R - u1 G)."""
        e = rng.getrandbits(256)
        w = pow(s, -1, c.n)
        u1, u2 = e % c.n * w % c.n, r * w % c.n
        minus = refimpl.ec_mul(c, (c.n - u1) % c.n, G)
        Q = refimpl.ec_mul(c, pow(u2, -1, c.n), refimpl.ec_add(c, R, minus))
        return dict(e=e, r=r, s=s, qx=Q[0], qy=Q[1])

    ver = []
    for r in edges:
        R = lift_x(c, r) or (lift_x(c, r + c.n) if r + c.n < c.p else None)
        if R is None:  # no point has x = r mod n: a signature that fails
            ver.append(dict(signed(refimpl.ec_mul(c, 3, G), 7, 5), r=r))
        else:
            ver.append(signed(R, r, rng.randrange(1, c.n)))
    for s in edges:
        R = refimpl.ec_mul(c, rng.randrange(1, c.n), G)
        ver.append(signed(R, R[0] % c.n, s))
    h = rng.getrandbits(256).to_bytes(32, "big")
    r, s, _ = refimpl.ecdsa_sign(c, c.n - 1, h)
    ver.append(dict(e=int.from_bytes(h, "big"), r=r, s=s, qx=c.gx, qy=c.p - c.gy))
    ver.append(dict(ver[-1], qx=5, qy=0))
    return rec, ver


def limbs(xs) -> torch.Tensor:
    """List of ints -> [N, 16] int64 limb tensor on the CPU."""
    return torch.as_tensor(batch_to_limbs(xs).astype(np.int64))


def _verifies(d) -> bool:
    return refimpl.ecdsa_verify(C, (d["qx"], d["qy"]), d["e"].to_bytes(32, "big"),
                                d["r"], d["s"])


def _recovers(d) -> bool:
    Q = refimpl.ecdsa_recover(C, d["e"].to_bytes(32, "big"), d["r"], d["s"], d["v"])
    return Q == (d["qx"], d["qy"])


def test_signed_vectors_valid_and_corrupted_lanes():
    vs = signed_vectors(17, tag=3)
    # lane 1 + 2j carries corruption j; 5 (v=4) and 13 (v^2) only hit recovery
    for i, d in enumerate(vs):
        assert _verifies(d) == (i % 2 == 0 or i in (5, 13)), i
        assert _recovers(d) == (i % 2 == 0), i


def test_collision_vectors_force_equal_or_opposite_scalars():
    for d, (sign, key_y) in zip(collision_vectors(),
                                [(1, C.gy), (-1, C.gy), (1, C.p - C.gy)]):
        w = pow(d["s"], -1, C.n)
        u1, u2 = d["e"] * w % C.n, d["r"] * w % C.n
        assert u1 == (u2 if sign > 0 else C.n - u2)
        assert (d["qx"], d["qy"]) == (C.gx, key_y)


def test_sm2_vectors_valid_and_corrupted_lanes():
    vs = sm2_vectors(17, tag=3)
    for i, d in enumerate(vs):
        assert sm2_verifies(d) == (i % 2 == 0), i
    assert (vs[5]["r"] + vs[5]["s"]) % S.n == 0 and vs[5]["r"] < S.n
    assert vs[15]["qx"] >= S.p


def test_sm2_collision_vectors_meet_their_own_operand():
    vs = sm2_collision_vectors()
    assert len(vs) == 2 and all(sm2_verifies(d) for d in vs)
    g2 = refimpl.ec_mul(S, 2, (S.gx, S.gy))
    assert [(d["qx"], d["qy"]) for d in vs] == [g2, (g2[0], S.p - g2[1])]
