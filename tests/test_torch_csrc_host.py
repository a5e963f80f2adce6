"""The port's CUDA arithmetic (csrc/bigint.cuh, sm2.cuh, field.cuh,
point.cuh) compiled for the host with g++ and held to Python integers and
to the plain PyTorch point formulas of ops/ec, on seeded operands and on
carry-extreme ones.

The device code is plain C++ behind `__device__`: with empty
`__device__`, `__forceinline__`, `__noinline__` and `__constant__`, and
a host build runs the code the card runs. The constant blocks are filled from
ops/consts.kernel_words(), as ops/_cuda.library fills them on the card.

Tolerance: bit-exact (integer arithmetic). Skips only where g++ is absent.
"""

import random
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from fisco_bcos_tpu_torch.crypto import refimpl
from fisco_bcos_tpu_torch.ops import bigint, ec
from fisco_bcos_tpu_torch.ops.consts import derive_consts, kernel_words

CSRC = Path(__file__).resolve().parent.parent / "fisco_bcos_tpu_torch" / "csrc"
S, C = refimpl.SM2P256V1, refimpl.SECP256K1
R = 1 << 256

HARNESS = r"""
#define __device__
#define __forceinline__ inline
#define __noinline__
#define __constant__
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <iostream>
#include <string>
#include "ec.cuh"
#include "sm2.cuh"

// a 256-bit value as 64 hex digits, most significant first
static void rd(u32 w[8]) {
    std::string h;
    std::cin >> h;
    for (int i = 0; i < 8; ++i) w[i] = (u32)strtoul(h.substr(56 - 8 * i, 8).c_str(), 0, 16);
}
static void wr(const u32 *w, int n) {
    for (int i = n - 1; i >= 0; --i) printf("%08x", w[i]);
}
static void rd_jac(Jac &P) { rd(P.X); rd(P.Y); rd(P.Z); }
static void wr_jac(const Jac &P) {
    wr(P.X, 8); printf(" "); wr(P.Y, 8); printf(" "); wr(P.Z, 8);
}

int main() {
    std::string op;
    int n;
    std::cin >> op >> n;  // the "verify" words, then the "sm2" words
    u32 w[256];
    for (int i = 0; i < n; ++i) { std::string h; std::cin >> h; w[i] = (u32)strtoul(h.c_str(), 0, 16); }
    memcpy(&SC, w, sizeof(SecpConsts));
    std::cin >> op >> n;
    for (int i = 0; i < n; ++i) { std::string h; std::cin >> h; w[i] = (u32)strtoul(h.c_str(), 0, 16); }
    memcpy(&S2, w, sizeof(Sm2Consts));
    while (std::cin >> op) {
        u32 a[8], b[8], r[8], t[16];
        Jac P, Q, Rj;
        if (op == "wide") {
            rd(a); rd(b); mul_wide8(t, a, b); wr(t, 16);

        } else if (op == "sm2mul") {
            rd(a); rd(b); Sm2Fp::mul(r, a, b); wr(r, 8);
        } else if (op == "secpmul") {
            rd(a); rd(b); SecpFp::mul(r, a, b); wr(r, 8);
        } else if (op == "sm2dbl") {
            rd_jac(P); jac_double<Sm2Fp>(Rj, P); wr_jac(Rj);
        } else if (op == "sm2madd") {
            rd_jac(P); rd(a); rd(b); jac_madd<Sm2Fp>(Rj, P, a, b); wr_jac(Rj);
        } else if (op == "sm2add") {
            rd_jac(P); rd_jac(Q); jac_add<Sm2Fp>(Rj, P, Q); wr_jac(Rj);
        } else {
            fprintf(stderr, "unknown op %s\n", op.c_str());
            return 1;
        }
        printf("\n");
    }
    return 0;
}
"""


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the device code for the host")
    d = tmp_path_factory.mktemp("csrc_host")
    (d / "harness.cpp").write_text(HARNESS)
    exe = d / "harness"
    subprocess.run([gxx, "-std=c++20", "-O1", "-I", str(CSRC), "-o", str(exe),
                    str(d / "harness.cpp"), "-lpthread"], check=True, capture_output=True,
                   timeout=600)
    words = kernel_words(derive_consts())
    head = " ".join(f"{k} {len(words[k])} " + " ".join(f"{x:08x}" for x in words[k])
                    for k in ("verify", "sm2"))

    def run(lines: list[str]) -> list[list[int]]:
        out = subprocess.run([str(exe)], input=head + "\n" + "\n".join(lines) + "\n",
                             capture_output=True, text=True, check=True, timeout=600).stdout
        return [[int(v, 16) for v in line.split()] for line in out.splitlines()]

    return run


def _h(*xs: int) -> str:
    return " ".join(f"{x:064x}" for x in xs)


def _extremes(p: int) -> list[int]:
    """Canonical operands at the carry edges: 0, 1, 2, p - 1, p - 2,
    R mod p, R^2 mod p, and words of 0xFFFFFFFF (2^32k - 1 below p, p - 2^32,
    the all-ones low half)."""
    xs = [0, 1, 2, p - 1, p - 2, R % p, R * R % p, p - (1 << 32), (1 << 255) - 1, 1 << 255]
    xs += [(1 << (32 * k)) - 1 for k in (1, 2, 4, 7)]
    xs += [((1 << 32) - 1) << 192, ((1 << 128) - 1) << 64]
    return [x for x in xs if x < p]


def _operand_pairs(p: int, seed: int) -> list[tuple[int, int]]:
    rng = random.Random(seed)
    ext = _extremes(p)
    pairs = [(a, b) for a in ext for b in ext]
    pairs += [(rng.randrange(p), rng.randrange(p)) for _ in range(256)]
    pairs += [(rng.randrange(p), x) for x in ext for _ in range(4)]
    return pairs


def test_mul_wide8_is_the_full_product(harness):
    rng = random.Random(11)
    ext = [0, 1, R - 1, (1 << 255), (1 << 224) - 1, R - (1 << 32)]
    pairs = [(a, b) for a in ext for b in ext]
    pairs += [(rng.getrandbits(256), rng.getrandbits(256)) for _ in range(256)]
    got = harness([f"wide {_h(a, b)}" for a, b in pairs])
    assert [g[0] for g in got] == [a * b for a, b in pairs]


@pytest.mark.parametrize("field", ["sm2", "secp256k1"])
def test_field_mul_matches_python(harness, field):
    """Sm2Fp::mul is a b R^-1 mod p (the special-form Montgomery product,
    canonical); SecpFp::mul is a b mod p (the Solinas fold)."""
    if field == "sm2":
        p, op, rinv = S.p, "sm2mul", pow(R, -1, S.p)
    else:
        p, op, rinv = C.p, "secpmul", 1
    pairs = _operand_pairs(p, seed=5 if field == "sm2" else 6)
    # one operand canonical, the other anywhere below 2^256 (to_rep's case)
    rng = random.Random(7)
    pairs += [(rng.randrange(p), x) for x in (R - 1, R - p, p, p + 1, R - (1 << 32))]
    got = harness([f"{op} {_h(a, b)}" for a, b in pairs])
    want = [a * b * rinv % p for a, b in pairs]
    bad = [(hex(a), hex(b)) for (a, b), g, w in zip(pairs, got, want) if g[0] != w]
    assert not bad, f"{len(bad)} of {len(pairs)} products differ, first {bad[:3]}"


def _rep(cv, xs) -> torch.Tensor:
    return cv.fp.to_rep(torch.as_tensor(bigint.batch_to_limbs(xs).astype(np.int64)).T)


def _ints(t: torch.Tensor) -> list[int]:
    a = t.numpy()
    return [bigint.from_limbs(a[:, i]) for i in range(a.shape[1])]


def _sm2_points(rng, n: int):
    """n on-curve affine points and random nonzero Z: (x, y, z) ints."""
    out = []
    for _ in range(n):
        P = refimpl.ec_mul(S, rng.randrange(1, S.n), (S.gx, S.gy))
        out.append((P[0], P[1], rng.randrange(1, S.p)))
    return out


def _jac(pts, cv):
    """affine (x, y) and z -> packed Jacobian field rep [3, 16, B] of
    (x z^2, y z^3, z), z = 0 giving (x, y, 0)."""
    p = cv.params.p
    X = [x * z * z % p if z else x for x, y, z in pts]
    Y = [y * z ** 3 % p if z else y for x, y, z in pts]
    return torch.stack([_rep(cv, X), _rep(cv, Y), _rep(cv, [z for _, _, z in pts])])


def _words_of(P: torch.Tensor) -> list[tuple[int, int, int]]:
    X, Y, Z = (_ints(P[i]) for i in range(3))
    return list(zip(X, Y, Z))


@pytest.mark.parametrize("op", ["double", "madd", "add"])
def test_sm2_point_ops_match_plain(harness, op):
    """jac_double / jac_madd / jac_add over Sm2Fp against ops/ec's
    jac_double / jac_add_affine / jac_add on the same field-rep words,
    every branch: the common path, P at infinity, Q at infinity, P == Q
    (doubling), P == -Q (infinity)."""
    cv = ec.SM2P256V1
    rng = random.Random(23)
    pts = _sm2_points(rng, 24)
    qs = _sm2_points(rng, 24)
    # edges: P = inf; P == Q (same affine point, other Z); P == -Q
    qs[0] = pts[0]
    qs[1] = (pts[1][0], pts[1][1], rng.randrange(1, S.p))
    qs[2] = (pts[2][0], S.p - pts[2][1], rng.randrange(1, S.p))
    pts[3] = (pts[3][0], pts[3][1], 0)
    qs[4] = (qs[4][0], qs[4][1], 0)
    P = _jac(pts, cv)
    if op == "double":
        want = ec.jac_double(cv, P)
        lines = [f"sm2dbl {_h(*w)}" for w in _words_of(P)]
    elif op == "madd":
        qs = [(x, y, 1) for x, y, _ in qs]
        qx, qy = _rep(cv, [q[0] for q in qs]), _rep(cv, [q[1] for q in qs])
        want = ec.jac_add_affine(cv, P, qx, qy)
        lines = [f"sm2madd {_h(*w)} {_h(x, y)}"
                 for w, x, y in zip(_words_of(P), _ints(qx), _ints(qy))]
    else:
        Q = _jac(qs, cv)
        want = ec.jac_add(cv, P, Q)
        lines = [f"sm2add {_h(*w)} {_h(*v)}" for w, v in zip(_words_of(P), _words_of(Q))]
    got = [tuple(g) for g in harness(lines)]
    assert got == _words_of(want)

