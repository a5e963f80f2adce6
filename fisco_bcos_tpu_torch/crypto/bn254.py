"""alt_bn128 (BN254) optimal-ate pairing — the algebra behind precompile 8.

Reference counterpart: bcos-executor/src/vm/Precompiled.cpp:196-219
(`alt_bn128_pairing_product`, delegated to the WeDPR FFI natives). This is
an original from-first-principles implementation: tower arithmetic
Fp2 = Fp[u]/(u^2+1) and Fp12 = Fp2[w]/(w^6 - xi) with xi = 9 + u, the
sextic D-twist E': y^2 = x^3 + 3/xi carrying G2, affine Miller loop over
6x+2 with sparse line evaluations in the untwisted coordinates
(psi(x, y) = (x w^2, y w^3)), Frobenius-corrected per the optimal-ate
construction, and a product-of-Miller-loops with ONE shared final
exponentiation (f^((p^12-1)/r)) for the pairing-product check.

Perf: pure Python ints — the precompile path is correctness-first (its
EIP-1108 gas prices the call at 45k + 34k/pair; a check with a handful of
pairs completes in well under a second). Validated against the canonical
public go-ethereum bn256 vector corpus (tests/data_bn256_pairing.py) and
bilinearity identities (tests/test_precompile_classic.py).
"""

from __future__ import annotations

P = 21888242871839275222246405745257275088696311157297823662689037894645226208583
R = 21888242871839275222246405745257275088548364400416034343698204186575808495617
# BN curve parameter x; the optimal-ate Miller loop runs over 6x+2
BN_X = 4965661367192848881
ATE_LOOP = 6 * BN_X + 2

Fp2 = tuple  # (c0, c1) meaning c0 + c1*u, u^2 = -1

XI: Fp2 = (9, 1)  # the sextic twist constant xi = 9 + u


# -- Fp2 --------------------------------------------------------------------

def f2_add(a: Fp2, b: Fp2) -> Fp2:
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def f2_sub(a: Fp2, b: Fp2) -> Fp2:
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def f2_neg(a: Fp2) -> Fp2:
    return (-a[0] % P, -a[1] % P)


def f2_mul(a: Fp2, b: Fp2) -> Fp2:
    # (a0 + a1 u)(b0 + b1 u) = a0b0 - a1b1 + (a0b1 + a1b0) u
    t0 = a[0] * b[0]
    t1 = a[1] * b[1]
    return ((t0 - t1) % P, ((a[0] + a[1]) * (b[0] + b[1]) - t0 - t1) % P)


def f2_sqr(a: Fp2) -> Fp2:
    return f2_mul(a, a)


def f2_scalar(a: Fp2, k: int) -> Fp2:
    return (a[0] * k % P, a[1] * k % P)


def f2_inv(a: Fp2) -> Fp2:
    # 1/(c0 + c1 u) = (c0 - c1 u) / (c0^2 + c1^2)
    norm = (a[0] * a[0] + a[1] * a[1]) % P
    ni = pow(norm, P - 2, P)
    return (a[0] * ni % P, -a[1] * ni % P)


def f2_conj(a: Fp2) -> Fp2:
    return (a[0], -a[1] % P)


def f2_pow(a: Fp2, e: int) -> Fp2:
    acc: Fp2 = (1, 0)
    while e:
        if e & 1:
            acc = f2_mul(acc, a)
        a = f2_sqr(a)
        e >>= 1
    return acc


F2_ZERO: Fp2 = (0, 0)
F2_ONE: Fp2 = (1, 0)

# twist curve constant b' = 3 / xi
TWIST_B: Fp2 = f2_mul((3, 0), f2_inv(XI))

# Frobenius twist coefficients: pi(x, y) = (conj(x) * W2, conj(y) * W3)
# with W2 = xi^((p-1)/3), W3 = xi^((p-1)/2)
FROB_W2: Fp2 = f2_pow(XI, (P - 1) // 3)
FROB_W3: Fp2 = f2_pow(XI, (P - 1) // 2)


# -- Fp12 = Fp2[w] / (w^6 - xi) ---------------------------------------------
# elements are 6-tuples of Fp2 coefficients (c_0 .. c_5) of powers of w

F12_ONE = (F2_ONE, F2_ZERO, F2_ZERO, F2_ZERO, F2_ZERO, F2_ZERO)


def f12_mul(a, b):
    # schoolbook over Fp2 with the w^6 = xi reduction
    t = [F2_ZERO] * 11
    for i in range(6):
        ai = a[i]
        if ai == F2_ZERO:
            continue
        for j in range(6):
            if b[j] == F2_ZERO:
                continue
            t[i + j] = f2_add(t[i + j], f2_mul(ai, b[j]))
    out = list(t[:6])
    for k in range(6, 11):
        if t[k] != F2_ZERO:
            out[k - 6] = f2_add(out[k - 6], f2_mul(t[k], XI))
    return tuple(out)


def f12_sqr(a):
    return f12_mul(a, a)


def f12_pow(a, e: int):
    acc = F12_ONE
    while e:
        if e & 1:
            acc = f12_mul(acc, a)
        a = f12_sqr(a)
        e >>= 1
    return acc


# -- curve points ------------------------------------------------------------
# G1: affine (x, y) ints, None = infinity, on y^2 = x^3 + 3
# G2: affine (x, y) Fp2 pairs on the twist, None = infinity


def g1_on_curve(pt) -> bool:
    if pt is None:
        return True
    x, y = pt
    return (y * y - x * x * x - 3) % P == 0


def g2_on_curve(q) -> bool:
    if q is None:
        return True
    x, y = q
    rhs = f2_add(f2_mul(f2_sqr(x), x), TWIST_B)
    return f2_sqr(y) == rhs


def g2_add(a, b):
    if a is None:
        return b
    if b is None:
        return a
    x1, y1 = a
    x2, y2 = b
    if x1 == x2:
        if f2_add(y1, y2) == F2_ZERO:
            return None
        lam = f2_mul(f2_scalar(f2_sqr(x1), 3), f2_inv(f2_scalar(y1, 2)))
    else:
        lam = f2_mul(f2_sub(y2, y1), f2_inv(f2_sub(x2, x1)))
    x3 = f2_sub(f2_sub(f2_sqr(lam), x1), x2)
    y3 = f2_sub(f2_mul(lam, f2_sub(x1, x3)), y1)
    return (x3, y3)


def g2_mul(q, k: int):
    acc = None
    add = q
    while k:
        if k & 1:
            acc = g2_add(acc, add)
        add = g2_add(add, add)
        k >>= 1
    return acc


def g2_in_subgroup(q) -> bool:
    """EIP-197 requires G2 inputs in the r-torsion (the twist has extra
    cofactor points that would make the pairing ill-defined)."""
    return g2_on_curve(q) and g2_mul(q, R) is None


def g2_frobenius(q):
    """The p-power Frobenius endomorphism carried to twist coordinates."""
    if q is None:
        return None
    x, y = q
    return (f2_mul(f2_conj(x), FROB_W2), f2_mul(f2_conj(y), FROB_W3))


def g2_neg(q):
    if q is None:
        return None
    return (q[0], f2_neg(q[1]))


# -- Miller loop -------------------------------------------------------------

def _line(T, Q2, P1):
    """Sparse Fp12 evaluation at P1 = (xp, yp) of the line through the
    UNTWISTED images of T (and Q2, or the tangent when T is Q2).

    With psi(x, y) = (x w^2, y w^3) the chord/tangent slope becomes
    lambda * w for the twist slope lambda, and the line value collapses to
        -yp  +  (lambda xp) w  +  (y_T - lambda x_T) w^3
    — three non-zero coefficients out of six."""
    x1, y1 = T
    if Q2 is None or T == Q2:  # tangent
        lam = f2_mul(f2_scalar(f2_sqr(x1), 3), f2_inv(f2_scalar(y1, 2)))
    else:
        x2, y2 = Q2
        if x1 == x2:  # vertical: l = xp - x_T (as w^2 coefficient)
            xp, _yp = P1
            return ((xp % P, 0), F2_ZERO, f2_neg(x1), F2_ZERO, F2_ZERO,
                    F2_ZERO)
        lam = f2_mul(f2_sub(y2, y1), f2_inv(f2_sub(x2, x1)))
    xp, yp = P1
    c0 = (-yp % P, 0)
    c1 = f2_scalar(lam, xp)
    c3 = f2_sub(y1, f2_mul(lam, x1))
    return (c0, c1, F2_ZERO, c3, F2_ZERO, F2_ZERO)


def miller_loop(P1, Q):
    """f_{6x+2, Q}(P1) with the two optimal-ate Frobenius line corrections.
    P1 is an affine G1 point, Q an affine twist point; neither infinity."""
    f = F12_ONE
    T = Q
    for i in range(ATE_LOOP.bit_length() - 2, -1, -1):
        f = f12_mul(f12_sqr(f), _line(T, None, P1))
        T = g2_add(T, T)
        if (ATE_LOOP >> i) & 1:
            f = f12_mul(f, _line(T, Q, P1))
            T = g2_add(T, Q)
    q1 = g2_frobenius(Q)
    q2 = g2_neg(g2_frobenius(q1))
    f = f12_mul(f, _line(T, q1, P1))
    T = g2_add(T, q1)
    f = f12_mul(f, _line(T, q2, P1))
    return f


_FINAL_EXP = (P ** 12 - 1) // R


def pairing_check(pairs) -> bool:
    """prod e(P_i, Q_i) == 1 — one shared final exponentiation over the
    product of Miller loops. `pairs` is [(g1_pt, g2_pt)], infinities
    allowed (their factor is 1)."""
    f = F12_ONE
    for p1, q in pairs:
        if p1 is None or q is None:
            continue
        f = f12_mul(f, miller_loop(p1, q))
    return f12_pow(f, _FINAL_EXP) == F12_ONE
