"""Batched secp256k1 ECDSA verify and recovery, and SM2 verify.

Counterpart of fisco_bcos_tpu/ops/ec.py for the port's two curves, on two
routes, as the JAX package has them:

* "fused" (the JAX package with FBTPU_FUSED_VERIFY=1 on a TPU): one
  whole-signature CUDA kernel per batch (`ops/cuda_verify.py`). Its plain
  version (`ecdsa_verify_plain`, `ecdsa_recover_plain`,
  `sm2_verify_plain`) is a line-for-line port of the JAX package's XLA
  path: Jacobian points complete by selection, a ladder over 4-bit window
  tables (secp256k1: the GLV split, 34 steps over G, phi(G), Q and phi(Q);
  SM2: the plain 64-step Shamir ladder over G and Q), per-lane Q tables
  batch-normalised to affine, product-tree inversions.
* "composed" (the JAX package's default on a TPU, without the flag): the
  same bodies over the curve's kernel-routed fields (`Curve.composed`),
  whose products and powers launch the standalone fp kernels
  (`ops/cuda_fp.py`), with the double-scalar multiply as one launch of the
  ladder kernel (`ops/cuda_ec.py`) on the JAX package's ladder operands
  (`ladder_inputs`): Jacobian Q tables, no normalisation. On CPU tensors
  the same bodies run the kernels' plain versions (`ladder_plain`).

`ecdsa_verify_batch` / `ecdsa_recover_batch` / `sm2_verify_batch` take the
JAX package's public boundary (`[B, 16]` 16-bit limbs) and a `route`, and
dispatch on where the tensors lie: a CUDA tensor goes to the kernels
(which raise if they cannot run), a CPU tensor to the plain versions.
Nothing falls back.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from . import fp
from .bigint import NLIMBS
from .fp import col, eq, geq, is_zero, select
from ..crypto import refimpl

WINDOW = 4
TBL = 1 << WINDOW  # 16 window entries (index 0 = skip)
NDIGITS = fp.BITS // WINDOW  # 64 steps of the plain Shamir ladder
GLV_DIGITS = 34  # 136-bit signed halves (worst observed magnitude: 129 bits)
ROUTES = ("fused", "composed")

__all__ = ["Curve", "SECP256K1", "SM2P256V1", "ROUTES", "ecdsa_verify_batch",
           "ecdsa_recover_batch", "sm2_verify_batch", "ecdsa_verify_plain",
           "ecdsa_recover_plain", "sm2_verify_plain", "ecdsa_verify_composed",
           "ecdsa_recover_composed", "sm2_verify_composed", "glv_shamir_mult",
           "shamir_mult", "ladder_inputs", "ladder", "ladder_plain", "LADDER_EDGES",
           "ladder_edge_lanes"]


class Curve:
    """Curve context: fields, constants and the G window table, derived
    from the `refimpl` copy; the GLV plane (phi(G) table, split constants)
    only where the curve has the endomorphism (secp256k1).

    `composed` is the same curve with kernel-routed siblings of its fields
    (the same moduli built with kernels=True): the composed route's bodies
    run on it, while the plain fields here keep the EC oracles plain."""

    def __init__(self, params: refimpl.CurveParams):
        self.params = params
        if (1 << fp.BITS) - params.p < 1 << 34:
            self.fp: fp._FieldBase = fp.SolinasField(params.p, params.name + ".p")
        else:  # SM2's p has no one-word fold: Montgomery domain
            self.fp = fp.MontField(params.p, params.name + ".p")
        self.fn = fp.MontField(params.n, params.name + ".n")
        self.a_is_zero = params.a % params.p == 0
        self.a_is_minus3 = params.a % params.p == params.p - 3
        if not (self.a_is_zero or self.a_is_minus3):
            raise ValueError("the point formulas cover a = 0 and a = -3 only")
        self.a_rep = self.fp.encode_int(params.a)
        self.b_rep = self.fp.encode_int(params.b)
        # affine window table for G: entry k = k*G, flattened [TBL, 2*16]
        tbl = np.zeros((TBL, 2 * NLIMBS), np.uint32)
        chain = []
        P = None
        for k in range(1, TBL):
            P = refimpl.ec_add(params, P, (params.gx, params.gy))
            chain.append(P)
            tbl[k, :NLIMBS] = self.fp.encode_int(P[0])
            tbl[k, NLIMBS:] = self.fp.encode_int(P[1])
        self.g_table = tbl
        # phi(x, y) = (beta x, y) exists only where a = 0 and p = 1 mod 3;
        # the GLV constants carried are secp256k1's and must match its G
        self.has_endo = self.a_is_zero and params.p % 3 == 1
        if self.has_endo:
            lG = refimpl.ec_mul(params, refimpl.GLV_LAMBDA, (params.gx, params.gy))
            assert lG == (refimpl.GLV_BETA * params.gx % params.p, params.gy), \
                "GLV (beta, lambda) pair inconsistent"
            self._glv_plane(chain)
        self._gts: dict = {}
        self.composed = copy.copy(self)
        kind = type(self.fp)
        self.composed.fp = kind(params.p, params.name + ".p", kernels=True)
        self.composed.fn = fp.MontField(params.n, params.name + ".n", kernels=True)

    def gts(self, device: torch.device) -> torch.Tensor:
        """The ladder's constant affine G tables, [n_pairs, TBL, 32] int64
        on `device`: G, and phi(G) where the curve has the endomorphism
        (pallas_ec.ladder's `gts`), copied there once per device."""
        t = self._gts.get(device)
        if t is None:
            tabs = [self.g_table] + ([self.g_table_endo] if self.has_endo else [])
            t = self._gts[device] = torch.as_tensor(
                np.stack(tabs).astype(np.int64), device=device)
        return t

    def _glv_plane(self, chain):
        params = self.params
        self.beta_rep = self.fp.encode_int(refimpl.GLV_BETA)
        self.glv_lambda = refimpl.GLV_LAMBDA
        tbl2 = np.zeros_like(self.g_table)
        for k, (px, py) in enumerate(chain, start=1):
            tbl2[k, :NLIMBS] = self.fp.encode_int(refimpl.GLV_BETA * px % params.p)
            tbl2[k, NLIMBS:] = self.fp.encode_int(py)
        self.g_table_endo = tbl2
        self.g1_limbs = fp.to_limbs(refimpl._GLV_G1)
        self.g2_limbs = fp.to_limbs(refimpl._GLV_G2)
        self.mb1_int = refimpl._GLV_MINUS_B1
        self.mb2_int = refimpl._GLV_MINUS_B2
        self.half_n_limbs = fp.to_limbs(params.n // 2)

    def __repr__(self):
        return f"Curve({self.params.name})"


SECP256K1 = Curve(refimpl.SECP256K1)
SM2P256V1 = Curve(refimpl.SM2P256V1)


# ---------------------------------------------------------------------------
# Jacobian point arithmetic (points packed as [3, 16, B], field rep)
# ---------------------------------------------------------------------------

def _pack(X, Y, Z):
    return torch.stack([X, Y, Z], dim=-3)


def _unpack(P):
    return P[..., 0, :, :], P[..., 1, :, :], P[..., 2, :, :]


def _sel(cond, a, b):
    """cond ? a : b over packed points (cond: [..., B])."""
    return torch.where(cond[..., None, None, :], a, b)


def jac_double(cv: Curve, P):
    """2P. Complete: Z = 0 (infinity) propagates as Z3 = 0."""
    f = cv.fp
    X, Y, Z = _unpack(P)
    two_y = f.add(Y, Y)
    if cv.a_is_zero:
        XX, YY = f.mul(X, X), f.mul(Y, Y)
        M = f.add(f.add(XX, XX), XX)  # 3 X^2
    else:  # a = -3: M = 3 (X - Z^2)(X + Z^2)
        YY, ZZ = f.mul(Y, Y), f.mul(Z, Z)
        T = f.mul(f.sub(X, ZZ), f.add(X, ZZ))
        M = f.add(f.add(T, T), T)
    XYY, YYYY, Z3 = f.mul(X, YY), f.mul(YY, YY), f.mul(two_y, Z)
    S = f.add(XYY, XYY)
    S = f.add(S, S)
    X3 = f.sub(f.mul(M, M), f.add(S, S))
    y8 = f.add(YYYY, YYYY)
    y8 = f.add(y8, y8)
    y8 = f.add(y8, y8)
    Y3 = f.sub(f.mul(M, f.sub(S, X3)), y8)
    return _pack(X3, Y3, Z3)


def jac_add(cv: Curve, P, Q):
    """P + Q, both Jacobian. Complete by selection (doubling/infinity)."""
    f = cv.fp
    X1, Y1, Z1 = _unpack(P)
    X2, Y2, Z2 = _unpack(Q)
    p_inf, q_inf = is_zero(Z1), is_zero(Z2)
    Z1Z1, Z2Z2 = f.mul(Z1, Z1), f.mul(Z2, Z2)
    U1, U2 = f.mul(X1, Z2Z2), f.mul(X2, Z1Z1)
    S1 = f.mul(f.mul(Y1, Z2), Z2Z2)
    S2 = f.mul(f.mul(Y2, Z1), Z1Z1)
    H, R = f.sub(U2, U1), f.sub(S2, S1)
    h0, r0 = is_zero(H), is_zero(R)
    HH, RR = f.mul(H, H), f.mul(R, R)
    HHH, V = f.mul(H, HH), f.mul(U1, HH)
    X3 = f.sub(f.sub(RR, HHH), f.add(V, V))
    Y3 = f.sub(f.mul(R, f.sub(V, X3)), f.mul(S1, HHH))
    Z3 = f.mul(f.mul(Z1, Z2), H)
    res = _pack(X3, Y3, Z3)
    res = _sel(h0 & r0, jac_double(cv, P), res)  # P == Q
    res = _sel(h0 & ~r0, torch.zeros_like(res), res)  # P == -Q
    res = _sel(q_inf, P, res)
    return _sel(p_inf, Q, res)


def jac_add_affine(cv: Curve, P, qx, qy):
    """P + (qx, qy) with the second operand affine (Z2 = 1): mixed add."""
    f = cv.fp
    X1, Y1, Z1 = _unpack(P)
    p_inf = is_zero(Z1)
    Z1Z1 = f.mul(Z1, Z1)
    U2 = f.mul(qx, Z1Z1)
    S2 = f.mul(f.mul(qy, Z1), Z1Z1)
    H, R = f.sub(U2, X1), f.sub(S2, Y1)
    h0, r0 = is_zero(H), is_zero(R)
    HH, RR = f.mul(H, H), f.mul(R, R)
    HHH, V, Z3 = f.mul(H, HH), f.mul(X1, HH), f.mul(Z1, H)
    X3 = f.sub(f.sub(RR, HHH), f.add(V, V))
    Y3 = f.sub(f.mul(R, f.sub(V, X3)), f.mul(Y1, HHH))
    res = _pack(X3, Y3, Z3)
    res = _sel(h0 & r0, jac_double(cv, P), res)
    res = _sel(h0 & ~r0, torch.zeros_like(res), res)
    one = f.one_rep(X1)
    lifted = _pack(qx.expand_as(one), qy.expand_as(one), one)
    return _sel(p_inf, lifted, res)


# ---------------------------------------------------------------------------
# GLV split and ladder
# ---------------------------------------------------------------------------

def _take_const(gt_flat, dig):
    """Constant table [TBL, 32] (numpy or a tensor) x digits [B] ->
    (x [16, B], y [16, B])."""
    if isinstance(gt_flat, np.ndarray):
        gt_flat = gt_flat.astype(np.int64)
    t = torch.as_tensor(gt_flat, device=dig.device)
    ge = t[dig].T  # [32, B]
    return ge[:NLIMBS], ge[NLIMBS:]


def _take_batch(tq, dig):
    """Per-lane table [TBL, C, 16, B] x digits [B] -> [C, 16, B]."""
    idx = dig[None, None, None, :].expand((1,) + tq.shape[1:])
    return torch.gather(tq, 0, idx)[0]


def _q_window_table(cv: Curve, qx_r, qy_r):
    """Per-lane Jacobian window table [TBL, 3, 16, B]: k*Q for k < 16 by
    14 complete adds of Q, entry 0 infinity (zeros), as
    fisco_bcos_tpu/ops/ec.py _q_window_table and the ladder kernel's
    in-kernel tables (pallas_ec.py:231-241) build it."""
    q1 = _pack(qx_r, qy_r, cv.fp.one_rep(qx_r))
    entries = [torch.zeros_like(q1), q1]
    for _ in range(TBL - 2):
        entries.append(jac_add(cv, entries[-1], q1))
    return torch.stack(entries, dim=0)


def _q_window_affine(cv: Curve, qx_r, qy_r):
    """Per-lane affine window table [TBL, 2, 16, B]: `_q_window_table`
    batch-normalised with one product-tree inversion over all TBL x B Z
    values. Entry 0 (infinity) normalises to zeros; a zero window digit
    never reads it."""
    f = cv.fp
    tq = _q_window_table(cv, qx_r, qy_r)
    X, Y, Z = tq[:, 0], tq[:, 1], tq[:, 2]  # each [TBL, 16, B]
    tbl_n, L, B = X.shape
    zf = Z.permute(1, 0, 2).reshape(L, tbl_n * B)
    w = zf.shape[-1]
    pad = (1 << (w - 1).bit_length()) - w
    if pad:
        zf = torch.cat([zf, f.one_rep(zf[:, :pad])], dim=-1)
    zi = f.inv_batch(zf)[..., :tbl_n * B]
    zi = zi.reshape(L, tbl_n, B).permute(1, 0, 2)
    zi2 = f.mul(zi, zi)
    ax, zi3 = f.mul(X, zi2), f.mul(zi2, zi)
    ay = f.mul(Y, zi3)
    return torch.stack([ax, ay], dim=1)


def _mul_shift_384(k, g_limbs):
    """floor(k * g / 2^384): one wide multiply and a limb slice."""
    exact, _ = fp.carry_prop(fp.mul_wide(k, col(g_limbs, k)), 2 * NLIMBS)
    return fp._pad(exact[..., 24:, :], 0, NLIMBS - 8)


def _glv_split_device(cv: Curve, k):
    """k [16, B] canonical mod n -> (m1, neg1, m2, neg2): signed halves
    with magnitudes < 2^136, k = +-m1 +- m2*lambda (mod n)."""
    fn_ = cv.fn
    c1 = _mul_shift_384(k, cv.g1_limbs)
    c2 = _mul_shift_384(k, cv.g2_limbs)
    mb1 = col(fn_.encode_int(cv.mb1_int), k)  # Montgomery-domain consts
    mb2 = col(fn_.encode_int(cv.mb2_int), k)
    lam = col(fn_.encode_int(cv.glv_lambda), k)
    k2 = fn_.from_rep(fn_.add(fn_.mul(fn_.to_rep(c1), mb1),
                              fn_.mul(fn_.to_rep(c2), mb2)))
    k1 = fn_.sub(fn_.reduce_loose(k),
                 fn_.from_rep(fn_.mul(fn_.to_rep(k2), lam)))
    half = col(cv.half_n_limbs, k)
    nl = col(fn_.limbs, k)

    def signed(x):
        neg_flag = ~geq(half.expand_as(x), x)  # x > n/2
        mag, _ = fp.sub_limbs(nl.expand_as(x), x)
        return select(neg_flag, mag, x), neg_flag

    m1, n1 = signed(k1)
    m2, n2 = signed(k2)
    return m1, n1, m2, n2


def _neg_y(f, Y, flag):
    return select(flag, f.neg(Y), Y)


def glv_digits(m):
    """Signed-half magnitude [16, B] -> [34, B] MSB-first 4-bit digits."""
    return fp.window_digits(m, WINDOW)[..., :GLV_DIGITS, :].flip(-2)


def glv_shamir_mult(cv: Curve, k1, k2, qx_r, qy_r):
    """k1*G + k2*Q via the endomorphism: 34 steps over four window tables
    (G, phi(G) constant; Q, phi(Q) per lane). -> packed Jacobian [3,16,B]."""
    f = cv.fp
    a1, s1, a2, s2 = _glv_split_device(cv, k1)
    b1, t1, b2, t2 = _glv_split_device(cv, k2)
    tq2 = _q_window_affine(cv, qx_r, qy_r)
    beta = col(cv.beta_rep, qx_r).expand_as(tq2[:, 0])
    tql2 = torch.stack([f.mul(tq2[:, 0], beta), tq2[:, 1]], dim=1)
    da1, da2, db1, db2 = (glv_digits(x) for x in (a1, a2, b1, b2))
    acc = torch.zeros((3, NLIMBS, k1.shape[-1]), dtype=k1.dtype,
                      device=k1.device)
    for step in range(GLV_DIGITS):
        for _ in range(WINDOW):
            acc = jac_double(cv, acc)
        d = da1[step]
        gx, gy = _take_const(cv.g_table, d)
        acc = _sel(d == 0, acc, jac_add_affine(cv, acc, gx, _neg_y(f, gy, s1)))
        d = da2[step]
        gx, gy = _take_const(cv.g_table_endo, d)
        acc = _sel(d == 0, acc, jac_add_affine(cv, acc, gx, _neg_y(f, gy, s2)))
        d = db1[step]
        qe = _take_batch(tq2, d)
        acc = _sel(d == 0, acc,
                   jac_add_affine(cv, acc, qe[0], _neg_y(f, qe[1], t1)))
        d = db2[step]
        qe = _take_batch(tql2, d)
        acc = _sel(d == 0, acc,
                   jac_add_affine(cv, acc, qe[0], _neg_y(f, qe[1], t2)))
    return acc


def shamir_mult(cv: Curve, k1, k2, qx_r, qy_r):
    """k1*G + k2*Q, the plain ladder (no endomorphism): 64 steps of four
    doublings and two mixed adds over 4-bit MSB-first windows of both
    scalars, against the constant G table and the per-lane affine Q
    table. k1, k2 plain canonical scalars [16, B]; Q affine in field rep.
    -> packed Jacobian [3, 16, B]."""
    tq2 = _q_window_affine(cv, qx_r, qy_r)
    d1 = fp.window_digits(k1, WINDOW).flip(-2)  # [64, B] MSB first
    d2 = fp.window_digits(k2, WINDOW).flip(-2)
    acc = torch.zeros((3, NLIMBS, k1.shape[-1]), dtype=k1.dtype,
                      device=k1.device)
    for step in range(NDIGITS):
        for _ in range(WINDOW):
            acc = jac_double(cv, acc)
        d = d1[step]
        gx, gy = _take_const(cv.g_table, d)
        acc = _sel(d == 0, acc, jac_add_affine(cv, acc, gx, gy))
        d = d2[step]
        qe = _take_batch(tq2, d)
        acc = _sel(d == 0, acc, jac_add_affine(cv, acc, qe[0], qe[1]))
    return acc


# ---------------------------------------------------------------------------
# the composed route's double-scalar multiply: one ladder on the JAX
# package's operands (fisco_bcos_tpu/ops/ec.py:319-330, 414-427)
# ---------------------------------------------------------------------------

def ladder_inputs(cv: Curve, k1, k2, qx_r, qy_r):
    """The ladder's operands for k1*G + k2*Q, built as the JAX package
    builds them for pallas_ec.ladder: -> (nsteps, gts, digs, negs,
    q_planes). With the endomorphism (secp256k1): both scalars split into
    signed halves, digit rows [g, q, g_endo, q_endo] of 34 MSB-first
    digits, their sign flags, q_planes (Q, (beta x, y)); else (SM2): rows
    [g, q] of 64 digits of the plain scalars, no flags, q_planes (Q,).
    k1, k2 canonical plain scalars [16, B]; Q affine in field rep. The
    products here are cv's (the kernel-routed ones on `cv.composed`)."""
    B = k1.shape[-1]
    gts = cv.gts(k1.device)
    if cv.has_endo:
        a1, s1, a2, s2 = _glv_split_device(cv, k1)
        b1, t1, b2, t2 = _glv_split_device(cv, k2)
        digs = torch.stack([glv_digits(m) for m in (a1, b1, a2, b2)])
        negs = torch.stack([s1, t1, s2, t2])
        qlx = cv.fp.mul(qx_r, col(cv.beta_rep, qx_r))
        q_planes = torch.stack([torch.stack([qx_r, qy_r]),
                                torch.stack([qlx, qy_r])])
        nsteps = GLV_DIGITS
    else:
        digs = torch.stack([fp.window_digits(k, WINDOW).flip(-2) for k in (k1, k2)])
        negs = torch.zeros((2, B), dtype=torch.int32, device=k1.device)
        q_planes = torch.stack([qx_r, qy_r])[None]
        nsteps = NDIGITS
    return nsteps, gts, digs.to(torch.int32), negs.to(torch.int32), q_planes


def ladder(cv: Curve, nsteps: int, gts, digs, negs, q_planes):
    """One double-scalar ladder: on CUDA tensors kernel H (ops/cuda_ec,
    which raises on what it does not take), on CPU tensors its plain
    version. -> packed Jacobian [3, 16, B]."""
    if q_planes.is_cuda:
        from . import cuda_ec

        return cuda_ec.ladder(cv, nsteps, gts.contiguous(), digs.contiguous(),
                              negs.contiguous(), q_planes.contiguous())
    return ladder_plain(cv, nsteps, gts, digs, negs, q_planes)


def ladder_plain(cv: Curve, nsteps: int, gts, digs, negs, q_planes):
    """Plain version of kernel H, line for line pallas_ec.ladder_values
    (fisco_bcos_tpu/ops/pallas_ec.py:213): per pair a Jacobian window
    table of Q; per step four doublings, then per pair the complete add of
    the G entry lifted to (x, +-y, 1) (zeros for digit 0) and of the Q
    entry with its y negated by its flag. Shapes as `ladder_inputs`
    returns them; -> packed Jacobian [3, 16, B]."""
    f = cv.fp
    n_pairs = gts.shape[0]
    one = f.one_rep(q_planes[0, 0])
    tables = [_q_window_table(cv, q_planes[p, 0], q_planes[p, 1])
              for p in range(n_pairs)]
    digs, flags = digs.long(), negs != 0
    acc = torch.zeros((3,) + tuple(one.shape), dtype=one.dtype, device=one.device)
    for r in range(nsteps):
        for _ in range(WINDOW):
            acc = jac_double(cv, acc)
        for p in range(n_pairs):
            dg = digs[2 * p, r]
            gx, gy = _take_const(gts[p], dg)
            lift = _pack(gx, _neg_y(f, gy, flags[2 * p]), one)
            lift = _sel(dg == 0, torch.zeros_like(lift), lift)
            acc = jac_add(cv, acc, lift)
            X, Y, Z = _unpack(_take_batch(tables[p], digs[2 * p + 1, r]))
            acc = jac_add(cv, acc, _pack(X, _neg_y(f, Y, flags[2 * p + 1]), Z))
    return acc


# The ladder's edge lanes, shared by the tests and chip_smoke.py: zero digit
# rows; the doubling and the cancellation in a Q add (Q = +-G, k1 = k2); a
# Q off the curve whose table holds Z = 0 entries with nonzero X and Y
# (y = 0 makes every doubling's Z zero); the doubling and the cancellation
# in the last step's G add (16 (G + Q) = +-G with k1 = 17, k2 = 16).
LADDER_EDGES = ("k1=0", "k2=0", "k1=k2=0", "Q=G, k1=k2", "Q=-G, k1=k2",
                "Q=(5, 0) off the curve", "Q=G, k1=k2=1",
                "16 (G + Q) = G, k1=17, k2=16", "16 (G + Q) = -G, k1=17, k2=16")


def ladder_edge_lanes(c: refimpl.CurveParams, k1, k2, qx, qy):
    """Lists of ladder operands (ints: scalars mod c.n, affine Q) with lane
    j < len(LADDER_EDGES) made LADDER_EDGES[j]; the other lanes, and the
    operands an edge leaves free, as given. -> new (k1, k2, qx, qy)."""
    k1, k2, qx, qy = list(k1), list(k2), list(qx), list(qy)
    inv16 = pow(16, -1, c.n)
    k1[0] = 0
    k2[1] = 0
    k1[2] = k2[2] = 0
    qx[3], qy[3], k2[3] = c.gx, c.gy, k1[3]
    qx[4], qy[4], k2[4] = c.gx, c.p - c.gy, k1[4]
    qx[5], qy[5] = 5, 0
    qx[6], qy[6], k1[6], k2[6] = c.gx, c.gy, 1, 1
    for j, sign in ((7, 1), (8, -1)):
        qx[j], qy[j] = refimpl.ec_mul(c, (sign * inv16 - 1) % c.n, (c.gx, c.gy))
        k1[j], k2[j] = 17, 16
    return k1, k2, qx, qy


def composed_mult(cv: Curve, k1, k2, qx_r, qy_r):
    """k1*G + k2*Q on the composed route: `ladder` on `ladder_inputs`."""
    return ladder(cv, *ladder_inputs(cv, k1, k2, qx_r, qy_r))


# ---------------------------------------------------------------------------
# verification / recovery bodies (lane-major [16, B] int64), each over a
# curve (plain or composed) and its double-scalar multiply
# ---------------------------------------------------------------------------

def _scalar_checks(fn, r, s):
    nl = col(fn.limbs, r)
    return (~is_zero(r)) & (~is_zero(s)) & (~geq(r, nl)) & (~geq(s, nl))


def _on_curve(cv: Curve, xr, yr):
    f = cv.fp
    rhs = f.add(f.mul(f.sqr(xr), xr), col(cv.b_rep, xr).expand_as(xr))
    if not cv.a_is_zero:
        rhs = f.add(rhs, f.mul(col(cv.a_rep, xr).expand_as(xr), xr))
    return eq(f.sqr(yr), rhs)


def _x_matches_mod_n(cv: Curve, X, Z, rscalar):
    """x(X:Z) == rscalar (mod n) without an inversion: X == cand * Z^2 for
    cand in {r, r + n} (the second only when r + n < p)."""
    f, fn_ = cv.fp, cv.fn
    zz = f.sqr(Z)
    m1 = eq(X, f.mul(f.to_rep(rscalar), zz))
    rpn, carry = fp.add_limbs(rscalar, col(fn_.limbs, rscalar))
    lt_p = (carry == 0) & (~geq(rpn, col(f.limbs, rpn)))
    cand2 = select(lt_p, rpn, torch.zeros_like(rpn))
    m2 = lt_p & eq(X, f.mul(f.to_rep(cand2), zz))
    return m1 | m2


def _verify_body(cv: Curve, mult, e, r, s, qx, qy):
    f, fn_ = cv.fp, cv.fn
    ok = _scalar_checks(fn_, r, s)
    pl = col(f.limbs, qx)
    ok &= (~geq(qx, pl)) & (~geq(qy, pl))
    qxr, qyr = f.to_rep(qx), f.to_rep(qy)
    ok &= _on_curve(cv, qxr, qyr)
    ok &= ~(is_zero(qx) & is_zero(qy))
    w = fn_.inv_batch(fn_.to_rep(s))
    u1 = fn_.from_rep(fn_.mul(fn_.to_rep(e), w))
    u2 = fn_.from_rep(fn_.mul(fn_.to_rep(r), w))
    X, _, Z = _unpack(mult(cv, u1, u2, qxr, qyr))
    ok &= ~is_zero(Z)
    ok &= _x_matches_mod_n(cv, X, Z, fn_.reduce_loose(r))
    return ok


def _recover_body(cv: Curve, mult, e, r, s, v):
    f, fn_ = cv.fp, cv.fn
    ok = _scalar_checks(fn_, r, s) & (v >= 0) & (v < 4)
    pl = col(f.limbs, r)
    hi_bit = ((v >> 1) & 1) == 1
    addend = select(hi_bit, col(fn_.limbs, r).expand_as(r),
                    torch.zeros_like(r))
    xr, carry = fp.add_limbs(r, addend)
    ok &= (carry == 0) & (~geq(xr, pl))
    xr = select(ok, xr, torch.zeros_like(xr))
    xm = f.to_rep(xr)
    ysq = f.add(f.mul(f.sqr(xm), xm), col(cv.b_rep, xm).expand_as(xm))
    y = f.pow_const(ysq, (cv.params.p + 1) // 4)  # sqrt, p = 3 mod 4
    ok &= eq(f.sqr(y), ysq)
    flip = (f.from_rep(y)[0] & 1) != (v & 1)
    ym = select(flip, f.neg(y), y)
    rinv = fn_.inv_batch(fn_.to_rep(r))
    u1 = fn_.from_rep(fn_.mul(fn_.neg(fn_.to_rep(e)), rinv))  # -e/r
    u2 = fn_.from_rep(fn_.mul(fn_.to_rep(s), rinv))  # s/r
    X, Y, Z = _unpack(mult(cv, u1, u2, xm, ym))
    ok &= ~is_zero(Z)
    zinv = f.inv_batch(Z)
    zi2 = f.sqr(zinv)
    qx = f.from_rep(f.mul(X, zi2))
    qy = f.from_rep(f.mul(Y, f.mul(zi2, zinv)))
    zero = torch.zeros_like(qx)
    return select(ok, qx, zero), select(ok, qy, zero), ok


def _sm2_verify_body(cv: Curve, mult, e, r, s, qx, qy):
    f, fn_ = cv.fp, cv.fn
    ok = _scalar_checks(fn_, r, s)
    pl = col(f.limbs, qx)
    ok &= (~geq(qx, pl)) & (~geq(qy, pl))
    qxr, qyr = f.to_rep(qx), f.to_rep(qy)
    ok &= _on_curve(cv, qxr, qyr)
    ok &= ~(is_zero(qx) & is_zero(qy))
    rc = fn_.reduce_loose(r)
    sc = fn_.reduce_loose(s)
    t = fn_.add(rc, sc)
    ok &= ~is_zero(t)
    X, _, Z = _unpack(mult(cv, sc, t, qxr, qyr))
    ok &= ~is_zero(Z)
    c = fn_.sub(rc, fn_.reduce_loose(e))  # the x1 that passes, mod n
    ok &= _x_matches_mod_n(cv, X, Z, c)
    return ok


def ecdsa_verify_plain(cv: Curve, e, r, s, qx, qy):
    """Plain batched verify on lane-major [16, B] int64 limbs -> bool[B]."""
    return _verify_body(cv, glv_shamir_mult, e, r, s, qx, qy)


def ecdsa_recover_plain(cv: Curve, e, r, s, v):
    """Plain batched recovery. e, r, s lane-major [16, B] int64, v [B]
    int64 -> (qx, qy [16, B], ok [B]); qx = qy = 0 where not ok."""
    return _recover_body(cv, glv_shamir_mult, e, r, s, v)


def sm2_verify_plain(cv: Curve, e, r, s, qx, qy):
    """Plain batched SM2 verify (GB/T 32918), R' = e + x(s*G + (r+s)*Q)
    == r (mod n), on lane-major [16, B] int64 limbs -> bool[B]."""
    return _sm2_verify_body(cv, shamir_mult, e, r, s, qx, qy)


def ecdsa_verify_composed(cv: Curve, e, r, s, qx, qy):
    """The composed route's verify (fisco_bcos_tpu/ops/ec.py:528 without
    FBTPU_FUSED_VERIFY): the plain body on cv.composed's fields, the
    multiply one ladder. Same arguments and result as ecdsa_verify_plain."""
    return _verify_body(cv.composed, composed_mult, e, r, s, qx, qy)


def ecdsa_recover_composed(cv: Curve, e, r, s, v):
    """The composed route's recovery (fisco_bcos_tpu/ops/ec.py:562): the
    plain body on cv.composed's fields (square root and inversion roots
    on the pow kernel), the multiply one ladder."""
    return _recover_body(cv.composed, composed_mult, e, r, s, v)


def sm2_verify_composed(cv: Curve, e, r, s, qx, qy):
    """The composed route's SM2 verify (fisco_bcos_tpu/ops/ec.py:617)."""
    return _sm2_verify_body(cv.composed, composed_mult, e, r, s, qx, qy)


# ---------------------------------------------------------------------------
# public entry points: [B, 16] limbs in, dispatch on the tensors' device
# ---------------------------------------------------------------------------

def _lane_major(a) -> torch.Tensor:
    a = torch.as_tensor(a)
    if a.dim() != 2 or a.shape[-1] != NLIMBS:
        raise ValueError(f"expected [B, {NLIMBS}] limbs, got {tuple(a.shape)}")
    return a.T


def _check_route(route: str) -> None:
    if route not in ROUTES:
        raise ValueError(f"unknown EC route {route!r}, expected one of {ROUTES}")


def ecdsa_verify_batch(cv: Curve, e, r, s, qx, qy, route: str = "fused") -> torch.Tensor:
    """Batched ECDSA verify. All args [B, 16] 16-bit limbs; -> bool[B].
    route "fused": kernel 2 on CUDA tensors; "composed": the fp, pow and
    ladder kernels (ecdsa_verify_composed). CPU tensors run the plain
    versions of either."""
    _check_route(route)
    if cv is not SECP256K1:
        raise ValueError("ECDSA runs on the secp256k1 singleton only")
    args = [_lane_major(a) for a in (e, r, s, qx, qy)]
    if route == "composed":
        return ecdsa_verify_composed(cv, *(a.to(torch.int64) for a in args))
    if args[0].is_cuda:
        from . import cuda_verify

        return cuda_verify.ecdsa_verify(*args).bool()
    return ecdsa_verify_plain(cv, *(a.to(torch.int64) for a in args))


def ecdsa_recover_batch(cv: Curve, e, r, s, v, route: str = "fused"):
    """Batched public-key recovery. e, r, s [B, 16], v [B] recovery id ->
    (qx, qy [B, 16] int64, ok bool[B]); zero keys where not ok. route as
    for ecdsa_verify_batch (kernel 1 or ecdsa_recover_composed)."""
    _check_route(route)
    if cv is not SECP256K1:
        raise ValueError("ECDSA runs on the secp256k1 singleton only")
    e, r, s = (_lane_major(a) for a in (e, r, s))
    v = torch.as_tensor(v)
    if route == "composed":
        qx, qy, ok = ecdsa_recover_composed(
            cv, *(a.to(torch.int64) for a in (e, r, s)), v.to(e.device, torch.int64))
        return qx.T, qy.T, ok
    if e.is_cuda:
        from . import cuda_verify

        qx, qy, ok = cuda_verify.ecdsa_recover(e, r, s, v)
        return qx.T.to(torch.int64), qy.T.to(torch.int64), ok.bool()
    qx, qy, ok = ecdsa_recover_plain(
        cv, *(a.to(torch.int64) for a in (e, r, s)), v.to(torch.int64))
    return qx.T, qy.T, ok


def sm2_verify_batch(cv: Curve, e, r, s, qx, qy, route: str = "fused") -> torch.Tensor:
    """Batched SM2 verify; e is the SM3(Z_A || M) digest as an integer.
    All args [B, 16] 16-bit limbs; -> bool[B]. route as for
    ecdsa_verify_batch (kernel C or sm2_verify_composed)."""
    _check_route(route)
    if cv is not SM2P256V1:
        raise ValueError("SM2 verify runs on the SM2P256V1 singleton only")
    args = [_lane_major(a) for a in (e, r, s, qx, qy)]
    if route == "composed":
        return sm2_verify_composed(cv, *(a.to(torch.int64) for a in args))
    if args[0].is_cuda:
        from . import cuda_verify

        return cuda_verify.sm2_verify(*args).bool()
    return sm2_verify_plain(cv, *(a.to(torch.int64) for a in args))
