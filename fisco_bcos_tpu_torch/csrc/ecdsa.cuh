// Per-signature bodies of the recover and verify kernels (verify.cu),
// following pallas_verify._recover_kernel_body :283 and
// _verify_kernel_body :160 of the JAX package step by step. No Fermat
// power inverts: r^-1 and s^-1 mod n, Z^-1 mod p and the Q table's inverse
// (ec.cuh `SecpFp::inv`) are modinv.cuh's safegcd inverses; the square
// root is ec.cuh's addition chain.
#pragma once
#include "ec.cuh"

__device__ bool recover_one(u32 qx[8], u32 qy[8], const u32 e[8], const u32 r[8],
                            const u32 s[8], u32 v, const u32 *sg) {
    zero8(qx);
    zero8(qy);
    if (is_zero8(r) || is_zero8(s) || geq8(r, FN_N) || geq8(s, FN_N) || v >= 4)
        return false;
    u32 x[8], t[8];
    set8(t, FN_N);
    if (!((v >> 1) & 1)) zero8(t);
    if (add8(x, r, t) || geq8(x, FP_P)) return false;  // x = r + (v>>1) n < p
    // r^-1 mod n, plain (it does not depend on the square root)
    W8 rw, yw;
    set8(rw.w, r);
    W8 rinv = modinv<ModN>(rw);
    u32 ysq[8];
    fp_sqr(ysq, x);
    fp_mul(ysq, ysq, x);
    set8(t, FP_B);
    fp_add(ysq, ysq, t);
    set8(yw.w, ysq);
    yw = fp_sqrt(yw);
    u32 *y = yw.w;
    fp_sqr(t, y);
    if (!eq8(t, ysq)) return false;
    if ((y[0] & 1u) != (v & 1u)) fp_neg(y, y);
    // u1 = -e / r, u2 = s / r (mod n); rinv to the Montgomery domain, r^-1 R
    u32 u1[8], u2[8];
    fn_mont_mul(rinv.w, rinv.w, FN_R2);
    fn_reduce(t, e);
    fn_neg(t, t);
    fn_mont_mul(u1, t, rinv.w);
    fn_mont_mul(u2, s, rinv.w);
    Jac acc;
    glv_ladder(acc, u1, u2, x, y, sg);
    if (is_zero8(acc.Z)) return false;
    W8 zw;
    set8(zw.w, acc.Z);
    zw = modinv<ModP>(zw);
    u32 zi2[8];
    fp_sqr(zi2, zw.w);
    fp_mul(qx, acc.X, zi2);
    fp_mul(zi2, zi2, zw.w);
    fp_mul(qy, acc.Y, zi2);
    return true;
}

__device__ bool verify_one(const u32 e[8], const u32 r[8], const u32 s[8],
                           const u32 qx[8], const u32 qy[8], const u32 *sg) {
    if (is_zero8(r) || is_zero8(s) || geq8(r, FN_N) || geq8(s, FN_N)
        || geq8(qx, FP_P) || geq8(qy, FP_P))
        return false;
    if (is_zero8(qx) && is_zero8(qy)) return false;
    u32 lhs[8], rhs[8], t[8];
    fp_sqr(rhs, qx);
    fp_mul(rhs, rhs, qx);
    set8(t, FP_B);
    fp_add(rhs, rhs, t);
    fp_sqr(lhs, qy);
    if (!eq8(lhs, rhs)) return false;  // not on the curve
    // w = s^-1 (Montgomery domain: s^-1 R); u1 = e w, u2 = r w (plain)
    u32 u1[8], u2[8];
    W8 w;
    set8(w.w, s);
    w = modinv<ModN>(w);
    fn_mont_mul(w.w, w.w, FN_R2);
    fn_reduce(t, e);
    fn_mont_mul(u1, t, w.w);
    fn_mont_mul(u2, r, w.w);
    Jac acc;
    glv_ladder(acc, u1, u2, qx, qy, sg);
    if (is_zero8(acc.Z)) return false;
    // x(R) == r (mod n) without an inversion: X == cand * Z^2 for
    // cand in {r, r + n}, the second only when r + n < p
    u32 zz[8], rpn[8];
    fp_sqr(zz, acc.Z);
    fp_mul(t, r, zz);
    if (eq8(acc.X, t)) return true;
    if (add8(rpn, r, FN_N) || geq8(rpn, FP_P)) return false;
    fp_mul(t, rpn, zz);
    return eq8(acc.X, t);
}
